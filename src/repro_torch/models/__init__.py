"""Language models of the port (``repro/models``), built from plain PyTorch
ops around the hand-written kernels of :mod:`repro_torch.kernels`."""
