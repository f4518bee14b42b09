"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the faces in :mod:`.ops`.  Nothing is built at import time."""
