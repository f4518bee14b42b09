"""Device selection shared by every entry point of the port.

Entry points run on the card by default.  The CPU is used only when the
caller asks for it (``device="cpu"``, as the tests do); a missing card is an
error, never a quiet fall-back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index
    gets the current one, so it compares equal to the device of the
    tensors made on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
