"""Device selection shared by the package's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card (``"cuda"``).  Without a usable card that
    is an error, never a silent move to the CPU: pass ``device="cpu"``
    to run the plain PyTorch versions instead of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path instead of the CUDA kernels")
    return dev
