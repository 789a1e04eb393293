"""Device resolution for every entry point of the port.

``resolve_device(None)`` means the card: it returns ``cuda`` when PyTorch
sees one and raises otherwise.  There is no quiet fall back to the CPU; a
caller that wants the CPU (the tests do) passes ``device="cpu"``.

Every resolution also pins float32 matrix products to full precision:
``torch.set_float32_matmul_precision("highest")`` and TF32 off for both
cuBLAS and cuDNN.  TF32 keeps about three decimal digits, which would move
the sketch, leader and final-prune products away from the reference.
"""
from __future__ import annotations

import torch


def _pin_f32_precision() -> None:
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` resolves to ``cuda`` and raises ``RuntimeError`` when no card
    is present; anything else is taken as given (``"cpu"``, ``"cuda:1"``).
    """
    _pin_f32_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on an NVIDIA card by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
