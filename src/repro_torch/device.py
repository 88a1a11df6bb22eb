"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card present and none asked for they raise, never falling back
to the CPU. Resolving a device also pins f32 matrix products to full
f32 (no TF32): TF32 keeps ~3 decimal digits and breaks argmin parity
with the reference.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if the resolved device is a CUDA
    device and no card is present."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def host_input(x, device=None) -> torch.Tensor:
    """A tensor stays where it lies (the caller chose its device); host
    data (a numpy array, a list) goes to ``resolve(device)``, the card
    unless the caller asks for the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x).to(resolve(device)).contiguous()


def as_tensor(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a contiguous tensor on ``dev``."""
    return torch.as_tensor(x, dtype=dtype).to(dev).contiguous()
