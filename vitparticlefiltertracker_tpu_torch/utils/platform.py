"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A caller
that asks for CUDA on a machine without it gets an error, never a silent
CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the torch.device to run on; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch paths"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (expected 'cuda' or 'cpu')")
    return dev


H100_SMS = 132  # what the launch plans assume where no card is asked
_SM_COUNT: dict[int, int] = {}  # device index -> SMs, read once


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, read once a process
    (the kernels' launch plans size their grids by it on every launch)."""
    sms = _SM_COUNT.get(device.index)
    if sms is None:
        sms = _SM_COUNT[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms
