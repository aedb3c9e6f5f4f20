"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.
With no card and no explicit request they raise: nothing falls back to
the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` and ``"cuda"`` mean the card (raises when there is none);
    ``"cpu"`` is the CPU, used by the tests and their plain kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' (or --device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
