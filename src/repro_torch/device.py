"""Device placement for the port.

Entry points run on the card: ``device=None`` means ``cuda:0``.  A caller
that wants the host passes ``device="cpu"`` explicitly (the CPU tests do);
without CUDA, ``None`` or a ``cuda`` device raises instead of quietly
running on the CPU.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "accel_devices", "to_device", "synchronize"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cuda"`` -> ``cuda:<current>``; ``"cpu"``
    stays the host.  Raises ``RuntimeError`` when CUDA is asked for (by
    default or by name) and absent."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def accel_devices(base: torch.device, n_accel: int) -> List[torch.device]:
    """Devices of logical accelerators 0..n-1: ordinal i lands on
    ``cuda:(base + i) % device_count`` (with one card they all share it).
    On the host every logical accelerator is the CPU."""
    if base.type == "cpu":
        return [base] * n_accel
    count = torch.cuda.device_count()
    return [torch.device("cuda", (base.index + i) % count)
            for i in range(n_accel)]


def to_device(x: Union[np.ndarray, torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """Host array/tensor -> ``device``.  CUDA copies go through a pinned
    staging buffer and are issued ``non_blocking`` on the current stream;
    on the host the tensor shares the numpy buffer."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    if device.type == "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the work this thread queued on ``device``'s current stream
    (no-op on the host) — the port's counterpart of ``block_until_ready``.
    Work other threads queued on other streams is not waited for."""
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
