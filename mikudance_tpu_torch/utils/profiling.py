"""Phase timing for the sampling pipeline."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class Timer:
    """Wall time per named phase. ``mark(name)`` synchronises the device
    (so the phase's queued kernels are inside it), then charges the time since
    the previous mark to ``name``."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.phases: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - self._t0
        self._t0 = now

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
