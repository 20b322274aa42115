"""Three-phase wall-clock timers (counterpart: tdc_tpu/utils/timing.py).

Reference schema (scripts/distribuitedClustering.py): setup_time,
initialization_time, computation_time. CUDA kernels launch
asynchronously, so every phase boundary synchronises on the device of the
tensors produced in that phase before reading the host clock.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def hard_sync(target) -> None:
    """Block until the work producing `target` is done: one
    `torch.cuda.synchronize()` per CUDA device among the tensors in
    `target` (a tensor, or a tuple/list/dict of them). CPU tensors are
    already computed when the call returns."""
    devices = set()
    stack = [target]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                devices.add(t.device)
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (tuple, list)):
            stack.extend(t)
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimers:
    """Accumulating named phase timers.

    with timers.phase("computation", block_on=result): ...
    """

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            target = out.get("block_on", block_on)
            if target is not None:
                hard_sync(target)
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def get(self, name: str) -> float:
        return self.seconds.get(name, 0.0)

    def set(self, name: str, seconds: float) -> None:
        self.seconds[name] = float(seconds)

    def as_dict(self) -> dict[str, float]:
        return dict(self.seconds)
