"""Host-side phase accounting for the mission runner (PyTorch twin of
slide_slam_tpu/runtime/profiling.py).

One process drives all robots, so phases accumulate in a process-global
table:

    from .profiling import phase, phase_report, phase_reset
    with phase("replay_pack"):
        ...

Overhead is two perf_counter calls per enter/exit.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

_ACC: Dict[str, float] = defaultdict(float)
_CNT: Dict[str, int] = defaultdict(int)

# When set, maybe_block() synchronizes the card inside phases so host wall
# time is attributed to the phase that queued the device work instead of the
# next blocking fetch. Diagnostic only: it defeats pipelining.
SYNC = bool(int(os.environ.get("SLIDE_SLAM_PROFILE_SYNC", "0")))


def maybe_block(t: torch.Tensor) -> torch.Tensor:
    """Synchronize t's device when SYNC profiling is on and t is on a card."""
    if SYNC and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACC[name] += time.perf_counter() - t0
        _CNT[name] += 1


def phase_add(name: str, seconds: float):
    _ACC[name] += seconds
    _CNT[name] += 1


def phase_reset():
    _ACC.clear()
    _CNT.clear()


def phase_report() -> Dict[str, float]:
    """Total milliseconds per phase (sorted descending)."""
    return {k: round(v * 1000.0, 1)
            for k, v in sorted(_ACC.items(), key=lambda kv: -kv[1])}


def phase_counts() -> Dict[str, int]:
    return dict(_CNT)
