"""The port's tracer: per-name phase totals, and keyed spans while tracing.

Every call site uses one context manager, `phase`; a blocking
device->host read goes through `host_read` (a flag) or `to_host` (an
array):

    with phase("kf", key=(robot_id, stamp)):   # a keyframe's root span
        with phase("solve.pcg"):                # children inherit the key
            with host_read("pcg_stop"):
                stop = not bool(flag)
        chain = to_host(poses, "pose_fetch")

It keeps two records.

- **Per-name totals**, always: milliseconds and calls per phase name
  (`phase_report`, `phase_counts`, read by chip_smoke.py), as the mission
  phases always had them, on unsynchronised host clocks (two perf_counter
  calls a phase). The spans of the keyframe's and the scan's hierarchy
  (`kf`, `scan` and dotted names in the families `SPAN_FAMILIES`) add to
  no total, so the totals keep their keys.
- **Spans**, only while tracing is on: name, key, parent, start and end in
  `time.perf_counter_ns`, and attributes. Tracing is on while a
  `torch.profiler` session records on the calling thread, or between
  `enable()` and `disable()`. Off, a span costs one flag check besides
  its total's two perf_counter calls, where it has a total. A span's
  parent is the innermost span open on the same thread; a root takes the
  key it is given (a keyframe's robot id and stamp), a child its parent's.
  Up to CAPACITY closed spans are kept in memory; the rest are dropped
  and counted. `spans()` exports them as plain dicts, `reset()` clears
  them.

Counters are span attributes: `host_reads` (1 on each `sync.<site>` span
that `host_read` or `to_host` opens), `pcg_iters` (solver.pcg's device
iteration counter, kept as a tensor and read back only by `spans()`: no
launch and no sync while the program runs) and `full_solve` on `kf`.
The team's spans (families `closure`, `mission`, `comm`) carry theirs:
`closure.search` (a search on its worker thread) `kind`, `peers`, `found`
and `clipper_iters` (CLIPPER's ascent iterations, a device tensor like
`pcg_iters`, added by `count` while tracing); `closure.apply` `kind` and
`merged`; `mission.replay` `poses_replayed` and `first_fold`;
`comm.exchange` `bundle_bytes`. `closure.wait` and `closure.polish`
carry none but their key.

The tracer never opens a `torch.profiler.record_function` range: the
profiler would put it on the CUDA timeline beside the kernels, where the
benchmark's trace readers count every device event as a kernel.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

_ACC: Dict[str, float] = defaultdict(float)
_CNT: Dict[str, int] = defaultdict(int)

SPAN_FAMILIES = frozenset(("kf", "scan", "step", "solve", "pcg", "sync",
                           "closure", "mission", "comm"))
CAPACITY = 65536

_explicit = False
_lock = threading.Lock()
_local = threading.local()
_closed: list = []
_dropped = 0
_next_id = 0


def enable():
    """Record spans until disable(), profiler or not."""
    global _explicit
    _explicit = True


def disable():
    global _explicit
    _explicit = False


def tracing() -> bool:
    """Whether spans are recorded on this thread now."""
    return _explicit or torch.autograd._profiler_enabled()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("id", "parent", "name", "key", "thread", "start", "end",
                 "attrs")


class phase:
    """`with phase(name, key=None, **attrs):` adds the block's host time to
    name's total and, while tracing, records it as a span (see above)."""

    __slots__ = ("name", "key", "attrs", "total", "t0", "span")

    def __init__(self, name: str, key=None, **attrs):
        self.name, self.key, self.attrs = name, key, attrs

    def __enter__(self):
        self.span = _open(self.name, self.key, self.attrs) if tracing() \
            else None
        self.total = self.name.split(".", 1)[0] not in SPAN_FAMILIES
        if self.total:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.total:
            _ACC[self.name] += time.perf_counter() - self.t0
            _CNT[self.name] += 1
        if self.span is not None:
            _close(self.span)
        return False

    def set(self, **attrs):
        """Set attributes on this block's own span, if it is recorded."""
        if self.span is not None:
            self.span.attrs.update(attrs)


def host_read(site: str) -> phase:
    """The span of one blocking device->host read at `site`:
    `with host_read("accept"): flag = bool(t)`."""
    return phase("sync." + site, host_reads=1)


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """`t.cpu().numpy()`, as one read at `site`."""
    with host_read(site):
        return t.cpu().numpy()


def annotate(**attrs):
    """Set attributes on this thread's innermost open span, if tracing."""
    st = getattr(_local, "stack", None)
    if st:
        st[-1].attrs.update(attrs)


def count(**counts):
    """Add to counters on this thread's innermost open span, if tracing; a
    tensor stays on its device until spans() reads it."""
    st = getattr(_local, "stack", None)
    if st:
        a = st[-1].attrs
        for k, v in counts.items():
            a[k] = a[k] + v if k in a else v


def _open(name, key, attrs) -> _Span:
    global _next_id
    st = _stack()
    s = _Span()
    with _lock:
        s.id = _next_id
        _next_id += 1
    parent = st[-1] if st else None
    s.parent = parent.id if parent is not None else None
    s.key = key if key is not None or parent is None else parent.key
    s.name, s.attrs = name, dict(attrs)
    s.thread = threading.get_ident()
    s.end = None
    st.append(s)
    s.start = time.perf_counter_ns()
    return s


def _close(s: _Span):
    global _dropped
    s.end = time.perf_counter_ns()
    _local.stack.pop()      # `with` blocks close innermost first
    with _lock:
        if len(_closed) < CAPACITY:
            _closed.append(s)
        else:
            _dropped += 1


def spans() -> Dict:
    """{"spans": [dict per closed span, in closing order], "dropped": n}.
    Tensor attributes (pcg_iters) are read back here, in one transfer a
    device."""
    with _lock:
        recs = list(_closed)
        dropped = _dropped
    out = [dict(id=s.id, parent=s.parent, name=s.name, key=s.key,
                thread=s.thread, start_ns=s.start, end_ns=s.end,
                attrs=dict(s.attrs)) for s in recs]
    by_dev = defaultdict(list)
    for d in out:
        for k, v in d["attrs"].items():
            if isinstance(v, torch.Tensor):
                by_dev[v.device].append((d["attrs"], k, v))
    for items in by_dev.values():
        vals = torch.stack([v.reshape(()).to(torch.float64)
                            for _, _, v in items]).cpu().tolist()
        for (attrs, k, v), x in zip(items, vals):
            attrs[k] = x if v.is_floating_point() else int(x)
    return {"spans": out, "dropped": dropped}


def reset():
    """Forget the closed spans and the dropped count."""
    global _dropped
    with _lock:
        _closed.clear()
        _dropped = 0


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
