"""CUDA graphs over pure functions of tensors: captured once per key,
replayed after.

    outs = cuda_graphs.replay("ls_graph", key, fn, inputs)

runs `fn(inputs) -> outputs` (lists of CUDA tensors) as one CUDA graph:
the first call with a `key` copies the inputs into buffers of the graph's
own, runs `fn` once eagerly on a side stream (lazy initialisation such as
cuBLAS's workspace stays outside the capture), captures it, and replays it;
later calls with that key copy the inputs in, replay, and copy the outputs
out. The graph runs the same kernels in the same order as `fn` run eagerly,
so its outputs equal the eager ones bit for bit; only the host's dispatch
changes, from one launch a kernel to one a graph.

`fn` must be capturable: no host read (`.item()`, `bool(t)`, indexing by a
0-d tensor), no tensor made from host data, no data-dependent shape, and
everything it reads passed in `inputs` (Python numbers it closes over are
baked into the graph, so they belong in the key). The key must hold every
shape and dtype of `inputs`; `replay` adds the device and the float32
matmul settings, which decide the kernels captured.

Every returned tensor is fresh memory, never a graph-owned buffer: a later
replay rewrites nothing a caller holds. An output that is one of `fn`'s
inputs, unchanged, comes back as the caller's own tensor, as it would
eagerly. The cache is process-wide; one lock serialises capture and the
copy-in, replay, copy-out sequence, so threads may share a card (a graph's
buffers are reused only after the last user's copy-out on its stream).
Each capture adds to the phase total `<name>_capture`
(`profiling.phase_counts()`).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List

import torch

from .profiling import phase

_GRAPHS: Dict = {}
_LOCK = threading.Lock()


class _Graph:
    __slots__ = ("graph", "static_in", "static_out", "passthrough", "done")


def _copy(dst: List[torch.Tensor], src: List[torch.Tensor]):
    """dst[i] <- src[i], contiguous pairs in one foreach launch a dtype."""
    groups: Dict = {}
    for d, s in zip(dst, src):
        if d.is_contiguous() and s.is_contiguous():
            g = groups.setdefault(d.dtype, ([], []))
            g[0].append(d)
            g[1].append(s)
        else:
            d.copy_(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def _capture(fn, inputs, stream) -> _Graph:
    e = _Graph()
    e.static_in = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                   for t in inputs]
    _copy(e.static_in, inputs)
    side = torch.cuda.Stream(stream.device)
    side.wait_stream(stream)
    # capture_begin/end, not `with torch.cuda.graph(...)`: that context also
    # synchronises the device and empties the allocator's caches (in some
    # versions it collects garbage too), which a graph of small kernels
    # does not need and other threads on the card would wait for
    e.graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn(e.static_in)
        e.graph.capture_begin(capture_error_mode="thread_local")
        try:
            outs = fn(e.static_in)
        finally:
            e.graph.capture_end()
    stream.wait_stream(side)
    same = {id(t): i for i, t in enumerate(e.static_in)}
    owned = {t.untyped_storage().data_ptr() for t in e.static_in
             if t.numel()}
    e.passthrough, e.static_out = [], []
    for o in outs:
        i = same.get(id(o))
        if i is None and o.numel() and \
                o.untyped_storage().data_ptr() in owned:
            raise ValueError("a graphed function may return its inputs "
                             "unchanged, not views of them")
        e.passthrough.append(i)
        if i is None:
            e.static_out.append(o)
    e.done = torch.cuda.Event()
    return e


def replay(name: str, key, fn: Callable[[List[torch.Tensor]],
                                         List[torch.Tensor]],
           inputs: List[torch.Tensor]) -> List[torch.Tensor]:
    """`fn(inputs)` through the CUDA graph cached under `key` (see above)."""
    dev = inputs[0].device
    key = (key, dev, torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    stream = torch.cuda.current_stream(dev)
    with _LOCK:
        e = _GRAPHS.get(key)
        if e is None:
            with phase(name + "_capture"):
                e = _GRAPHS[key] = _capture(fn, inputs, stream)
        else:
            stream.wait_event(e.done)
            _copy(e.static_in, inputs)
        e.graph.replay()
        fresh = [torch.empty_strided(o.shape, o.stride(), dtype=o.dtype,
                                     device=o.device) for o in e.static_out]
        _copy(fresh, e.static_out)
        e.done.record(stream)
    it = iter(fresh)
    return [next(it) if i is None else inputs[i] for i in e.passthrough]
