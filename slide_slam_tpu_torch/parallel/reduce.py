"""The sums over shards that stand in for the JAX package's `psum` over a
mesh axis: a solve's `reduce` callable (factorgraph/solver.py,
factorgraph/schur.py) takes one shard's part and returns the sum over all
shards, the same tensor on every shard.

Two forms:
* `run_in_lockstep`: n shards in one process (on one card), each solved in
  a thread of its own; the sum is taken over a leading shard axis (the
  parts stacked in shard order), by every shard alike, so the replicated
  solver state stays identical and every shard takes the same branches;
* `all_reduce_sum`: one shard per process of a torch.distributed group
  (gloo on CPU processes, NCCL where there are cards).
"""
from __future__ import annotations

import threading
from typing import Callable, List

import torch


class LockstepSum:
    """Sum over `n` shards that run in lockstep in n threads."""

    def __init__(self, n: int):
        self.n = n
        self._parts: List = [None] * n
        self._barrier = threading.Barrier(n)

    def __call__(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        self._parts[shard] = x
        self._barrier.wait()
        total = torch.stack(self._parts).sum(dim=0)
        self._barrier.wait()            # every shard has read every part
        return total

    def abort(self):
        self._barrier.abort()


def run_in_lockstep(fn: Callable, n: int) -> list:
    """[fn(shard, reduce) for shard in range(n)], run in n threads in
    lockstep, where reduce(x) sums x over the shards. A shard that raises
    breaks the others' wait; the first error is raised here."""
    total = LockstepSum(n)
    out, errors = [None] * n, []

    def work(shard):
        try:
            out[shard] = fn(shard, lambda x: total(shard, x))
        except BaseException as e:                  # noqa: BLE001
            errors.append(e)
            total.abort()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return out


def all_reduce_sum(group=None) -> Callable:
    """reduce(x): the sum of x over the processes of a torch.distributed
    group (every process gets the same tensor). Each all_reduce adds one to
    `all_reduce_sum.calls` and the tensor's bytes to `.bytes`."""
    import torch.distributed as dist

    def reduce(x: torch.Tensor) -> torch.Tensor:
        y = x.reshape(-1).clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        all_reduce_sum.calls += 1
        all_reduce_sum.bytes += y.numel() * y.element_size()
        return y.reshape(x.shape)
    return reduce


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0
