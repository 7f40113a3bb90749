"""Multi-process execution (PyTorch twin of
slide_slam_tpu/parallel/multiprocess.py).

The JAX package joins N host processes to one global device mesh with
jax.distributed.initialize, and the same SPMD programs run over it. Here the
mesh becomes a torch.distributed process group and a rank -> robots map:
each process holds the replicas of a contiguous block of robots, and the
team step's all_gathers of keyframe packets and TF tables ride the group
(gloo between CPU processes, NCCL between cards, one process per card).
Nothing tells a process of a cluster: `ProcessSpec` names the rendezvous
address, the world size and the rank, and `launch` starts a group of fresh
processes on this host. Without a process group the mesh is this one
process.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional

import torch

# a collective that waits longer than this fails (NCCL's default is 10 min)
COLLECTIVE_TIMEOUT_S = 120.0


@dataclasses.dataclass
class ProcessSpec:
    init_method: str                  # "tcp://localhost:<port>" of rank 0
    world_size: int
    rank: int
    backend: Optional[str] = None     # default: nccl with cards, else gloo
    device: str = "cuda"              # where this process's tensors live
    timeout_s: float = COLLECTIVE_TIMEOUT_S


def initialize(spec: ProcessSpec):
    """Join the process group; returns torch.distributed. With cards, the
    rank binds its card before the group forms (card k mod the card count
    for device "cuda", else the card named) and makes it current; NCCL
    forms its communicator on it at once. A collective that waits longer
    than spec.timeout_s fails, so a dead rank ends the others' waits."""
    import torch.distributed as dist
    cuda = spec.device.startswith("cuda")
    backend = spec.backend or ("nccl" if cuda else "gloo")
    kw = {}
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f"ProcessSpec(device={spec.device!r}) needs a "
                               "CUDA card; pass device=\"cpu\" for gloo")
        card = torch.device(spec.device)
        if card.index is None:
            card = torch.device("cuda", spec.rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = card
    dist.init_process_group(
        backend, init_method=spec.init_method, world_size=spec.world_size,
        rank=spec.rank, timeout=datetime.timedelta(seconds=spec.timeout_s),
        **kw)
    return dist


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, spec: ProcessSpec, args, results) -> None:
    try:
        initialize(spec)
        out = fn(*args)
    except BaseException:
        results.put((spec.rank, False, traceback.format_exc()))
        raise
    results.put((spec.rank, True, out))
    shutdown()


def launch(fn: Callable, world_size: int, args=(), device: str = "cuda",
           timeout_s: float = 600.0) -> list:
    """fn(*args) in `world_size` fresh processes (spawned) joined to one
    process group on a free localhost port, rank k on card k with cards;
    returns [rank 0's result, ...] (results travel pickled, so return host
    values). A rank that raises, dies, or has not returned and exited
    within timeout_s fails the launch: the other ranks are killed and
    RuntimeError is raised with the rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://localhost:{_free_port()}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, ProcessSpec(init, world_size, r, device=device,
                        timeout_s=min(timeout_s, COLLECTIVE_TIMEOUT_S)),
        args, results))
        for r in range(world_size)]
    out, deadline = {}, time.monotonic() + timeout_s

    def failed(who, what):
        return RuntimeError(f"rank {who} of {world_size} {what}")

    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise failed(sorted(set(range(world_size)) - set(out)),
                             f"did not return within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:    # its error, if it sent one, is in the queue
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise failed(dead[0], "exited with code "
                                     f"{procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise failed(rank, f"raised:\n{value}")
            out[rank] = value
        for r, p in enumerate(procs):
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.exitcode != 0:
                raise failed(r, f"did not exit cleanly (exit code "
                             f"{p.exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(10.0)
        results.close()
    return [out[r] for r in range(world_size)]


@dataclasses.dataclass
class ProcessMesh:
    """The global mesh of the JAX package as a rank -> robots map: rank k
    holds robots [k * R / n, (k + 1) * R / n) (process-major, contiguous)."""
    world_size: int
    rank: int

    def robots(self, n_robots: int, rank: Optional[int] = None) -> List[int]:
        k = self.rank if rank is None else rank
        if n_robots % self.world_size:
            raise ValueError(f"{n_robots} robots do not split over "
                             f"{self.world_size} processes")
        per = n_robots // self.world_size
        return list(range(k * per, (k + 1) * per))


def global_mesh() -> ProcessMesh:
    """The process group's mesh; this process alone without one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return ProcessMesh(1, 0)
    return ProcessMesh(dist.get_world_size(), dist.get_rank())


def local_batch_to_global(local: torch.Tensor, group=None) -> torch.Tensor:
    """This process's rows of a [R, ...] batch -> all R rows (an all_gather
    over the group, rows in rank order; bools travel as uint8). Without a
    process group the local rows are all rows. Each all_gather adds one to
    `local_batch_to_global.calls` and the bytes this process receives to
    `.bytes`."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return local
    x = local.to(torch.uint8) if local.dtype == torch.bool else local
    bufs = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, x.contiguous(), group=group)
    local_batch_to_global.calls += 1
    local_batch_to_global.bytes += x.numel() * x.element_size() * len(bufs)
    return torch.cat(bufs).to(local.dtype)


local_batch_to_global.calls = 0
local_batch_to_global.bytes = 0


def run_spmd_mission_step(cfg, n_steps: int = 3, device="cuda"):
    """The team step over the process group (or this process alone, holding
    every robot, where there is none): this process's robots, every
    robot-to-robot TF seeded (identity frames) so that every packet folds
    from the first step, `n_steps` timed steps after one untimed one.
    Returns (this process's rows of the stacked poses, of pose_count, and
    the seconds per step)."""
    from . import multirobot

    mesh = global_mesh()
    R = cfg.number_of_robots
    mine = mesh.robots(R)
    step = multirobot.build_spmd_step(cfg, device, robots=mine,
                                      gather=local_batch_to_global)
    state = multirobot.make_spmd_state(cfg, device, robots=mine)
    state = state._replace(tf_valid=torch.ones_like(state.tf_valid))
    full = multirobot.make_example_packets(cfg, device=device)
    rows = slice(mine[0], mine[-1] + 1)
    packets = multirobot.KeyframePacket(
        full.pose_est[rows], full.rel_odom[rows],
        *(type(o)(*(f[rows] for f in o)) for o in (full.cyl, full.cub,
                                                    full.ell)))
    sync = (torch.cuda.synchronize if str(device).startswith("cuda")
            else (lambda: None))
    state = step(state, packets)
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = step(state, packets)
    sync()
    dt = (time.perf_counter() - t0) / n_steps
    return (state.graph.poses.cpu().numpy(),
            state.graph.pose_count.cpu().numpy(), dt)
