"""Multi-process execution (PyTorch twin of
slide_slam_tpu/parallel/multiprocess.py).

The JAX package joins N host processes to one global device mesh with
jax.distributed.initialize, and the same SPMD programs run over it. Here the
mesh becomes a torch.distributed process group and a rank -> robots map:
each process holds the replicas of a contiguous block of robots, and the
team step's all_gathers of keyframe packets and TF tables ride the group
(gloo between CPU processes, NCCL between cards). Nothing tells a process
of a cluster: `ProcessSpec` names the rendezvous address, the world size and
the rank. Without a process group the mesh is this one process.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch


@dataclasses.dataclass
class ProcessSpec:
    init_method: str                  # "tcp://localhost:<port>" of rank 0
    world_size: int
    rank: int
    backend: Optional[str] = None     # default: nccl with cards, else gloo
    device: str = "cuda"              # where this process's tensors live


def initialize(spec: ProcessSpec):
    """Join the process group; returns torch.distributed. With cards, rank
    k takes card k mod the card count as its current device."""
    import torch.distributed as dist
    cuda = spec.device.startswith("cuda")
    backend = spec.backend or ("nccl" if cuda else "gloo")
    if cuda and spec.device == "cuda":
        torch.cuda.set_device(spec.rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=spec.init_method,
                            world_size=spec.world_size, rank=spec.rank)
    return dist


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
    process group the local rows are all rows."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return local
    x = local.to(torch.uint8) if local.dtype == torch.bool else local
    bufs = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, x.contiguous(), group=group)
    return torch.cat(bufs).to(local.dtype)


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
