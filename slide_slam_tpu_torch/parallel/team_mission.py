"""The decentralized team mission with inter-robot TF discovery: the port's
counterpart of the JAX package's multi-chip dry run (__graft_entry__.py:
`_scale_cfg`, `_dryrun_world`, `_packets_for_step`, `_replica_compact_map`,
`_run_spmd_mission`), with its own copies of those helpers.

Robots start with no cross TFs and build maps of a shared forest from their
own streams (each robot's odometry frame sits offset in the world, unknown
to its peers; the visible subset of the forest slides with the step). At
step max(2, n_steps // 2) every replica runs SlideMatch
(PlaceRecognition.find_inter_loop_closure, the reference's
interLoopClosureThread_) between its own compact cylinder map and that of
every peer whose TF it lacks; a TF found goes in through multirobot.set_tf
and the peer's stream folds from the next step on.

The mission runs in one process (every robot) or over a torch.distributed
group (this rank's contiguous block of robots, multiprocess.ProcessMesh):
the packets are made for this rank's robots, the team step's gathers ride
the group, and before the search the replicas' cylinder maps are
all-gathered as fixed-capacity tensors with their counts, so every rank
searches the maps that one process would.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import CapacityConfig, SlamConfig, SolverConfig
from ..geometry import se3np
from ..objects import Cuboids, Cylinders, Ellipsoids
from ..place_recognition.slidematch import PlaceRecognition
from . import multiprocess, multirobot


def scale_config(n_robots: int) -> SlamConfig:
    """The dry run's capacities (512 poses a robot, 1024 cylinders) with a
    bounded solver budget (2 x 16 full, 1 x 8 incremental)."""
    return SlamConfig(
        number_of_robots=n_robots,
        capacity=CapacityConfig(
            max_poses_per_robot=512, max_cylinders=1024, max_cuboids=128,
            max_points=128, max_scan_objects=32, max_cylinder_factors=2048,
            max_cuboid_factors=256, max_point_factors=256,
            max_between_factors=64),
        solver=SolverConfig(max_outer_iterations=2, pcg_max_iterations=16,
                            incremental_outer_iterations=1,
                            incremental_pcg_iterations=8))


def dryrun_world(rng: np.random.Generator):
    """A shared forest the robots co-observe: 28 cylinders on a jittered
    7 x 4 grid at 3 m (enough overlap for SlideMatch's 8-inlier gate)."""
    gx, gy = np.meshgrid(np.arange(7) * 3.0, np.arange(4) * 3.0)
    xy = np.stack([gx.ravel(), gy.ravel()], 1) + rng.normal(0, 0.5, (28, 2))
    root = np.concatenate([xy, np.zeros((28, 1))], 1).astype(np.float32)
    radius = rng.uniform(0.15, 0.4, 28).astype(np.float32)
    return root, radius


def robot_frames(n_robots: int) -> List[np.ndarray]:
    """Each robot's odometry frame in the world."""
    return [np.asarray(se3np.from_xyz_yaw(0.8 * r, 0.4 * (r % 3), 0.0, 0.0),
                       np.float32) for r in range(n_robots)]


def packets_for_step(cfg: SlamConfig, world_root, world_radius, frames, k: int,
                     robots: Sequence[int], device="cuda"
                     ) -> multirobot.KeyframePacket:
    """The keyframe packets of `robots` at step k: body-frame scans of the
    shared world, each robot 0.7 m a step along its own x axis, a rotating
    quarter of the world out of view (every step's packets differ)."""
    L, S = len(robots), cfg.capacity.max_scan_objects
    roots = np.zeros((L, S, 3), np.float32)
    radii = np.zeros((L, S), np.float32)
    valid = np.zeros((L, S), bool)
    poses = np.zeros((L, 7), np.float32)
    vis = np.nonzero((np.arange(len(world_root)) % 4) != (k % 4))[0][:S]
    own = se3np.from_xyz_yaw(0.7 * k, 0.0, 0.0, 0.0)
    for i, r in enumerate(robots):
        inv = se3np.inverse(se3np.compose(frames[r], own))
        roots[i, :len(vis)] = se3np.apply(inv, world_root[vis])
        radii[i, :len(vis)] = world_radius[vis]
        valid[i, :len(vis)] = True
        poses[i] = own                   # in the robot's own odometry frame
    rel = np.tile(np.array([1, 0, 0, 0, 0.7 if k else 0.0, 0, 0], np.float32),
                  (L, 1))
    dev = dict(device=device)
    ident = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], **dev).expand(L, S, 7)
    none = dict(scale=torch.ones((L, S, 3), **dev),
                label=torch.zeros((L, S), dtype=torch.int32, **dev),
                valid=torch.zeros((L, S), dtype=torch.bool, **dev))
    cyl = Cylinders(root=torch.as_tensor(roots, **dev),
                    ray=torch.tensor([0.0, 0, 1], **dev).expand(L, S, 3),
                    radius=torch.as_tensor(radii, **dev),
                    label=torch.full((L, S), 8, dtype=torch.int32, **dev),
                    valid=torch.as_tensor(valid, **dev))
    return multirobot.KeyframePacket(
        torch.as_tensor(poses, **dev), torch.as_tensor(rel, **dev), cyl,
        Cuboids(pose=ident, **none), Ellipsoids(pose=ident, **none))


def compact_map(label, root, radius, count: int) -> np.ndarray:
    """Vector7d rows [label, x, y, z, radius, 0, 0] of one replica's
    cylinder map (host arrays)."""
    rows = np.zeros((count, 7), np.float32)
    rows[:, 0] = label[:count]
    rows[:, 1:4] = root[:count]
    rows[:, 4] = radius[:count]
    return rows


def discover(state: multirobot.SpmdState, robots: Sequence[int],
             pr: PlaceRecognition):
    """SlideMatch between each of `robots`' replicas (rows of `state`) and
    every peer replica whose TF it lacks, over all R replicas' cylinder
    maps (all-gathered over the process group, if there is one). Returns
    (state with the TFs found, [(owner, peer)] found, the R compact maps
    searched)."""
    g = state.graph
    label, root, radius, count = (
        multiprocess.local_batch_to_global(f).cpu().numpy()
        for f in (g.cyl_label, g.cyl_root, g.cyl_radius, g.cyl_count))
    maps = [compact_map(label[r], root[r], radius[r], int(count[r]))
            for r in range(len(count))]
    known = state.tf_valid.cpu().numpy()
    found = []
    for i, owner in enumerate(robots):
        for peer in range(len(maps)):
            if peer == owner or known[i, peer]:
                continue
            ok, tf = pr.find_inter_loop_closure(maps[owner], maps[peer])
            if ok:
                state = multirobot.set_tf(state, i, peer,
                                          se3np.from_matrix(tf))
                found.append((owner, peer))
    return state, found, maps


class MissionResult(NamedTuple):
    state: multirobot.SpmdState       # this process's replicas
    robots: List[int]                 # their robot ids (the state's rows)
    found: List[Tuple[int, int]]      # (owner, peer) TFs found, own rows
    maps: List[np.ndarray]            # every replica's map at the search
    step_s: List[float]               # seconds of each step
    discovery_s: float                # seconds of the gather and search


def run_team_mission(cfg: SlamConfig, n_steps: int,
                     device="cuda") -> MissionResult:
    """The mission over the process group (this rank's robots) or, without
    one, in this process (every robot): n_steps team steps from empty
    replicas with SlideMatch TF discovery after step max(2, n_steps // 2).
    Steps and the discovery are timed on the host clock after a sync."""
    R = cfg.number_of_robots
    robots = multiprocess.global_mesh().robots(R)
    world_root, world_radius = dryrun_world(np.random.default_rng(42))
    frames = robot_frames(R)
    state = multirobot.make_spmd_state(cfg, device, robots=robots)
    step = multirobot.build_spmd_step(
        cfg, device, robots=robots, gather=multiprocess.local_batch_to_global)
    pr = PlaceRecognition(cfg.place_recognition, device=device)
    sync = (torch.cuda.synchronize if str(device).startswith("cuda")
            else (lambda: None))
    found, maps, step_s, discovery_s = [], [], [], 0.0
    discover_at = max(2, n_steps // 2)
    for k in range(n_steps):
        packets = packets_for_step(cfg, world_root, world_radius, frames, k,
                                   robots, device)
        sync()
        t0 = time.perf_counter()
        state = step(state, packets)
        sync()
        step_s.append(time.perf_counter() - t0)
        if k == discover_at:
            t0 = time.perf_counter()
            state, found, maps = discover(state, robots, pr)
            sync()
            discovery_s = time.perf_counter() - t0
    return MissionResult(state, robots, found, maps, step_s, discovery_s)
