"""The decentralized team step (PyTorch twin of
slide_slam_tpu/parallel/multirobot.py).

The reference runs N identical sloam_node processes connected by ROS
pub/sub. The JAX package shards the N decentralized replicas over a device
mesh axis "robot": each replica holds one robot's full engine state (its own
factor graph with ALL robots' chains), ingests its own keyframe stream, and
communication becomes collectives (all_gather of the keyframe packets and of
the [R, R] inter-robot TF table, a one-hop TF gossip, and the streamed
merge of peers' keyframes once their TF is known).

Here the robot axis is the leading axis of the stacked state on one card
(or, under torch.distributed, each process holds the rows of its robots,
parallel/multiprocess.py, and `gather` all-gathers the rows). The step
loops over the robots on one stream; it reads the [R, R] `tf_valid` table
on the host once per step, which takes the place of JAX's `lax.cond(known,
fold, id)` inside its scan over the R packets: the same folds in the same
order, the own keyframe at the diagonal. JAX's donated state has no
counterpart: the step returns a new state and leaves its input unchanged.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import SlamConfig
from ..factorgraph.graph import GraphState, empty_state
from ..geometry import se3, se3np
from ..objects import Cuboids, Cylinders, Ellipsoids
from ..runtime import engine


class KeyframePacket(NamedTuple):
    """Fixed-shape per-robot keyframe messages (sloam_msgs/PoseMst), with a
    leading robot axis on every field."""
    pose_est: torch.Tensor    # [R, 7] key pose estimate in own frame
    rel_odom: torch.Tensor    # [R, 7]
    cyl: Cylinders            # [R, S, ...] padded body-frame scans
    cub: Cuboids
    ell: Ellipsoids


class SpmdState(NamedTuple):
    """Per-robot replica states; leading axis = robot."""
    graph: GraphState         # stacked [R, ...]
    tf_vals: torch.Tensor     # [R, R, 7] peer frame -> own frame
    tf_valid: torch.Tensor    # [R, R] bool (diagonal always True)


def stack_graphs(graphs: Sequence[GraphState]) -> GraphState:
    return GraphState(*(torch.stack(f) for f in zip(*graphs)))


def graph_at(graph: GraphState, r: int) -> GraphState:
    return GraphState(*(f[r] for f in graph))


def _packet_at(packets: KeyframePacket, r: int) -> KeyframePacket:
    return KeyframePacket(packets.pose_est[r], packets.rel_odom[r],
                          *(type(o)(*(f[r] for f in o))
                            for o in (packets.cyl, packets.cub, packets.ell)))


def make_spmd_state(cfg: SlamConfig, device="cuda",
                    robots: Optional[Sequence[int]] = None) -> SpmdState:
    """Empty replicas of `robots` (default: all R), each with every robot's
    chain slots; the TF table knows only each robot's own frame."""
    R = cfg.number_of_robots
    robots = list(range(R)) if robots is None else list(robots)
    single = empty_state(cfg, device=device)
    L = len(robots)
    graph = GraphState(*(a[None].expand((L,) + tuple(a.shape)).clone()
                         for a in single))
    tf_valid = torch.zeros((L, R), dtype=torch.bool, device=device)
    tf_valid[torch.arange(L), torch.as_tensor(robots)] = True
    return SpmdState(graph, se3.identity((L, R), device=device), tf_valid)


def _fold_packet(cfg, g, robot_id, packet, tf, noise_odom, noise_cube):
    g, _ = engine.keyframe_step(
        cfg, g, robot_id, se3.compose(tf, packet.pose_est), packet.rel_odom,
        packet.cyl, packet.cub, packet.ell, False, False, noise_odom,
        noise_cube, enable_solve=False)
    return g


def gossip(my_vals, my_valid, all_vals, all_valid):
    """One transitive hop of the TF gossip (databaseManager.cpp:167-187):
    if robot A knows B and B knows C, A learns C = tf_A[B] o tf_B[C], from
    the first such B. my_* are A's rows [L, R, ...], all_* the whole table
    [R, R, ...] before this hop."""
    L, R = my_valid.shape
    cand = se3.compose(my_vals[:, :, None, :].expand(L, R, R, 7),
                       all_vals[None].expand(L, R, R, 7))      # [L, B, C]
    ok = my_valid[:, :, None] & all_valid[None]
    ar = torch.arange(R, device=my_vals.device)
    # the first valid B, as an explicit min over indices (JAX: argmax)
    first = torch.clamp(torch.where(ok, ar[None, :, None], R).amin(dim=1),
                        max=R - 1)                              # [L, C]
    new = torch.gather(cand, 1, first[:, None, :, None].expand(L, 1, R, 7))
    take = ok.any(dim=1) & ~my_valid
    return (torch.where(take[..., None], new[:, 0], my_vals),
            my_valid | take)


def build_spmd_step(cfg: SlamConfig, device="cuda",
                    robots: Optional[Sequence[int]] = None,
                    gather: Optional[Callable] = None):
    """The team step (SpmdState, packets) -> SpmdState for the replicas of
    `robots` (default: all R, on this device). Every replica: gossip-close
    its TF row over the gathered table, fold every packet whose frame it
    knows (its own at the diagonal), then one incremental solve. `gather`
    takes a tensor of this process's rows [L, ...] to all robots' rows
    [R, ...] (identity when this process holds every robot)."""
    R = cfg.number_of_robots
    robots = list(range(R)) if robots is None else list(robots)
    gather = gather or (lambda x: x)
    noise = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
             for k, v in (("odom", cfg.noise.odom), ("cube", cfg.noise.cube))}

    def step(state: SpmdState, packets: KeyframePacket) -> SpmdState:
        all_packets = KeyframePacket(
            gather(packets.pose_est), gather(packets.rel_odom),
            *(type(o)(*(gather(f) for f in o))
              for o in (packets.cyl, packets.cub, packets.ell)))
        tf_vals, tf_valid = gossip(state.tf_vals, state.tf_valid,
                                   gather(state.tf_vals),
                                   gather(state.tf_valid))
        known = tf_valid.cpu().numpy()
        graphs = []
        for i in range(len(robots)):
            g = graph_at(state.graph, i)
            for pid in np.flatnonzero(known[i]):
                g = _fold_packet(cfg, g, int(pid),
                                 _packet_at(all_packets, int(pid)),
                                 tf_vals[i, pid], noise["odom"],
                                 noise["cube"])
            graphs.append(engine.solve_incremental(cfg, g))
        return SpmdState(stack_graphs(graphs), tf_vals, tf_valid)

    return step


def set_tf(state: SpmdState, owner: int, peer: int, tf7) -> SpmdState:
    """A discovered inter-robot TF (the output of place recognition) for
    replica row `owner`; returns a new state."""
    tf_vals, tf_valid = state.tf_vals.clone(), state.tf_valid.clone()
    tf_vals[owner, peer] = torch.as_tensor(np.asarray(tf7, np.float32),
                                           device=tf_vals.device)
    tf_valid[owner, peer] = True
    return state._replace(tf_vals=tf_vals, tf_valid=tf_valid)


def make_example_packets(cfg: SlamConfig, rng_seed: int = 0,
                         device="cuda") -> KeyframePacket:
    """Small random per-robot packets (tests, the dry run): the JAX
    package's, drawn from the same numpy generator in the same order."""
    R = cfg.number_of_robots
    S = cfg.capacity.max_scan_objects
    rng = np.random.default_rng(rng_seed)
    dev = dict(device=device)

    def batch(shape, scale=1.0):
        return torch.as_tensor(
            rng.normal(0, scale, (R,) + shape).astype(np.float32), **dev)

    def first(k):
        return torch.as_tensor(np.arange(S)[None, :] < k, **dev).repeat(R, 1)

    def labels(v):
        return torch.full((R, S), v, dtype=torch.int32, **dev)

    ident = se3.identity((R, S), **dev)
    cyl = Cylinders(root=batch((S, 3), 5.0),
                    ray=torch.tensor([0.0, 0, 1], **dev).expand(R, S, 3),
                    radius=torch.abs(batch((S,), 0.3)), label=labels(8),
                    valid=first(5))
    cub = Cuboids(pose=ident, scale=torch.abs(batch((S, 3), 1.0)) + 1.0,
                  label=labels(5), valid=first(3))
    ell = Ellipsoids(pose=ident, scale=torch.abs(batch((S, 3), 0.5)) + 0.5,
                     label=labels(1), valid=first(2))
    pose_est = torch.as_tensor(np.stack(
        [se3np.from_xyz_yaw(float(r), 0.5, 0.0, 0.0) for r in range(R)]),
        **dev)
    return KeyframePacket(pose_est, se3.identity((R,), **dev), cyl, cub, ell)
