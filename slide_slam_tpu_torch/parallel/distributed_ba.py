"""Factor-sharded bundle adjustment (PyTorch twin of
slide_slam_tpu/parallel/distributed_ba.py).

The normal equations are data-parallel over FACTORS: each shard owns a
contiguous slice of the between, cylinder, cuboid and bearing-range factor
arrays and computes its local J^T r, diag(J^T J) and J^T J v; the unified
solve's reductions (factorgraph/solver.py `reduce`) sum them over the
shards, so the PCG state stays replicated and in lockstep. The variables
and the per-robot odometry chain are replicated, the chain with its sigmas
inflated by sqrt(n) so that its summed information counts exactly once.

The shards run in one process, the shard axis as a leading dimension of the
stacked state (`distributed_solve(..., n_shards=n)`, threads in lockstep on
one device), or one per process of a torch.distributed group
(`distributed_solve(..., group=g)`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..config import SlamConfig
from ..factorgraph import solver
from ..factorgraph.graph import GraphState
from .reduce import all_reduce_sum, run_in_lockstep

# factor-array fields split across shards (others are replicated)
_SHARDED = {
    "bf_i": "bf_count", "bf_j": "bf_count", "bf_rel": "bf_count",
    "bf_sigma": "bf_count",
    "cf_pose": "cf_count", "cf_lm": "cf_count", "cf_meas": "cf_count",
    "kf_pose": "kf_count", "kf_lm": "kf_count", "kf_meas_pose": "kf_count",
    "kf_meas_scale": "kf_count", "kf_sigma": "kf_count",
    "uf_pose": "uf_count", "uf_lm": "uf_count", "uf_bearing": "uf_count",
    "uf_range": "uf_count",
}
_COUNTS = ("bf_count", "cf_count", "kf_count", "uf_count")
# the variables a solve changes (taken back from shard 0)
VAR_FIELDS = {"poses", "pose_count", "prior_pose", "prior_valid",
              "cyl_ray", "cyl_root", "cyl_radius", "cyl_label", "cyl_hits",
              "cyl_count", "cub_pose", "cub_scale", "cub_label", "cub_hits",
              "cub_count", "pt_pos", "pt_scale", "pt_label", "pt_hits",
              "pt_count", "keypose_xyz"}


def shard_state(state: GraphState, n: int) -> GraphState:
    """n per-shard states stacked along a leading axis, on state's device.

    Factor rows are split contiguously; counts become per-shard local
    counts; everything else is broadcast, with odom_sigma * sqrt(n)."""
    host = convert.state_to_numpy(state)
    out = {}
    for f, a in host.items():
        if f in _COUNTS:
            continue
        if f in _SHARDED:
            cap = a.shape[0]
            shard_cap = -(-cap // n)
            padded = np.concatenate(
                [a, np.zeros((shard_cap * n - cap,) + a.shape[1:], a.dtype)])
            out[f] = padded.reshape((n, shard_cap) + a.shape[1:])
        elif f == "odom_sigma":
            out[f] = np.broadcast_to(
                (a * np.sqrt(float(n))).astype(a.dtype), (n,) + a.shape)
        else:
            out[f] = np.broadcast_to(a, (n,) + a.shape)
    for cname in _COUNTS:
        owner = next(k for k, v in _SHARDED.items() if v == cname)
        shard_cap = out[owner].shape[1]
        out[cname] = np.clip(int(host[cname]) - shard_cap * np.arange(n), 0,
                             shard_cap).astype(np.int32)
    dev = state.poses.device
    return GraphState(**{f: torch.as_tensor(np.ascontiguousarray(out[f]),
                                            device=dev)
                         for f in GraphState._fields})


def unshard_state(stacked: GraphState, original: GraphState) -> GraphState:
    """The replicated variables from shard 0; the original factor arrays
    and counts (they were only re-laid-out for the solve)."""
    return GraphState(**{
        f: getattr(stacked, f)[0] if f in VAR_FIELDS else getattr(original, f)
        for f in GraphState._fields})


def _solve(cfg: SlamConfig, local: GraphState, reduce) -> GraphState:
    return solver.solve(
        local, cyl_sigma=cfg.noise.cylinder, bearing_sigma=cfg.noise.bearing,
        outer_iters=cfg.solver.max_outer_iterations,
        pcg_iters=cfg.solver.pcg_max_iterations, pcg_tol=cfg.solver.pcg_tol,
        reduce=reduce)


def build_distributed_solve(cfg: SlamConfig, group=None):
    """The factor-sharded unified solve. Without a group: stacked
    GraphState [n, ...] -> the same, the n shards in lockstep in this
    process. With a torch.distributed group: this process's shard ->
    its solved shard, the sums all-reduced over the group."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if group is not None:
        reduce = all_reduce_sum(group)
        return lambda local: _solve(cfg, local, reduce)

    def solve_stacked(stacked: GraphState) -> GraphState:
        n = stacked.poses.shape[0]
        shards = run_in_lockstep(
            lambda i, reduce: _solve(
                cfg, GraphState(*(f[i] for f in stacked)), reduce), n)
        return GraphState(*(torch.stack(f) for f in zip(*shards)))
    return solve_stacked


def distributed_solve(state: GraphState, cfg: SlamConfig, n_shards: int = 4,
                      group=None) -> GraphState:
    """Shard -> solve -> unshard: n_shards in this process, or, with a
    torch.distributed group, one shard per process (every process passes
    the same state and gets the same result)."""
    if group is None:
        solved = build_distributed_solve(cfg)(shard_state(state, n_shards))
        return unshard_state(solved, state)
    import torch.distributed as dist
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    local = GraphState(*(f[rank] for f in shard_state(state, n)))
    solved = build_distributed_solve(cfg, group)(local)
    return unshard_state(GraphState(*(f[None] for f in solved)), state)
