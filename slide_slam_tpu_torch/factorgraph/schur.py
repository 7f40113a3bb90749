"""Schur-complement landmark elimination (PyTorch twin of
slide_slam_tpu/factorgraph/schur.py).

Landmarks appear only in single-landmark factors, so Hll is block-diagonal
and the Gauss-Newton normal equations reduce to the pose-only system

    (Hpp - Hpl Hll^-1 Hlp) dp = -gp + Hpl Hll^-1 gl,

solved by PCG, followed by the back-substitution dl = Hll^-1 (-gl - Hlp dp).

Every segment sum is an exact f32 `index_add_`. The JAX version runs the
in-loop and curvature-side sums as bf16x3 one-hot matmuls unless its
`exact_curvature` flag is set, a TPU workaround for serialized scatters; the
port does not copy it, so it has no such flag: its sums are the exact ones
of both JAX branches.
CUDA's `index_add_` sums in an order that changes from run to run, so two
runs on the card agree to float32 rounding, not bit for bit.

The JAX version's `axis_name` (a landmark-sharded solve, parallel/
landmark_sharded.py) becomes a `reduce` callable, the identity by default:
the pose-side sums that must be global on every shard (the damping diagonal,
the block preconditioner, the reduced matvec, the right-hand side, the cost)
pass through it, at the points where the JAX version psums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..runtime import cuda_graphs
from ..runtime.profiling import annotate, host_read, phase
from . import solver
from .graph import GraphState


def _scatter_rows(idx, y, n):
    """Rows of y [F, D...] summed into [n, D...] (exact f32)."""
    out = torch.zeros((n,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    return out.index_add_(0, idx, y)


class SchurOperands(NamedTuple):
    A: torch.Tensor           # [F, 6, 9]  Jp^T Jl per landmark factor
    pidx: torch.Tensor        # [F] pose slot per factor (int64)
    lidx: torch.Tensor        # [F] unified landmark index per factor (int64)
    Hll_inv: torch.Tensor     # [NL, 9, 9] damped block inverses (0 if inactive)
    od_Ji: torch.Tensor       # [RP, 6, 6]
    od_Jj: torch.Tensor       # [RP, 6, 6]
    bf_Ji: torch.Tensor       # [BF, 6, 6]
    bf_Jj: torch.Tensor       # [BF, 6, 6]
    bidx: torch.Tensor        # [2*BF] pose slots of both between sides (int64)
    Dp: torch.Tensor          # [RP, 6, 6] sum Jp^T Jp per pose
    diag_p: torch.Tensor      # [RP, 6] diag(Hpp) for damping
    prec_inv: torch.Tensor    # [RP, 6, 6] block-Jacobi inverse, or [0, 6, 6]
    g_p: torch.Tensor         # [RP, 6]
    g_l: torch.Tensor         # [NL, 9]
    frozen: torch.Tensor      # [RP] anchor mask
    lm_active: torch.Tensor   # [NL]


def _lm_factor_pack(s: GraphState, lin: solver.Linearization):
    """Cylinder, cuboid and bearing-range factors as one landmark-factor
    family: residual dim padded to 9, landmark tangent dims (7, 9, 3) padded
    to 9 with zero columns."""
    NC = s.cyl_ray.shape[0]
    NK = s.cub_pose.shape[0]

    def pad(r, Jp, Jl, rdim, ldim):
        F = r.shape[0]
        r9 = torch.nn.functional.pad(r, (0, 9 - rdim))
        Jp9 = torch.nn.functional.pad(Jp, (0, 0, 0, 9 - rdim))
        Jl9 = torch.nn.functional.pad(Jl, (0, 9 - ldim, 0, 9 - rdim))
        assert Jp9.shape == (F, 9, 6) and Jl9.shape == (F, 9, 9)
        return r9, Jp9, Jl9

    cr, cp, cl = pad(lin.cf_r, lin.cf_Jp, lin.cf_Jl, 7, 7)
    ur, up, ul = pad(lin.uf_r, lin.uf_Jp, lin.uf_Jl, 4, 3)
    r = torch.cat([cr, lin.kf_r, ur], dim=0)
    Jp = torch.cat([cp, lin.kf_Jp, up], dim=0)
    Jl = torch.cat([cl, lin.kf_Jl, ul], dim=0)
    pidx = torch.cat([s.cf_pose, s.kf_pose, s.uf_pose]).long()
    lidx = torch.cat([s.cf_lm.long(), NC + s.kf_lm.long(),
                      NC + NK + s.uf_lm.long()])
    return r, Jp, Jl, pidx, lidx


def _shift_to_prev(y):
    """Route per-factor rows to slot f-1 (odom factor f couples f-1 -> f)."""
    return torch.cat([y[1:], torch.zeros_like(y[:1])], dim=0)


def _diag(blocks):
    return torch.diagonal(blocks, dim1=-2, dim2=-1)


def build_operands(s: GraphState, cyl_sigma, bearing_sigma, lam,
                   block_precond: bool = True,
                   reduce=solver._identity) -> SchurOperands:
    """Everything the reduced-system PCG needs, built once per outer GN
    iteration; `reduce` sums the damping diagonal and the preconditioner's
    blocks over the shards of a landmark-sharded solve."""
    RP = s.poses.shape[0]
    NC = s.cyl_ray.shape[0]
    NL = NC + s.cub_pose.shape[0] + s.pt_pos.shape[0]
    dt, dev = s.poses.dtype, s.poses.device

    lin = solver.linearize(s, cyl_sigma, bearing_sigma)
    r, Jp, Jl, pidx, lidx = _lm_factor_pack(s, lin)

    A = torch.einsum("fri,frj->fij", Jp, Jl)                    # [F, 6, 9]
    Dp = _scatter_rows(pidx, torch.einsum("fri,frj->fij", Jp, Jp), RP)
    Hll_blocks = _scatter_rows(lidx, torch.einsum("fri,frj->fij", Jl, Jl), NL)
    lm_active = torch.cat([s.cyl_valid(), s.cub_valid(), s.pt_valid()])
    eye9 = torch.eye(9, dtype=dt, device=dev)
    # absolute ridge 1e-4 keeps a weakly observed block invertible
    damped = Hll_blocks + lam * _diag(Hll_blocks)[..., None] * eye9 + 1e-4 * eye9
    damped = torch.where(lm_active[:, None, None], damped, eye9)
    # cylinder blocks are exactly diagonal (Jl = diag(1..1, -1) / sigma):
    # reciprocal instead of a matrix inverse; cuboid/point blocks invert
    cyl_inv = (1.0 / torch.clamp(_diag(damped[:NC]), min=1e-8))[:, :, None] * eye9
    rest_inv = torch.linalg.inv(damped[NC:])
    Hll_inv = torch.where(lm_active[:, None, None],
                          torch.cat([cyl_inv, rest_inv], dim=0),
                          torch.zeros((), dtype=dt, device=dev))

    g_p = _scatter_rows(pidx, torch.einsum("fri,fr->fi", Jp, r), RP)
    g_l = _scatter_rows(lidx, torch.einsum("fri,fr->fi", Jl, r), NL)
    g_p = (g_p + torch.einsum("fri,fr->fi", lin.od_Jj, lin.od_r)
           + _shift_to_prev(torch.einsum("fri,fr->fi", lin.od_Ji, lin.od_r)))
    bidx = torch.cat([s.bf_i, s.bf_j]).long()
    bf_g = torch.cat([torch.einsum("fri,fr->fi", lin.bf_Ji, lin.bf_r),
                      torch.einsum("fri,fr->fi", lin.bf_Jj, lin.bf_r)], dim=0)
    g_p = g_p + _scatter_rows(bidx, bf_g, RP)

    sq = lambda J: torch.einsum("fri,fri->fi", J, J)
    diag_p = reduce(
        _diag(Dp) + sq(lin.od_Jj) + _shift_to_prev(sq(lin.od_Ji))
        + _scatter_rows(bidx, torch.cat([sq(lin.bf_Ji), sq(lin.bf_Jj)]), RP))

    if block_precond:
        gram = lambda J: torch.einsum("fri,frj->fij", J, J)
        corr_f = torch.einsum("fij,fjk,flk->fil", A, Hll_inv[lidx], A)
        bf_p = _scatter_rows(bidx, torch.cat([gram(lin.bf_Ji),
                                              gram(lin.bf_Jj)]), RP)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        S_diag = (reduce(Dp + gram(lin.od_Jj) + _shift_to_prev(gram(lin.od_Ji))
                         + bf_p - _scatter_rows(pidx, corr_f, RP))
                  + lam * diag_p[:, :, None] * eye6 + 1e-6 * eye6)
        prec_inv = torch.linalg.inv(S_diag)
    else:
        prec_inv = torch.zeros((0, 6, 6), dtype=dt, device=dev)

    return SchurOperands(A, pidx, lidx, Hll_inv, lin.od_Ji, lin.od_Jj,
                         lin.bf_Ji, lin.bf_Jj, bidx, Dp, diag_p, prec_inv,
                         g_p, g_l, solver._frozen_pose_mask(s), lm_active)


def _project(frozen, x):
    return torch.where(frozen[:, None], torch.zeros_like(x), x)


def _bmv(M, v):
    """Batched matrix-vector product M [n, a, b] @ v [n, b] -> [n, a]."""
    return torch.einsum("nij,nj->ni", M, v)


def _bmtv(M, v):
    """Batched M^T v: M [n, a, b], v [n, a] -> [n, b]."""
    return torch.einsum("nij,ni->nj", M, v)


def s_matvec(op: SchurOperands, x, lam, reduce=solver._identity):
    """S x on the reduced pose system; `reduce` sums the shards' parts (x
    and the result are replicated, op.diag_p is already global)."""
    x = _project(op.frozen, x)
    RP = x.shape[0]
    hx = _bmv(op.Dp, x)
    # odometry chain: v = Ji x_{f-1} + Jj x_f per factor f
    xprev = torch.cat([x[:1], x[:-1]], dim=0)
    v = _bmv(op.od_Ji, xprev) + _bmv(op.od_Jj, x)
    hx = hx + _bmtv(op.od_Jj, v) + _shift_to_prev(_bmtv(op.od_Ji, v))
    # between factors
    BF = op.bf_Ji.shape[0]
    vb = _bmv(op.bf_Ji, x[op.bidx[:BF]]) + _bmv(op.bf_Jj, x[op.bidx[BF:]])
    yb = torch.cat([_bmtv(op.bf_Ji, vb), _bmtv(op.bf_Jj, vb)], dim=0)
    hx = hx + _scatter_rows(op.bidx, yb, RP)
    # Schur correction: - A Hll^-1 A^T x, aggregated through the factors
    t = _bmtv(op.A, x[op.pidx])                                  # [F, 9]
    z = _scatter_rows(op.lidx, t, op.Hll_inv.shape[0])           # [NL, 9]
    w = _bmv(op.Hll_inv, z)
    u = _bmv(op.A, w[op.lidx])                                   # [F, 6]
    hx = reduce(hx - _scatter_rows(op.pidx, u, RP)) + lam * op.diag_p * x
    return _project(op.frozen, hx)


def _preconditioner(prec):
    """M^-1 r: the block-Jacobi inverses [RP, 6, 6] or the scalar [RP, 6]."""
    if prec.ndim == 3:
        return lambda r: _bmv(prec, r)
    return lambda r: r * prec


def solve_reduced(op: SchurOperands, lam, pcg_iters, pcg_tol, step_tol=0.0,
                  reduce=solver._identity):
    """PCG on the reduced pose system; returns (dp [RP,6], dl [NL,9]): dp
    replicated over the shards of a landmark-sharded solve, dl each shard's
    own landmark block."""
    RP = op.g_p.shape[0]
    NL = op.g_l.shape[0]
    w0 = _bmv(op.Hll_inv, op.g_l)
    b = reduce(-op.g_p + _scatter_rows(op.pidx, _bmv(op.A, w0[op.lidx]), RP))
    b = _project(op.frozen, b)
    if op.prec_inv.shape[0]:
        prec = op.prec_inv
    else:
        prec = 1.0 / (op.diag_p * (1.0 + lam) + 1e-8)
    dp = _pcg(op, prec, b, lam, pcg_iters, pcg_tol, step_tol, reduce)
    hlp_dp = _scatter_rows(op.lidx, _bmtv(op.A, dp[op.pidx]), NL)
    dl = _bmv(op.Hll_inv, -op.g_l - hlp_dp)
    dl = torch.where(op.lm_active[:, None], dl, torch.zeros_like(dl))
    return dp, dl


def _pcg(op, prec, b, lam, max_iters, tol, step_tol, reduce):
    """solver.pcg on S dp = b, its blocks replayed from a CUDA graph where
    `_graph_ok`, eagerly elsewhere; `pcg_graph` on the `solve.pcg` span
    says which."""
    if _graph_ok(b.device, reduce):
        return _pcg_graphed(op, prec, b, lam, max_iters, tol, step_tol)
    return solver.pcg(lambda x: s_matvec(op, x, lam, reduce), b,
                      _preconditioner(prec), max_iters, tol, step_tol)


# what s_matvec reads of SchurOperands; with the preconditioner, the
# operands a graphed PCG block takes
_MATVEC_FIELDS = ("A", "pidx", "lidx", "Hll_inv", "od_Ji", "od_Jj", "bf_Ji",
                  "bf_Jj", "bidx", "Dp", "diag_p", "frozen")


def _matvec_operands(ts) -> SchurOperands:
    """SchurOperands holding `ts` in `_MATVEC_FIELDS`, None elsewhere."""
    return SchurOperands(**{**dict.fromkeys(SchurOperands._fields),
                            **dict(zip(_MATVEC_FIELDS, ts))})


def pcg_block(n: int, lam: float, max_iters: int, step_tol: float):
    """The function a CUDA graph captures for a block of `n` PCG iterations
    on the reduced system: inputs the operands (`_MATVEC_FIELDS`, then the
    preconditioner), the carry (solver.PcgCarry's fields) and the stop
    threshold; it writes the next carry over its input carry and returns
    [more], the block's stop test. No host read and no host data."""
    m = len(_MATVEC_FIELDS)

    def fn(x):
        op = _matvec_operands(x[:m])
        carry = solver.PcgCarry(*x[m + 1:-1])
        thresh = x[-1]
        hv = lambda v: s_matvec(op, v, lam)
        precond = _preconditioner(x[m])
        zero = torch.zeros_like(thresh)
        c = carry
        for _ in range(n):
            c = solver.pcg_step(c, thresh, zero, hv, precond, max_iters,
                                step_tol)
        torch._foreach_copy_(list(carry[:5]), list(c[:5]))   # float carry
        torch._foreach_copy_(list(carry[5:]), list(c[5:]))   # int32 counts
        return [solver.pcg_more(c, thresh, max_iters)]
    return fn


def _pcg_graphed(op, prec, b, lam, max_iters, tol, step_tol):
    """solver.pcg, each block of PCG_BLOCK iterations one replay of a CUDA
    graph captured once per key (the inputs' shapes and dtypes, the block's
    length, lam, max_iters, step_tol): the operands and the carry are
    copied into the graph's buffers once, the carry stays there between
    blocks, and the host reads the stop flag once a block, as eagerly. A
    last block shorter than PCG_BLOCK has a graph of its own."""
    with phase("solve.pcg"):
        annotate(pcg_graph=1)
        carry = solver.pcg_start(b, _preconditioner(prec))
        thresh = solver.pcg_threshold(carry.rz, tol)
        operands = [getattr(op, f) for f in _MATVEC_FIELDS] + [prec]
        nums = (float(lam), int(max_iters), float(step_tol))
        full, rest = divmod(int(max_iters), solver.PCG_BLOCK)
        more = True
        for n, blocks in ((solver.PCG_BLOCK, full), (rest, int(rest > 0))):
            if not (more and blocks):
                continue
            inputs = operands + list(carry) + [thresh]
            key = ("pcg_block", n, nums,
                   tuple((t.shape, t.dtype) for t in inputs))
            with cuda_graphs.bound("pcg_graph", key, pcg_block(n, *nums),
                                   inputs) as g:
                for _ in range(blocks):
                    with phase("pcg.block"):
                        flag, = g.replay()
                        with host_read("pcg_stop"):
                            more = bool(flag)
                    if not more:
                        break
                carry = solver.PcgCarry(*g.take(g.inputs[len(operands):-1]))
        annotate(pcg_iters=carry.k)
    return carry.x


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def line_search(s: GraphState, dx: solver.Tangent, scales, cyl_sigma,
                bearing_sigma, rel_tol, reduce=solver._identity):
    """One outer iteration's backtracking line search: the cost at s and at
    s retracted by each of `scales` [3] times dx; then s retracted by the
    best scale where it lowers the cost, else by 0. Returns (state, more),
    `more` a 0-d bool: the step was accepted and cut the cost by more than
    rel_tol. No host read and no host data, so a CUDA graph can capture it
    (`torch.take`: indexing by the 0-d `best` would read it on the host)."""
    c0 = solver.cost(s, cyl_sigma, bearing_sigma, reduce)
    costs = torch.stack([
        solver.cost(solver.retract_state(s, solver.tree_scale(a, dx)),
                    cyl_sigma, bearing_sigma, reduce) for a in scales])
    best = torch.argmin(costs)
    c_best = torch.take(costs, best)
    accept = c_best < c0
    alpha = torch.where(accept, torch.take(scales, best), torch.zeros_like(c0))
    improved = (c0 - c_best) > rel_tol * (c0 + 1e-9)
    return (solver.retract_state(s, solver.tree_scale(alpha, dx)),
            accept & improved)


def _graph_ok(device: torch.device, reduce) -> bool:
    """The PCG blocks and the line search run as CUDA graphs on a card in an
    unsharded solve; a sharded one's `reduce` syncs threads or ranks, so
    they run eagerly."""
    return device.type == "cuda" and reduce is solver._identity


def _line_search(s, dx, scales, cyl_sigma, bearing_sigma, rel_tol, reduce):
    """`line_search`, replayed from a CUDA graph captured once per state
    shape where `_graph_ok`, eagerly elsewhere; `ls_graph` on the
    enclosing span says which."""
    if not _graph_ok(s.poses.device, reduce):
        annotate(ls_graph=0)
        return line_search(s, dx, scales, cyl_sigma, bearing_sigma, rel_tol,
                           reduce)
    annotate(ls_graph=1)
    n, m = len(s), len(dx)
    floats = (float(cyl_sigma), float(bearing_sigma), float(rel_tol))

    def fn(x):
        new, more = line_search(GraphState(*x[:n]),
                                solver.Tangent(*x[n:n + m]), x[-1], *floats)
        return list(new) + [more]
    inputs = list(s) + list(dx) + [scales]
    key = ("line_search", tuple((t.shape, t.dtype) for t in inputs), floats)
    out = cuda_graphs.replay("ls_graph", key, fn, inputs)
    return GraphState(*out[:n]), out[n]


def solve(s: GraphState, *, cyl_sigma: float, bearing_sigma: float,
          outer_iters: int, pcg_iters: int, pcg_tol: float = 1e-6,
          lam: float = 1e-6, rel_tol: float = 1e-6,
          line_search: bool = True, block_precond: bool = True,
          step_tol: float = 0.0, reduce=solver._identity) -> GraphState:
    """Schur-eliminated damped Gauss-Newton. The outer loop reads its stop
    flag on the host once per iteration (at most `outer_iters` reads).
    `reduce`: a landmark-sharded solve (poses replicated and summed,
    landmarks and their factors local per shard)."""
    NC = s.cyl_ray.shape[0]
    NK = s.cub_pose.shape[0]
    scales = solver.line_search_scales(s.poses.device, s.poses.dtype)
    with phase("solve"):
        for _ in range(int(outer_iters)):
            with phase("solve.build"):
                op = build_operands(s, cyl_sigma, bearing_sigma, lam,
                                    block_precond, reduce)
            dp, dl = solve_reduced(op, lam, pcg_iters, pcg_tol, step_tol,
                                   reduce)
            dp = solver.clamp_rows(_finite(dp))
            dl = solver.clamp_rows(_finite(dl))
            dx = solver.Tangent(pose=dp, cyl=dl[:NC, :7], cub=dl[NC:NC + NK],
                                pt=dl[NC + NK:, :3])
            if not line_search:
                s = solver.retract_state(s, dx)
                continue
            with phase("solve.line_search"):
                s, more = _line_search(s, dx, scales, cyl_sigma,
                                       bearing_sigma, rel_tol, reduce)
                with host_read("accept"):
                    more = bool(more)
            if not more:
                break
    return s
