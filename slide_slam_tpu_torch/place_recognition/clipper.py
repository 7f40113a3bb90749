"""CLIPPER-style robust data association as dense PyTorch linear algebra
(twin of slide_slam_tpu/place_recognition/clipper.py).

* `affinity_matrix` == scorePairwiseConsistency (clipper.cpp:21-65) with the
  EuclideanDistance pairwise invariant.
* `find_dense_clique` == projected-gradient ascent with homotopy on the
  affinity relaxation (findDenseClique, clipper.cpp:172-310), DSD_HEU
  rounding (the top round(F) entries of u).

The JAX version runs the ascent as three nested `lax.while_loop`s (outer
homotopy steps, inner ascent steps, line-search steps). A host read of the
loop conditions per step would cost one device sync each, thousands per
attempt on a card; here the three loops are one flat sequence of line-search
"ticks" (each tick finishes an inner step or an outer step when the JAX
loops would), run in blocks of CLIPPER_BLOCK ticks with a device-side
`active` flag that freezes the state once the outer loop would have exited.
The host reads the flag once per block. The result equals the early-exit
loops' (tests/test_torch_place_recognition.py holds the two forms equal).
All math is f32 with TF32 off, as the JAX version casts its inputs to f32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# line-search ticks between two host reads of the stop flag
CLIPPER_BLOCK = 32


class ClipperParams(NamedTuple):
    sigma: float = 0.01
    epsilon: float = 0.06
    mindist: float = 0.0
    affinity_eps: float = 1e-4
    tol_u: float = 1e-8
    tol_F: float = 1e-9
    eps: float = 1e-9
    beta: float = 0.25
    maxiniters: int = 200
    maxoliters: int = 1000
    maxlsiters: int = 99


def affinity_matrix(d1: torch.Tensor, d2: torch.Tensor, mask: torch.Tensor,
                    params: ClipperParams) -> torch.Tensor:
    """Affinity M for the identity association set (a_i = (d1[i], d2[i])):
    M[i,j] = exp(-c^2 / (2 sigma^2)) if c = |l1 - l2| < epsilon else 0, zero
    diagonal, zero on masked rows/columns and below affinity_eps."""
    l1 = torch.linalg.norm(d1[:, None, :] - d1[None, :, :], dim=-1)
    l2 = torch.linalg.norm(d2[:, None, :] - d2[None, :, :], dim=-1)
    c = torch.abs(l1 - l2)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    m = torch.exp(-0.5 * c * c / (params.sigma ** 2))
    m = torch.where(c < params.epsilon, m, zero)
    if params.mindist > 0:
        m = torch.where((l1 < params.mindist) | (l2 < params.mindist), zero, m)
    m = torch.where(m > params.affinity_eps, m, zero)
    ok = mask[:, None] & mask[None, :]
    m = torch.where(ok, m, zero)
    return m * (1.0 - torch.eye(m.shape[0], dtype=m.dtype, device=m.device))


class _Ascent:
    """The ascent's operators on one affinity (clipper.cpp:172-310).

    C is the affinity's support and N = 1 - C - I its complement, so
    Cbu = (ones sum(u) - C u - u) = N u and gradF = u + M u - d N u. The JAX
    version forms Cbu as the f32 difference sum(u) - C u - u: on the members
    of a clique that is exactly 0 only when the sums round alike, and
    rounding noise (~1e-7) above eps = 1e-9 makes the homotopy weight d grow
    without bound. N u is a sum of exact zeros there, whatever the
    summation order (XLA:CPU, PyTorch CPU, cuBLAS); it is the same quantity
    in exact arithmetic. M and N are stacked so one product gives both."""

    def __init__(self, M: torch.Tensor, params: ClipperParams):
        n = M.shape[0]
        C = (M > 0).to(M.dtype)
        eye = torch.eye(n, dtype=M.dtype, device=M.device)
        self.n = n
        self.MN = torch.cat([M, 1.0 - C - eye])
        self.p = params

    def products(self, u):
        """(M u, N u)."""
        r = self.MN @ u
        return r[:self.n], r[self.n:]

    def grad(self, u, d, Mu, Nu):
        return u + Mu - d * Nu

    def deltad(self, u, Mu, Nu):
        """(mean |Mu_ / Cbu| over the active set, active-set size), with
        Mu_ = M u + u (the diagonal restored) and Cbu = N u."""
        eps = self.p.eps
        idx = (Nu > eps) & (u > eps)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        num = torch.where(idx, Mu + u, zero)
        den = torch.where(idx, Nu, torch.ones_like(Nu))
        cnt = idx.sum()
        return (torch.sum(torch.where(idx, torch.abs(num / den), zero))
                / torch.clamp(cnt, min=1)), cnt

    def start(self, u0):
        """Power-iteration rescale of u0 and the first homotopy weight."""
        Mu0, _ = self.products(u0)
        u = Mu0 + u0
        u = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
        Mu, Nu = self.products(u)
        eps = self.p.eps
        idx = (Nu > eps) & (u > eps)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        num = torch.where(idx, Mu + u, zero)
        den = torch.where(idx, Nu, torch.ones_like(Nu))
        cnt = idx.sum()
        d = torch.where(cnt > 0, torch.sum(torch.where(idx, num / den, zero))
                        / torch.clamp(cnt, min=1), zero)
        return u, d


def find_dense_clique(M: torch.Tensor, u0: torch.Tensor,
                      params: ClipperParams) -> torch.Tensor:
    """Projected gradient ascent with homotopy (clipper.cpp:172-310).

    Returns one packed [n + 2] tensor on M's device: [u, F, omega] with
    omega = round(F) (DSD_HEU). See the module docstring for the blocked
    form of the three loops."""
    p = params
    A = _Ascent(M, p)
    dev, f = M.device, M.dtype
    i32 = dict(dtype=torch.int32, device=dev)
    u, d = A.start(u0)
    g = A.grad(u, d, *A.products(u))
    F = torch.dot(u, g)
    # line-search state: the iterate it starts from is (u, g, F)
    alpha = torch.ones((), dtype=f, device=dev)
    unew, gnew, Fnew = u, g, F
    i = torch.zeros((), **i32)        # outer iterations finished
    j = torch.zeros((), **i32)        # inner iterations finished this outer
    k = torch.zeros((), **i32)        # line-search steps this inner
    active = torch.ones((), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=f, device=dev)
    ticks = 0
    # at most maxoliters * maxiniters * maxlsiters ticks; the flag stops it
    cap = p.maxoliters * p.maxiniters * p.maxlsiters
    while ticks < cap:
        for _ in range(CLIPPER_BLOCK):
            # ---- one line-search step from (u, g, F) with step alpha -----
            cand = torch.clamp(u + alpha * g, min=0.0)
            cand = cand / torch.clamp(torch.linalg.norm(cand), min=1e-30)
            gc = A.grad(cand, d, *A.products(cand))
            Fc = torch.dot(cand, gc)
            dec = (Fc - F) < -p.eps
            alpha_n = torch.where(dec, alpha * p.beta, alpha)
            unew_n = torch.where(dec, unew, cand)
            gnew_n = torch.where(dec, gnew, gc)
            Fnew_n = torch.where(dec, Fnew, Fc)
            k_n = k + 1
            ls_end = (~dec) | (k_n >= p.maxlsiters)
            # ---- the inner step ends with the line search ----------------
            deltau = torch.linalg.norm(unew_n - u)
            stop = (deltau < p.tol_u) | (torch.abs(Fnew_n - F) < p.tol_F)
            u_n = torch.where(ls_end, unew_n, u)
            g_n = torch.where(ls_end, gnew_n, g)
            F_n = torch.where(ls_end, Fnew_n, F)
            j_n = torch.where(ls_end, j + 1, j)
            inner_end = ls_end & (stop | (j_n >= p.maxiniters))
            # ---- the outer step ends with the inner loop -----------------
            Mu, Nu = A.products(u_n)
            dd, cnt = A.deltad(u_n, Mu, Nu)
            done = cnt == 0
            d_n = torch.where(inner_end & ~done, d + dd, d)
            i_n = torch.where(inner_end, i + 1, i)
            finished = inner_end & (done | (i_n >= p.maxoliters))
            # a new outer step re-linearizes at the homotopy weight d_n
            g_out = A.grad(u_n, d_n, Mu, Nu)
            g_n = torch.where(inner_end, g_out, g_n)
            F_n = torch.where(inner_end & ~finished, torch.dot(u_n, g_out),
                              F_n)
            j_n = torch.where(inner_end, torch.zeros_like(j_n), j_n)
            # a new line search starts from the new iterate
            alpha_n = torch.where(ls_end, one, alpha_n)
            unew_n = torch.where(ls_end, u_n, unew_n)
            gnew_n = torch.where(ls_end, g_n, gnew_n)
            Fnew_n = torch.where(ls_end, F_n, Fnew_n)
            k_n = torch.where(ls_end, torch.zeros_like(k_n), k_n)
            # ---- commit where the loops are still running ----------------
            u = torch.where(active, u_n, u)
            g = torch.where(active, g_n, g)
            F = torch.where(active, F_n, F)
            d = torch.where(active, d_n, d)
            alpha = torch.where(active, alpha_n, alpha)
            unew = torch.where(active, unew_n, unew)
            gnew = torch.where(active, gnew_n, gnew)
            Fnew = torch.where(active, Fnew_n, Fnew)
            i = torch.where(active, i_n, i)
            j = torch.where(active, j_n, j)
            k = torch.where(active, k_n, k)
            active = active & ~finished
            ticks += 1
        if not bool(active):
            break
    omega = torch.round(F)
    return torch.cat([u, F[None], omega[None]])


def select_inliers(u: np.ndarray, omega: int) -> np.ndarray:
    """DSD_HEU rounding: indices of the omega largest entries of u with u>0
    (utils::findIndicesOfkLargest)."""
    u = np.asarray(u)
    omega = int(max(0, min(omega, (u > 0).sum())))
    if omega == 0:
        return np.zeros((0,), np.int64)
    idx = np.argpartition(-u, omega - 1)[:omega]
    return idx[u[idx] > 0]


def dense_clique_inliers(d1: np.ndarray, d2: np.ndarray,
                         params: ClipperParams, seed: int = 0,
                         rounding: str = "dsd_heu",
                         device="cuda") -> np.ndarray:
    """Full pipeline on matched point pairs: affinity -> ascent -> rounding.
    Returns indices of the selected (inlier) associations.

    rounding: 'dsd_heu' (top-round(F) entries of u, the reference default),
    'nonzero' (all u > 0) or 'dsd' (the exact densest subgraph of the
    affinity graph on the support of u, clipper_alternates.dsd_round, on
    the host). The association count is padded to the JAX
    version's power-of-2 bucket (>= 64) so both ascend the same system;
    padding rows are masked out of the affinity and stay exactly 0."""
    m = len(d1)
    if m == 0:
        return np.zeros((0,), np.int64)
    cap = 1 << max(6, int(np.ceil(np.log2(m))))
    d1p = np.zeros((cap, np.shape(d1)[1]), np.float32)
    d2p = np.zeros((cap, np.shape(d2)[1]), np.float32)
    d1p[:m], d2p[:m] = d1, d2
    rng = np.random.default_rng(seed)
    u0 = np.zeros((cap,), np.float32)
    u0[:m] = rng.uniform(size=m).astype(np.float32)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mask = torch.as_tensor(np.arange(cap) < m, device=dev)
    M = affinity_matrix(torch.as_tensor(d1p, device=dev),
                        torch.as_tensor(d2p, device=dev), mask, params)
    packed = find_dense_clique(M, torch.as_tensor(u0, device=dev),
                               params).cpu().numpy()
    u, omega = packed[:m], int(packed[-1])
    if rounding == "nonzero":
        return np.flatnonzero(u > 0.0)
    if rounding == "dsd":
        from .clipper_alternates import dsd_round
        return dsd_round(M[:m, :m].cpu().numpy(), u)
    return select_inliers(u, omega)
