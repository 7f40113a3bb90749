"""CLIPPER solver alternates: exact max clique, exact densest subgraph, SDR
(PyTorch twin of slide_slam_tpu/place_recognition/clipper_alternates.py).

The reference's vendored CLIPPER offers three alternates to the
projected-gradient dense-clique relaxation (clipper.py here):

* ``solve_as_maximum_clique``: the maximum clique of the consistency
  graph's constraint matrix as an unweighted graph (clipper.cpp:82-97,
  maxclique.cpp): the native C++ branch and bound of native.py, with a
  pure-Python fallback where g++ is missing;
* ``densest_subgraph``: the exact densest subgraph by Goldberg's flow
  algorithm (dsd.cpp:166-311), standalone and as CLIPPER's
  ``Rounding::DSD`` (clipper.cpp:293-300, `dsd_round`);
* ``solve_as_msrc_sdr``: the MSRC semidefinite relaxation (sdp.cpp:87-160),
  max <M, X> s.t. tr(X) = 1, X PSD, X_ij = 0 where C_ij = 0 and X_ij >= 0
  elsewhere, by ADMM between the spectraplex (eigh and a simplex
  projection, plain PyTorch on the device) and the entrywise cone;
  inliers are the entries of the top eigenvector above half its largest
  magnitude (sdp.cpp:130-141).

The clique and flow searches run on the host, as in the JAX package. The
SDR runs on `device` (the card unless the caller asks for the CPU). Its
eigenvectors' signs and the order of equal eigenvalues differ between
LAPACK builds and the card, so results are compared as node sets.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from .clipper import ClipperParams, affinity_matrix

# ---------------------------------------------------------------------------
# Pure-Python fallbacks (also the cross-check oracle in tests)
# ---------------------------------------------------------------------------

def _py_max_clique(adjacency: np.ndarray) -> np.ndarray:
    """Exact max clique by branch & bound on neighbour sets (fallback)."""
    A = np.asarray(adjacency) != 0
    n = A.shape[0]
    nbrs = [frozenset(np.flatnonzero(A[i] | A[:, i])) - {i} for i in range(n)]
    best: list = []

    def expand(clique, cand):
        nonlocal best
        if len(clique) + len(cand) <= len(best):
            return
        if not cand:
            if len(clique) > len(best):
                best = list(clique)
            return
        # pivot on the candidate with most candidate-neighbours
        order = sorted(cand, key=lambda v: -len(nbrs[v] & cand))
        cand = set(cand)
        for v in order:
            if len(clique) + len(cand) <= len(best):
                return
            if v not in cand:
                continue
            expand(clique + [v], cand & nbrs[v])
            cand.discard(v)

    expand([], frozenset(range(n)))
    return np.sort(np.asarray(best, np.int32))


def _py_densest_subgraph(affinity: np.ndarray) -> Tuple[np.ndarray, float]:
    """Exact densest subgraph by brute force (fallback; exponential — only
    usable for small n, which is what tests exercise)."""
    A = np.maximum(affinity, affinity.T)
    n = A.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32), 0.0
    if n > 20:
        raise RuntimeError("python densest-subgraph fallback limited to n<=20")
    best_nodes, best_d = np.asarray([0], np.int32), 0.0
    for mask in range(1, 1 << n):
        idx = np.asarray([i for i in range(n) if (mask >> i) & 1])
        w = np.triu(A[np.ix_(idx, idx)], k=1).sum()
        d = w / len(idx)
        if d > best_d + 1e-15:
            best_d, best_nodes = d, idx.astype(np.int32)
    return best_nodes, float(best_d)


def max_clique(adjacency: np.ndarray, method: str = "exact",
               time_limit_s: float = 3600.0) -> np.ndarray:
    """Max clique (sorted vertex indices); native solver when available."""
    if native.available():
        return native.max_clique(adjacency, method=method,
                                 time_limit_s=time_limit_s)
    if method != "exact":
        raise RuntimeError("python fallback supports method='exact' only")
    return _py_max_clique(adjacency)


def densest_subgraph(affinity: np.ndarray,
                     subset: Optional[np.ndarray] = None):
    """Exact densest subgraph (nodes, density); native when available."""
    if native.available():
        return native.densest_subgraph(affinity, subset)
    A = np.asarray(affinity, np.float64)
    if subset is not None:
        keep = np.zeros(A.shape[0], bool)
        keep[np.asarray(subset, np.int64)] = True
        A = np.where(np.outer(keep, keep), A, 0.0)
    return _py_densest_subgraph(A)


# ---------------------------------------------------------------------------
# MSRC-SDR on the device
# ---------------------------------------------------------------------------

def _project_spectraplex(Y: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto {X PSD, tr(X) = 1}: eigendecompose and
    project the eigenvalues onto the probability simplex."""
    Y = 0.5 * (Y + Y.T)
    evals, evecs = torch.linalg.eigh(Y)
    n = evals.shape[0]
    u = torch.flip(torch.sort(evals).values, dims=(0,))
    css = torch.cumsum(u, dim=0) - 1.0
    ks = torch.arange(1, n + 1, dtype=Y.dtype, device=Y.device)
    cond = u - css / ks > 0
    rho = torch.max(torch.where(cond, torch.arange(1, n + 1, device=Y.device),
                                0))
    theta = css[rho - 1] / rho.to(Y.dtype)
    lam = torch.clamp(evals - theta, min=0.0)
    return (evecs * lam[None, :]) @ evecs.T


def _sdr_admm(M: torch.Tensor, support: torch.Tensor, iters: int = 300):
    """ADMM for max <M, X> s.t. X in the spectraplex, X (1 - support) = 0,
    X support >= 0. Returns (X, top eigenvector scaled by sqrt of its
    eigenvalue)."""
    n = M.shape[0]
    rho = 1.0
    X = torch.eye(n, dtype=M.dtype, device=M.device) / n
    Z = X
    U = torch.zeros_like(X)
    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    for _ in range(iters):
        X = _project_spectraplex(Z - U + M / rho)
        Z = torch.where(support, torch.clamp(X + U, min=0.0), zero)
        U = U + X - Z
    evals, evecs = torch.linalg.eigh(0.5 * (Z + Z.T))
    v = evecs[:, -1] * torch.sqrt(torch.clamp(evals[-1], min=0.0))
    return Z, v


def sdr_nodes(M: np.ndarray, support: Optional[np.ndarray] = None,
              iters: int = 300, device="cuda") -> np.ndarray:
    """Solve the MSRC SDR on `device` and extract inlier nodes: |v_i| >
    max|v| / 2 of the dominant eigenvector (sdp.cpp:134-141)."""
    M = np.asarray(M, np.float32)
    n = M.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    if support is None:
        # the constraint matrix: the support of M plus the diagonal, as
        # CLIPPER::getConstraintMatrix builds C from M (clipper.cpp:63-64)
        support = (M > 0) | np.eye(n, dtype=bool)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, v = _sdr_admm(torch.as_tensor(M, device=dev),
                     torch.as_tensor(np.asarray(support), device=dev),
                     iters=iters)
    v = v.cpu().numpy()
    thr = np.abs(v).max() / 2.0
    return np.flatnonzero(np.abs(v) > thr)


# ---------------------------------------------------------------------------
# CLIPPER-level dispatch on matched point pairs (the surface of
# clipper.dense_clique_inliers)
# ---------------------------------------------------------------------------

def _pair_affinity(d1: np.ndarray, d2: np.ndarray, params: ClipperParams,
                   device="cuda") -> np.ndarray:
    dev = torch.device(device)
    mask = torch.ones((len(d1),), dtype=torch.bool, device=dev)
    M = affinity_matrix(torch.as_tensor(np.asarray(d1, np.float32),
                                        device=dev),
                        torch.as_tensor(np.asarray(d2, np.float32),
                                        device=dev), mask, params)
    return M.cpu().numpy()


def solve_as_maximum_clique(d1: np.ndarray, d2: np.ndarray,
                            params: ClipperParams, method: str = "exact",
                            time_limit_s: float = 3600.0,
                            device="cuda") -> np.ndarray:
    """Inlier associations by max clique of the consistency graph
    (CLIPPER::solveAsMaximumClique, clipper.cpp:82-97)."""
    if len(d1) == 0:
        return np.zeros((0,), np.int64)
    M = _pair_affinity(d1, d2, params, device)
    return max_clique(M > 0, method=method,
                      time_limit_s=time_limit_s).astype(np.int64)


def solve_as_msrc_sdr(d1: np.ndarray, d2: np.ndarray, params: ClipperParams,
                      iters: int = 300, device="cuda") -> np.ndarray:
    """Inlier associations by the MSRC semidefinite relaxation
    (CLIPPER::solveAsMSRCSDR, clipper.cpp:101-113)."""
    if len(d1) == 0:
        return np.zeros((0,), np.int64)
    M = _pair_affinity(d1, d2, params, device)
    return sdr_nodes(M, iters=iters, device=device).astype(np.int64)


def dsd_round(M: np.ndarray, u: np.ndarray) -> np.ndarray:
    """CLIPPER ``Rounding::DSD``: densest subgraph of the affinity graph
    restricted to the support of the ascent vector u (clipper.cpp:293-300)."""
    S = np.flatnonzero(np.asarray(u) > 0.0)
    if len(S) == 0:
        return np.zeros((0,), np.int64)
    nodes, _ = densest_subgraph(np.asarray(M, np.float64), S)
    return nodes.astype(np.int64)
