"""PyTorch port vs JAX: SE(3), closed-form Jacobians and the analytic factor
linearizations (port on the CPU).

Same inputs from a numpy seed to both packages; float32 throughout, so
values agree to 1e-5 (different op fusion and rounding order). The
port's analytic Jacobians are also held against torch.func.jacrev of its own
residuals, evaluated in float64 at a 1e-9 tangent (at exactly zero the
untaken small-angle branches divide 0 by 0, and reverse mode carries that
NaN through torch.where); tolerance 1e-3 for the f32 analytic forms.
"""
import numpy as np
import pytest
import torch

from slide_slam_tpu.geometry import jacobians as jjac
from slide_slam_tpu.geometry import se3 as jse3
from slide_slam_tpu.factorgraph import solver as jsolver
from slide_slam_tpu_torch.factorgraph import residuals as tres
from slide_slam_tpu_torch.factorgraph import solver as tsolver
from slide_slam_tpu_torch.geometry import jacobians as tjac
from slide_slam_tpu_torch.geometry import se3 as tse3

TOL = 1e-5


def _poses(rng, n, trans_scale=5.0):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.where(q[:, :1] < 0, -1.0, 1.0)
    t = rng.normal(0, trans_scale, (n, 3))
    return np.concatenate([q, t], 1).astype(np.float32)


def _tangents(rng, n, scale=0.5):
    xi = rng.normal(0, scale, (n, 6))
    xi[:4] *= 1e-5           # exercise the small-angle branches
    return xi.astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


T = torch.as_tensor


def D(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("name", ["compose", "between", "local"])
def test_binary_ops(name):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    _close(getattr(tse3, name)(T(a), T(b)), getattr(jse3, name)(a, b))


@pytest.mark.parametrize("name", ["inverse", "log", "matrix", "yaw_of"])
def test_unary_ops(name):
    rng = np.random.default_rng(1)
    p = _poses(rng, 64)
    _close(getattr(tse3, name)(T(p)), getattr(jse3, name)(p))


def test_exp_retract_apply():
    rng = np.random.default_rng(2)
    p, xi = _poses(rng, 64), _tangents(rng, 64)
    pts = rng.normal(0, 10, (64, 3)).astype(np.float32)
    _close(tse3.exp(T(xi)), jse3.exp(xi))
    _close(tse3.retract(T(p), T(xi)), jse3.retract(p, xi))
    _close(tse3.apply(T(p), T(pts)), jse3.apply(p, pts), 1e-4)
    _close(tse3.rotate(T(p), T(pts)), jse3.rotate(p, pts), 1e-4)
    q = _poses(rng, 8)
    _close(tse3.from_matrix(tse3.matrix(T(q))), jse3.from_matrix(jse3.matrix(q)))
    _close(tse3.from_quat_trans(T(q[:, :4]), T(q[:, 4:])),
           jse3.from_quat_trans(q[:, :4], q[:, 4:]))


@pytest.mark.parametrize("name", ["se3_left_jacobian_inv",
                                  "se3_right_jacobian_inv"])
def test_se3_jacobians(name):
    xi = _tangents(np.random.default_rng(3), 64)
    _close(getattr(tjac, name)(T(xi)), getattr(jjac, name)(xi), 1e-4)


def test_so3_jacobians_and_adjoint():
    rng = np.random.default_rng(4)
    om = _tangents(rng, 64)[:, :3]
    _close(tjac.so3_left_jacobian(T(om)), jjac.so3_left_jacobian(om))
    _close(tjac.so3_left_jacobian_inv(T(om)), jjac.so3_left_jacobian_inv(om))
    p = _poses(rng, 64)
    _close(tjac.se3_adjoint(T(p)), jjac.se3_adjoint(p), 1e-4)


def _lin_inputs(rng, n=32):
    p = _poses(rng, n)
    # relative-measurement inputs near their solution, like a real graph
    q = jse3.retract(p, _tangents(rng, n, 0.1))
    rel = np.asarray(jse3.retract(jse3.between(p, q), _tangents(rng, n, 0.05)))
    sig = rng.uniform(0.05, 0.5, (n, 6)).astype(np.float32)
    return p, np.asarray(q), rel, sig


def test_between_lin_vs_jax_and_jacrev():
    rng = np.random.default_rng(5)
    p, q, rel, sig = _lin_inputs(rng)
    r_t, Ji_t, Jj_t = tsolver._between_lin(T(p), T(q), T(rel), T(sig))
    import jax
    r_j, Ji_j, Jj_j = jax.vmap(jsolver._between_lin)(p, q, rel, sig)
    for t, j in ((r_t, r_j), (Ji_t, Ji_j), (Jj_t, Jj_j)):
        _close(t, j, 1e-3)

    def f(xi, xj, k):
        return tres.between_residual(
            tse3.retract(D(p[k]), xi), tse3.retract(D(q[k]), xj),
            D(rel[k])) / D(sig[k])

    z = torch.full((6,), 1e-9, dtype=torch.float64)
    for k in range(4):
        Ji, Jj = torch.func.jacrev(lambda a, b: f(a, b, k), argnums=(0, 1))(z, z)
        np.testing.assert_allclose(Ji_t[k].numpy(), Ji.numpy(), atol=1e-3)
        np.testing.assert_allclose(Jj_t[k].numpy(), Jj.numpy(), atol=1e-3)


def test_cylinder_lin_vs_jax_and_jacrev():
    rng = np.random.default_rng(6)
    n = 32
    p = _poses(rng, n)
    meas = np.concatenate([rng.normal(0, 0.1, (n, 3)) + [0, 0, 1],
                           rng.normal(0, 5, (n, 3)),
                           rng.uniform(0.1, 0.5, (n, 1))], 1).astype(np.float32)
    lm = np.concatenate([np.asarray(jse3.rotate(p, meas[:, :3])),
                         np.asarray(jse3.apply(p, meas[:, 3:6])),
                         meas[:, 6:]], 1) + rng.normal(0, 0.05, (n, 7))
    lm = lm.astype(np.float32)
    import jax
    r_j, Jp_j, Jl_j = jax.vmap(jsolver._cyl_lin, in_axes=(0, 0, 0, None))(
        p, lm, meas, 10.0)
    r_t, Jp_t, Jl_t = tsolver._cyl_lin(T(p), T(lm), T(meas), 10.0)
    for t, j in ((r_t, r_j), (Jp_t, Jp_j), (Jl_t, Jl_j)):
        _close(t, j, 1e-4)
    for k in range(4):
        f = lambda xi, dl: tres.cylinder_residual(
            tse3.retract(D(p[k]), xi), tres.cylinder_retract(D(lm[k]), dl),
            D(meas[k])) / 10.0
        Jp, Jl = torch.func.jacrev(f, argnums=(0, 1))(
            torch.full((6,), 1e-9, dtype=torch.float64),
            torch.zeros(7, dtype=torch.float64))
        np.testing.assert_allclose(Jp_t[k].numpy(), Jp.numpy(), atol=1e-3)
        np.testing.assert_allclose(Jl_t[k].numpy(), Jl.numpy(), atol=1e-3)


def test_from_xyz_yaw_matches_jax():
    """Numbers and [N] tensors against the JAX package's from_xyz_yaw (f32,
    to 1e-5) and the port's numpy se3np copy (to 1e-6: torch's and numpy's
    f32 cos / sin differ in the last bit)."""
    from slide_slam_tpu_torch.geometry import se3np
    rng = np.random.default_rng(5)
    x, y, z = rng.normal(0, 10, (3, 8)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 8).astype(np.float32)
    got = tse3.from_xyz_yaw(*(torch.as_tensor(v) for v in (x, y, z, yaw)))
    assert got.shape == (8, 7) and got.dtype == torch.float32
    _close(got, jse3.from_xyz_yaw(x, y, z, yaw))
    np.testing.assert_allclose(got.numpy(), se3np.from_xyz_yaw(x, y, z, yaw),
                               rtol=0, atol=1e-6)
    one = tse3.from_xyz_yaw(1.0, -2.0, 0.5, 0.3)
    assert one.shape == (7,)
    _close(one, jse3.from_xyz_yaw(1.0, -2.0, 0.5, 0.3))


def test_cylinder_project_matches_jax():
    """Body-frame cylinders to the map frame: root, ray and radius as the
    JAX package's cylinder_project, and the residual of a cylinder at its
    own projection is zero."""
    from slide_slam_tpu.factorgraph import residuals as jres
    rng = np.random.default_rng(6)
    pose = _poses(rng, 6)
    root = rng.normal(0, 3, (6, 3)).astype(np.float32)
    ray = rng.normal(size=(6, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    radius = rng.uniform(0.1, 0.5, 6).astype(np.float32)
    got = tres.cylinder_project(*(torch.as_tensor(v)
                                  for v in (root, ray, radius, pose)))
    want = [jres.cylinder_project(root[i], ray[i], radius[i], pose[i])
            for i in range(6)]
    for k in range(3):
        _close(got[k], np.stack([np.asarray(w[k]) for w in want]))
    lm = torch.cat([got[1], got[0], got[2][:, None]], -1)
    meas = torch.as_tensor(np.concatenate([ray, root, radius[:, None]], 1))
    r = tres.cylinder_residual(torch.as_tensor(pose), lm, meas)
    assert float(r.abs().max()) == 0.0
