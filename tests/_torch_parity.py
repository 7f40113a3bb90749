"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

One small configuration for both packages, built from the same numbers, so
XLA:CPU compiles each JAX program once per test module, and helpers that
carry data between the two packages as numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu import config as jconfig
from slide_slam_tpu.factorgraph.graph import GraphState as JGraphState
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.io import synthetic

# small capacities: one robot, 32 pose slots
SMALL_CAPACITY = dict(
    max_poses_per_robot=32, max_cylinders=128, max_cuboids=64, max_points=32,
    max_scan_objects=32, max_cylinder_factors=512, max_cuboid_factors=128,
    max_point_factors=64, max_between_factors=8)


def small_configs(**capacity):
    """(JAX SlamConfig, port SlamConfig) with the same small capacities."""
    cap = dict(SMALL_CAPACITY, **capacity)
    kw = dict(number_of_robots=1, turn_off_intra_loop_closure=True)
    return (jconfig.SlamConfig(capacity=jconfig.CapacityConfig(**cap), **kw),
            tconfig.SlamConfig(capacity=tconfig.CapacityConfig(**cap), **kw))


def jax_state_numpy(state) -> dict:
    """JAX GraphState -> dict of numpy arrays (the port's convert format)."""
    return {k: np.asarray(getattr(state, k)) for k in JGraphState._fields}


def jax_state_from_numpy(d: dict) -> JGraphState:
    return JGraphState(**{k: jnp.asarray(d[k]) for k in JGraphState._fields})


def jax_ransac_draws(n_rows: int, n_hypotheses: int) -> np.ndarray:
    """The draws slide_slam_tpu's fit_plane_ransac makes with seed 0."""
    return np.array(jax.random.randint(
        jax.random.PRNGKey(0), (n_rows, n_hypotheses, 3), 0,
        jnp.iinfo(jnp.int32).max))


def forest_scene(n_trees=14, n_steps=12, seed=4):
    """The raw-LiDAR test scene: a small forest without cars, a one-row
    lawnmower path and its drifting odometry (make_log, sigma 0.01)."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_forest_world(rng, n_trees=n_trees, n_poles=0,
                                        n_cars=0, extent=14.0)
    world.ell_pos = world.ell_pos[:0]
    traj = synthetic.lawnmower_trajectory(n_steps, extent=10.0, rows=1,
                                          step=1.8)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.01)
    odom = np.stack([k.odom_pose for k in log.keyframes])
    return world, traj, odom


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's port code on one intra-op thread. The suite runs
    several pytest workers on the same cores; PyTorch's OpenMP pool in each
    of them spin-waits against the others and small ops slow down many
    fold. One thread keeps the mission tests' time what it is alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
