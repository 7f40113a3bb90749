"""Test data and the keyframe loop of the indoor two-robot RGBD team.

Used by chip_smoke.py (phases slice:indoor_rgbd_team and
card_vs_cpu:indoor_rgbd) and by tests/test_torch_indoor_team.py, which
drives the same loop through both packages. Numpy only: the loop takes each package's
objects (frontend, nodes, measurer, checkpoint functions) from its caller.

The scene is the indoor world of tests/test_indoor_rgbd.py (14 chairs and 8
tables in +-8 m, its capacities). Robot 0 drives the test's lawnmower path
with a tag36h11 tag on its back; robot 1 follows the same path 2 m behind
and looks at that tag with a forward camera. Each robot's RGBD frame is a
640 x 480 ray cast of the world's boxes from its true pose (SMALL: 160 x 120
with the same field of view, for the CPU tests): depth in uint16
millimetres, and an RGB image whose red channel carries each object's index
(1 + index; 0 for the floor and for rays that hit nothing), which the
scripted detector reads back. The nearest box decides what a pixel shows,
and an object's pixels take the depth of its centre: with the boxes' own
surfaces every single-frame centroid lies half an object's depth toward
the camera (0.25 m for the chairs, 0.67 m for the tables, medians over
this path), and the landmark gate taken from tests/test_indoor_rgbd.py,
whose measurements are true centroids, fails (median landmark error
0.33 / 0.31 m per robot against < 0.25 m). The detector returns masks
for the chairs and bare boxes for the tables that the image border does not
cut, plus one detection of a class outside the queries and one below the
confidence threshold. Robot 1's grayscale tag image is the tag warped into
a plain scene by its homography, as tests/test_apriltag.py renders it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np


class Camera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def matrix(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                         [0, 0, 1.0]])


FULL = Camera(640, 480, 525.0, 525.0, 319.5, 239.5)
# the same field of view at a quarter of the width (the CPU tests)
SMALL = Camera(160, 120, 131.25, 131.25, 79.5, 59.5)
DEPTH_SCALE = 1e-3              # uint16 millimetres
N_KEYFRAMES = 50
FOLLOW_M = 2.0                  # robot 1 drives this far behind robot 0
EXCHANGE_EVERY = 5              # keyframes between database exchanges
MIN_DETECTION_SHARE = 5e-4     # the scripted detector's smallest object
#                                 (150 px of 640 x 480)
TAG_ID = 7
TAG_SIZE_M = 0.3                # black square's side
TAG_MAX_RANGE_M = 4.0
TAG_EVERY = 4                   # robot 1's tag camera: every 4th keyframe
#                                 (relative factors fit the 16 between slots)
# camera on each robot: 0.2 m ahead of the body origin, 0.1 m above it,
# level, looking forward (camera z = body x, x = -body y, y = -body z)
R_BODY_CAM = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
CAM_XYZ = (0.2, 0.0, 0.1)
# robot 0's tag: 0.3 m behind its body origin at the camera's height, its
# face looking backward (tag z = body x: a camera behind sees it head on)
# and tilted up (a frontal view leaves the homography's tilt ill-determined:
# a one-pixel corner error gave 5.5 deg of rotation error head on, <= 0.65
# deg at 30 deg over the 44 sightings of this path)
TAG_XYZ = (-0.3, 0.0, 0.1)
TAG_PITCH_DEG = 30.0            # the tag's face tilted up by this much
TAG_CORNERS = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])


def class_yaml(synthetic) -> dict:
    """open_vocab_cls_all.yaml rows for the two indoor classes."""
    return {
        "chair": {"id": int(synthetic.CHAIR), "length_cutoff": [0.2, 1.5],
                  "height_cutoff": [0.2, 1.5],
                  "class_assignment_thresh": 0.75},
        "table": {"id": int(synthetic.TABLE), "length_cutoff": [0.5, 5.0],
                  "height_cutoff": [0.2, 2.0],
                  "class_assignment_thresh": 1.5},
    }


def indoor_world(synthetic, rng, n_chairs=14, n_tables=8, extent=8.0):
    """The world of tests/test_indoor_rgbd.py:12-33."""
    n = n_chairs + n_tables
    pos = np.concatenate([rng.uniform(-extent, extent, (n, 2)),
                          rng.uniform(0.3, 0.8, (n, 1))], axis=1)
    scale = np.concatenate([
        rng.uniform(0.4, 0.7, (n_chairs, 3)),
        rng.uniform(0.9, 1.6, (n_tables, 3))])
    label = np.concatenate([
        np.full(n_chairs, synthetic.CHAIR),
        np.full(n_tables, synthetic.TABLE)])
    z3, z0 = np.zeros((0, 3), np.float32), np.zeros((0,), np.int32)
    return synthetic.World(
        cyl_root=z3, cyl_ray=z3, cyl_radius=np.zeros((0,), np.float32),
        cyl_label=z0, cub_pose=np.zeros((0, 7), np.float32), cub_scale=z3,
        cub_label=z0, ell_pos=pos.astype(np.float32),
        ell_scale=scale.astype(np.float32), ell_label=label.astype(np.int32))


def indoor_cfg(config):
    """The capacities of tests/test_indoor_rgbd.py:36-45."""
    return config.SlamConfig(
        number_of_robots=2, ellipsoid_match_thresh=0.75,
        capacity=config.CapacityConfig(
            max_poses_per_robot=128, max_cylinders=32, max_cuboids=32,
            max_points=128, max_scan_objects=32, max_cylinder_factors=64,
            max_cuboid_factors=64, max_point_factors=2048,
            max_between_factors=16))


def follower_trajectory(se3np, traj, step=0.8, behind=FOLLOW_M):
    """The leader's path, `behind` metres back along it: within a row the
    follower sits between two of the leader's poses; before the start it
    backs out along the first heading; when the leader stops, it stops."""
    moving = len(traj)
    while moving > 1 and np.array_equal(traj[moving - 1], traj[moving - 2]):
        moving -= 1
    lag = behind / step
    out = []
    for i in range(len(traj)):
        p = min(i, moving - 1) - lag
        lo = int(np.floor(p))
        base = traj[max(lo, 0)]
        ahead = (p - lo) * step if lo >= 0 else p * step
        yaw = se3np.yaw_of(base)
        xyz = base[4:7] + ahead * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        out.append(se3np.from_xyz_yaw(*xyz, yaw))
    return np.stack(out).astype(np.float32)


def pose_from(se3np, R, xyz):
    return np.concatenate([se3np.quat_from_matrix(R), xyz]).astype(np.float32)


@dataclass
class Scene:
    world: object
    trajs: List[np.ndarray]          # true poses, one [N, 7] per robot
    odom: List[np.ndarray]           # drifting odometry, one [N, 7] per robot
    stamps: np.ndarray               # [N], shared by both robots
    bot_to_cam: np.ndarray           # [7]
    bot_to_tag: np.ndarray           # [7] on robot 0
    cam: Camera = FULL
    frames: List[List[tuple]] = field(default_factory=list)   # (rgb, depth)
    tag_images: List[np.ndarray] = field(default_factory=list)
    tag_truth: List[Optional[np.ndarray]] = field(default_factory=list)


def make_scene(synthetic, se3np, n_keyframes=N_KEYFRAMES, seed=9,
               cam: Camera = FULL) -> Scene:
    """World, both trajectories and the drifting odometry of make_log
    (odom_drift_sigma 0.008, as tests/test_indoor_rgbd.py:51-53)."""
    world = indoor_world(synthetic, np.random.default_rng(seed))
    traj0 = synthetic.lawnmower_trajectory(n_keyframes, extent=7.0, rows=3,
                                           step=0.8)
    trajs = [traj0, follower_trajectory(se3np, traj0)]
    logs = [synthetic.make_log(world, t, robot_id=r, seed=2,
                               odom_drift_sigma=0.008, pos_noise=0.02,
                               dropout=0.1, max_range=6.0)
            for r, t in enumerate(trajs)]
    return Scene(
        world=world, trajs=trajs,
        odom=[np.stack([kf.odom_pose for kf in log.keyframes])
              for log in logs],
        stamps=np.array([kf.stamp for kf in logs[0].keyframes]),
        bot_to_cam=pose_from(se3np, R_BODY_CAM, CAM_XYZ),
        bot_to_tag=pose_from(se3np, R_BODY_CAM @ _rot_x(TAG_PITCH_DEG),
                             TAG_XYZ), cam=cam)


def _rot_x(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


# ---------------------------------------------------------------------------
# Rendering (test data)
# ---------------------------------------------------------------------------

def _camera_rays(cam: Camera):
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    return np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                     np.ones_like(u)], axis=-1)


def _box_pixels(cam: Camera, R, o, c, h):
    """The image rows and columns a box can cover (its corners' projected
    bounds), the whole image when a corner is behind the camera; None when
    it covers none."""
    corners = c + h * np.array([[sx, sy, sz] for sx in (-1, 1)
                                for sy in (-1, 1) for sz in (-1, 1)])
    pc = (corners - o) @ R
    if pc[:, 2].max() <= 1e-3:
        return None
    if pc[:, 2].min() <= 1e-3:
        return slice(0, cam.height), slice(0, cam.width)
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    u0 = max(int(np.floor(u.min())), 0)
    u1 = min(int(np.ceil(u.max())) + 1, cam.width)
    v0 = max(int(np.floor(v.min())), 0)
    v1 = min(int(np.ceil(v.max())) + 1, cam.height)
    if u0 >= u1 or v0 >= v1:
        return None
    return slice(v0, v1), slice(u0, u1)


def render_frame(se3np, world, cam_pose7, cam: Camera = FULL,
                 max_range=12.0):
    """Ray cast of the world's axis-aligned boxes and the floor (z = 0) from
    a camera pose: (rgb [H, W, 3] uint8, depth [H, W] uint16 mm). A ray's
    parameter along (x/z, y/z, 1) is the camera-frame depth. The nearest
    box decides which object a pixel shows; the object's pixels take the
    depth of its centre (a camera-facing cut through the box)."""
    R = se3np.quat_to_matrix(np.asarray(cam_pose7[:4], np.float64))
    o = np.asarray(cam_pose7[4:7], np.float64)
    d = _camera_rays(cam) @ R.T                            # [H, W, 3] world
    down = d[..., 2] < -1e-9
    best_t = np.where(down, -o[2] / np.where(down, d[..., 2], -1.0), np.inf)
    best_id = np.full(d.shape[:2], -1, np.int32)           # floor or nothing
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(len(world.ell_pos)):
            c = world.ell_pos[k].astype(np.float64)
            h = 0.5 * world.ell_scale[k].astype(np.float64)
            if np.linalg.norm(c - o) > max_range:
                continue
            block = _box_pixels(cam, R, o, c, h)
            if block is None:
                continue
            db = d[block]
            t1 = (c - h - o) / db
            t2 = (c + h - o) / db
            tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
            tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
            hit = (tmax >= tmin) & (tmin > 1e-6) & (tmin < best_t[block])
            best_t[block] = np.where(hit, tmin, best_t[block])
            best_id[block] = np.where(hit, k, best_id[block])
    # an object's pixels lie at its centre's depth (see the module notes)
    centre_z = (world.ell_pos.astype(np.float64) - o) @ R[:, 2]
    best_t = np.where(best_id >= 0, centre_z[best_id], best_t)
    depth = np.where(np.isfinite(best_t) & (best_t < 65.0),
                     np.round(best_t / DEPTH_SCALE), 0).astype(np.uint16)
    rgb = np.zeros(d.shape[:2] + (3,), np.uint8)
    obj = best_id >= 0
    rgb[..., 0] = best_id + 1
    rgb[..., 1] = np.where(obj, 200, 90)
    rgb[..., 2] = np.where(obj, 100, 90)
    rgb[~np.isfinite(best_t)] = 0
    return rgb, depth


def scripted_detector(open_vocab, world, synthetic):
    """detect_fn(rgb) -> [Detection] of a package's open_vocab module: a
    mask for each chair and a bare box for each table of at least
    MIN_DETECTION_SHARE of the image that the image border does not cut (chairs
    first, then by object index), then a
    class outside the queries and a table below the confidence threshold."""
    chair = int(synthetic.CHAIR)

    def detect(rgb):
        H, W = rgb.shape[:2]
        ids = rgb[..., 0].astype(np.int32) - 1
        ids[rgb[..., 1] != 200] = -1
        found = np.unique(ids[ids >= 0])
        masks, boxes = [], []
        for k in found:
            m = ids == k
            if m.sum() < MIN_DETECTION_SHARE * H * W:
                continue
            ys, xs = np.nonzero(m)
            if (xs.min() == 0 or ys.min() == 0 or xs.max() == W - 1
                    or ys.max() == H - 1):
                continue                      # cut by the image border
            box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                           float)
            if int(world.ell_label[k]) == chair:
                masks.append(open_vocab.Detection("chair", 0.9, box, mask=m))
            else:
                boxes.append(open_vocab.Detection("table", 0.8, box))
        extra = [open_vocab.Detection(
                     "person", 0.95, np.array([0.45 * W, 0.4 * H,
                                               0.55 * W, 0.55 * H])),
                 open_vocab.Detection(
                     "table", 0.2, np.array([-4.5, 10.7, 60.2, 80.9]))]
        return masks + boxes + extra

    return detect


def tag_homography(cam_T_tag: np.ndarray, cam: Camera) -> np.ndarray:
    """Tag coords (+-1 at the black square's corners) -> image px."""
    K = cam.matrix()
    R, t = cam_T_tag[:3, :3], cam_T_tag[:3, 3]
    s = TAG_SIZE_M / 2
    return K @ np.stack([R[:, 0] * s, R[:, 1] * s, t], axis=1)


def render_tag_image(family, H_px, cam: Camera, bg=200.0):
    """The tag warped into a plain grayscale scene (nearest texel), as
    tests/test_apriltag.py:55-78 renders it."""
    tag = family.render(TAG_ID, cell_px=16).astype(np.float32)
    t = family.total_cells
    span = t - 2
    img = np.full((cam.height, cam.width), bg, np.float32)
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=0)
    tp = np.linalg.inv(H_px) @ pts
    tx, ty = tp[0] / tp[2], tp[1] / tp[2]
    px = (tx + (t / span)) / (2 * t / span) * tag.shape[1]
    py = (ty + (t / span)) / (2 * t / span) * tag.shape[0]
    inside = ((px >= 0) & (px < tag.shape[1]) & (py >= 0)
              & (py < tag.shape[0]) & (tp[2] > 0))
    pxc = np.clip(px.astype(int), 0, tag.shape[1] - 1)
    pyc = np.clip(py.astype(int), 0, tag.shape[0] - 1)
    flat = img.ravel()
    flat[inside] = tag[pyc, pxc][inside]
    return img.reshape(cam.height, cam.width)


def tag_view(se3np, scene: Scene, i: int) -> Optional[np.ndarray]:
    """Robot 1's true camera -> tag [4, 4] at keyframe i when the whole tag
    (white border included) is in its image, in front, within
    TAG_MAX_RANGE_M and facing it; else None."""
    world_T_cam = se3np.compose(scene.trajs[1][i], scene.bot_to_cam)
    world_T_tag = se3np.compose(scene.trajs[0][i], scene.bot_to_tag)
    T = se3np.matrix(se3np.between(world_T_cam, world_T_tag))
    T = T.astype(np.float64)
    t = T[:3, 3]
    if not (0.3 < t[2] and np.linalg.norm(t) < TAG_MAX_RANGE_M):
        return None
    if T[:3, 2] @ t / np.linalg.norm(t) < 0.5:     # tag z away from camera
        return None
    cam = scene.cam
    H = tag_homography(T, cam)
    border = 1.25                                   # white border at 10/8
    p = np.concatenate([TAG_CORNERS * border, np.ones((4, 1))], 1) @ H.T
    uv = p[:, :2] / p[:, 2:3]
    if (uv.min() < 4 or uv[:, 0].max() > cam.width - 5
            or uv[:, 1].max() > cam.height - 5):
        return None
    return T


def render_scene(se3np, scene: Scene, family):
    """Every keyframe's RGBD frames (both robots) and robot 1's tag image
    on every TAG_EVERY-th keyframe (None on the others)."""
    cam = scene.cam
    blank = np.full((cam.height, cam.width), 200.0, np.float32)
    scene.frames = [[render_frame(se3np, scene.world,
                                  se3np.compose(traj[i], scene.bot_to_cam),
                                  cam)
                     for i in range(len(scene.stamps))]
                    for traj in scene.trajs]
    scene.tag_truth = [tag_view(se3np, scene, i)
                       for i in range(len(scene.stamps))]
    scene.tag_images = [
        None if i % TAG_EVERY else blank if T is None
        else render_tag_image(family, tag_homography(T, cam), cam)
        for i, T in enumerate(scene.tag_truth)]
    return scene


def tag_config(scene: Scene) -> dict:
    """The CoPeD-style dataset YAML: robot 0 carries TAG_ID."""
    q, t = scene.bot_to_tag[:4], scene.bot_to_tag[4:7]
    return {"dataset": "CoPeD",
            "leader": {"id": 0, "tags": [{
                "id": TAG_ID, "x": float(t[0]), "y": float(t[1]),
                "z": float(t[2]), "qw": float(q[0]), "qx": float(q[1]),
                "qy": float(q[2]), "qz": float(q[3])}]}}


# ---------------------------------------------------------------------------
# The keyframe loop
# ---------------------------------------------------------------------------

def ellipsoid_obs(meas) -> dict:
    """instance_measurements -> ellipsoid observation: the centroid and the
    axis-aligned extent of each instance's points (as
    tests/test_indoor_rgbd.py:95-101)."""
    poses, scales, labels = [], [], []
    for pts, mask, cls_id, _conf in meas:
        p = pts[mask]
        poses.append(np.concatenate([[1.0, 0, 0, 0], p.mean(axis=0)]))
        scales.append(p.max(axis=0) - p.min(axis=0))
        labels.append(cls_id)
    n = len(labels)
    return {"ell_pose": np.asarray(poses, np.float32).reshape(n, 7),
            "ell_scale": np.asarray(scales, np.float32).reshape(n, 3),
            "ell_label": np.asarray(labels, np.int32)}


def exchange(nodes, now):
    """All-to-all full-database rebroadcast (mission._exchange without the
    rate gate, as tests/test_elastic_mission.py)."""
    bundles = []
    for n in nodes:
        n.refresh_robot_map()
        bundles.append((n.robot_id, n.dbm.make_bundles(now)))
    for sender, bs in bundles:
        for n in nodes:
            if n.robot_id != sender:
                for b in bs:
                    n.dbm.ingest_bundle(b)


@dataclass
class TeamRun:
    nodes: list
    clouds: list = field(default_factory=list)      # (robot, i, host cloud)
    measurements: list = field(default_factory=list)
    sightings: list = field(default_factory=list)   # (i, RelativeMeas)
    restart: Optional[dict] = None
    seconds: Dict[str, float] = field(default_factory=dict)
    wall_s: float = 0.0


def run_team(scene: Scene, make_frontend: Callable, make_node: Callable,
             measurer, robots=(0, 1), n_keyframes: Optional[int] = None,
             restart_at: Optional[int] = None, restart: Callable = None,
             sync: Callable = lambda: None,
             host_cloud: Optional[Callable] = None) -> TeamRun:
    """Drive the team keyframe by keyframe through a package's objects.

    Per keyframe and robot: frontend.process_frame (the cloud lands in the
    body frame through the camera extrinsic) -> instance_measurements ->
    ellipsoid_obs -> node.process_keyframe. Robot 1's tag images go through
    measurer.process_image -> add_relative_measurement. Every
    EXCHANGE_EVERY keyframes the nodes exchange databases, replay their
    peers and robot 1 adds its relative factors. After keyframe
    `restart_at - 1`'s exchange, `restart(node)["node"]` replaces robot 1.
    With `host_cloud`, every labelled cloud is kept on the host.
    """
    n = n_keyframes or len(scene.stamps)
    frontend = make_frontend()
    nodes = [make_node(r) for r in robots]
    run = TeamRun(nodes=nodes)
    secs = {k: 0.0 for k in ("process_frame", "instance_measurements",
                             "apriltag", "keyframe_step")}
    t_start = time.perf_counter()
    for i in range(n):
        stamp = float(scene.stamps[i])
        for slot, r in enumerate(robots):
            rgb, depth = scene.frames[r][i]
            t0 = time.perf_counter()
            cloud = frontend.process_frame(rgb, depth,
                                           cam_pose7=scene.bot_to_cam)
            sync()
            t1 = time.perf_counter()
            meas = frontend.instance_measurements(cloud)
            t2 = time.perf_counter()
            nodes[slot].process_keyframe(stamp, scene.odom[r][i],
                                         ellipsoid_obs(meas))
            sync()
            t3 = time.perf_counter()
            secs["process_frame"] += t1 - t0
            secs["instance_measurements"] += t2 - t1
            secs["keyframe_step"] += t3 - t2
            if host_cloud is not None:
                run.clouds.append((r, i, host_cloud(cloud)))
            run.measurements.append((r, i, meas))
        if 1 in robots and scene.tag_images[i] is not None:
            t0 = time.perf_counter()
            found = measurer.process_image(scene.tag_images[i], stamp)
            secs["apriltag"] += time.perf_counter() - t0
            for m in found:
                run.sightings.append((i, m))
                nodes[robots.index(1)].add_relative_measurement(m)
        if len(robots) == 2 and (i + 1) % EXCHANGE_EVERY == 0:
            exchange(nodes, stamp)
            for node in nodes:
                node.replay_peers()
            nodes[1].process_relative_factors()
            sync()
            if restart_at is not None and i + 1 == restart_at:
                run.restart = restart(nodes[1])
                nodes[1] = run.restart["node"]
    sync()
    run.wall_s = time.perf_counter() - t_start
    run.seconds = secs
    return run


def position_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest distance between matching positions of two pose arrays."""
    return float(np.abs(np.asarray(a)[:, 4:7]
                        - np.asarray(b)[:, 4:7]).max()) if len(a) else 0.0


def rotation_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def sighting_errors(se3np, scene: Scene, sightings):
    """Each decoded sighting's camera -> tag pose (recovered from its
    RelativeMeas through the fixed extrinsics) against the truth:
    [(keyframe, translation error m, rotation error deg)]."""
    out = []
    cam_inv = se3np.inverse(scene.bot_to_cam)
    for i, m in sightings:
        est = se3np.matrix(se3np.compose(
            se3np.compose(cam_inv, np.asarray(m.relative_pose, np.float32)),
            scene.bot_to_tag)).astype(np.float64)
        true = scene.tag_truth[i]
        if true is None:
            out.append((i, np.inf, np.inf))
            continue
        out.append((i, float(np.linalg.norm(est[:3, 3] - true[:3, 3])),
                    rotation_deg(est[:3, :3], true[:3, :3])))
    return out


def map_report(node, world, synthetic, traj, odom) -> dict:
    """The gates of tests/test_indoor_rgbd.py:60-73 on one port node."""
    counts = node.landmark_counts()
    est_pts = node.state.pt_pos[:counts["points"]].cpu().numpy()
    errs = [float(np.linalg.norm(world.ell_pos - p, axis=1).min())
            for p in est_pts]
    est = node.optimized_trajectory()
    return dict(points=counts["points"],
                median_landmark_error_m=float(np.median(errs)) if errs
                else float("inf"),
                ate_m=synthetic.ate_rmse(est, traj[:len(est)], align=False),
                ate_odometry_m=synthetic.ate_rmse(odom[:len(est)],
                                                  traj[:len(est)],
                                                  align=False))
