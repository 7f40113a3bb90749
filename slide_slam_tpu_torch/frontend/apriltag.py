"""AprilTag-style fiducial detection + inter-robot measurement generation
(copy of slide_slam_tpu/frontend/apriltag.py; host-side numpy/scipy, no
tensors, kept in the port so that it never imports the JAX package).

Twin of the reference's `frontend/relative_meas_gen` C++ node
(apriltag_meas_gen.cpp), which uses the external apriltag C library to turn
camera images of tags mounted on peer robots into
`RelativeInterRobotMeasurement`s. This is a from-scratch implementation:

* ``TagFamily`` — square fiducial families: payload grid of d*d bits inside
  a 1-cell black border and 1-cell white border (the 36h11 layout).
  ``generate_family`` deterministically searches for a family with a given
  minimum Hamming distance (including under rotation), so simulations and
  tests are fully self-contained; ``TagFamily.from_codes`` accepts the
  published tag36h11 code table (public constant data shipped with the
  apriltag library, not bundled here) for real datasets like CoPeD.
* ``detect`` — grayscale image -> decoded detections: adaptive
  thresholding, connected-component quad extraction, 4-point DLT
  homography, payload sampling, rotation-invariant Hamming decode, and
  homography pose decomposition (camera -> tag SE3, given intrinsics and
  tag size) — the same stages as the apriltag library's detector, built on
  numpy/scipy instead of its C implementation.
* ``ApriltagMeasurer`` — mirrors ApriltagMeasurer::imageCallback
  (apriltag_meas_gen.cpp:3-42): look up which robot carries the detected
  tag and where (LoadTransformations, :44-91, CoPeD YAML layout), compose
  host_bot->cam->tag->observed_bot (CalculateRelativeTransformation,
  :177-188). Deviation (documented): the reference publishes the rotation
  of `bot_to_cam` instead of the composed transform's rotation
  (apriltag_meas_gen.cpp:202-208, an apparent bug); we publish the
  composed rotation.

Detection is host-side vision (the reference's is too — apriltag runs on
CPU); the relative measurements it emits are the port's own
`runtime.scheduler.RelativeMeas` and feed the device-side factor graph
through `SlamNode.add_relative_measurement` like every other measurement
stream. The numpy/scipy calls are kept as they are (numpy's unstable
argsort of component areas, the `itertools.combinations` quad search over
scipy's hull vertices), so detections equal the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from ..geometry import se3np


# ---------------------------------------------------------------------------
# Tag families
# ---------------------------------------------------------------------------

def _rotate_code(code: int, d: int) -> int:
    """Rotate a d*d payload 90 degrees clockwise (bit 0 = top-left, row
    major)."""
    out = 0
    for r in range(d):
        for c in range(d):
            src = r * d + c
            # (r, c) -> (c, d-1-r)
            dst = c * d + (d - 1 - r)
            if (code >> (d * d - 1 - src)) & 1:
                out |= 1 << (d * d - 1 - dst)
    return out


@dataclass
class TagFamily:
    """Square tag family: d*d payload bits, 1-cell black + 1-cell white
    border (total side = d + 4 cells)."""
    name: str
    d: int
    codes: List[int]
    min_hamming: int
    _rot_table: Dict[int, Tuple[int, int]] = field(default_factory=dict)

    def __post_init__(self):
        self._rot_table = {}
        for idx, code in enumerate(self.codes):
            c = code
            for rot in range(4):
                self._rot_table.setdefault(c, (idx, rot))
                c = _rotate_code(c, self.d)

    @property
    def nbits(self) -> int:
        return self.d * self.d

    @property
    def total_cells(self) -> int:
        return self.d + 4

    @classmethod
    def from_codes(cls, name: str, d: int, codes: Sequence[int],
                   min_hamming: int = 11) -> "TagFamily":
        return cls(name, d, list(codes), min_hamming)

    def decode(self, code: int, max_hamming: int = 2):
        """-> (tag_id, rotation, hamming) or None. rotation = number of
        90deg CW turns applied to the observed payload to match the canonical
        code."""
        hit = self._rot_table.get(code)
        if hit is not None:
            return hit[0], hit[1], 0
        if max_hamming <= 0:
            return None
        best = None
        c = code
        for rot in range(4):
            for idx, ref in enumerate(self.codes):
                h = bin(c ^ ref).count("1")
                if h <= max_hamming and (best is None or h < best[2]):
                    best = (idx, rot, h)
            c = _rotate_code(c, self.d)
        return best

    def render(self, tag_id: int, cell_px: int = 8) -> np.ndarray:
        """Tag image (white border included), uint8 0/255."""
        d, t = self.d, self.total_cells
        cells = np.ones((t, t), np.uint8)            # white
        cells[1:-1, 1:-1] = 0                        # black border + payload
        code = self.codes[tag_id]
        for r in range(d):
            for c in range(d):
                bit = (code >> (d * d - 1 - (r * d + c))) & 1
                cells[2 + r, 2 + c] = bit
        return np.kron(cells * 255, np.ones((cell_px, cell_px), np.uint8))


def generate_family(d: int = 6, min_hamming: int = 11, count: int = 30,
                    seed: int = 42, name: Optional[str] = None) -> TagFamily:
    """Deterministic greedy family search (the apriltag papers' lexicode
    approach): walk a pseudorandom code sequence, accept codes whose
    Hamming distance to every accepted code — under all 4 relative
    rotations, and to own rotations — is >= min_hamming, with simple
    complexity gates against degenerate patterns."""
    nbits = d * d
    mask = (1 << nbits) - 1
    rng = np.random.default_rng(seed)
    accepted: List[int] = []
    accepted_rots: List[int] = []

    def ham(a, b):
        return bin(a ^ b).count("1")

    tries = 0
    while len(accepted) < count and tries < 400000:
        tries += 1
        code = int(rng.integers(0, 1 << 63, dtype=np.int64)) & mask
        pop = bin(code).count("1")
        if pop < nbits // 4 or pop > 3 * nbits // 4:
            continue
        rots = [code]
        for _ in range(3):
            rots.append(_rotate_code(rots[-1], d))
        # self-distance under rotation (rejects rotationally-symmetric tags)
        if any(ham(code, r) < min_hamming for r in rots[1:]):
            continue
        if any(ham(r, a) < min_hamming for r in rots for a in accepted_rots):
            continue
        accepted.append(code)
        accepted_rots.extend(rots)
    return TagFamily(name or f"ss{nbits}h{min_hamming}", d, accepted,
                     min_hamming)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

@dataclass
class TagDetection:
    tag_id: int
    hamming: int
    corners: np.ndarray          # [4,2] image px, CCW from tag's (-1,-1)
    center: np.ndarray           # [2]
    H: np.ndarray                # [3,3] tag coords ([-1,1]^2 at black border
    #                              outer corners) -> image px
    pose: Optional[np.ndarray] = None   # [4,4] camera -> tag (if K given)


def _homography_4pt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT from 4 correspondences src->dst ([4,2] each)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    A = np.asarray(A, np.float64)
    _, _, vt = np.linalg.svd(A)
    H = vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _apply_h(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return p[:, :2] / p[:, 2:3]


def _quad_from_component(mask: np.ndarray) -> Optional[np.ndarray]:
    """Fit a quadrilateral to a connected component: convex hull, then the
    4 hull vertices maximizing quad area; reject if hull area and quad area
    disagree (non-quadrilateral blob)."""
    ys, xs = np.nonzero(mask)
    if len(xs) < 16:
        return None
    pts = np.stack([xs, ys], axis=1).astype(np.float64)
    try:
        from scipy.spatial import ConvexHull
        hull = ConvexHull(pts)
        hp = pts[hull.vertices]              # CCW order (for 2D)
        hull_area = hull.volume
    except Exception:
        return None
    h = len(hp)
    if h < 4:
        return None
    if h > 28:                                # simplify dense hulls
        idx = np.round(np.linspace(0, h - 1, 28)).astype(int)
        hp = hp[np.unique(idx)]
        h = len(hp)
    # max-area 4-subset preserving hull order
    from itertools import combinations
    best, best_area = None, -1.0
    for comb in combinations(range(h), 4):
        q = hp[list(comb)]
        x, y = q[:, 0], q[:, 1]
        area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
        if area > best_area:
            best_area, best = area, q
    if best is None or best_area < 0.85 * hull_area:
        return None
    return best                                # CCW in image coords


def _adaptive_threshold(img: np.ndarray, tile: int = 8,
                        min_contrast: float = 20.0):
    """Per-tile min/max adaptive threshold (the apriltag detector's
    threshold stage). Returns (binary 0/1, valid mask)."""
    img = img.astype(np.float32)
    hmin = ndimage.minimum_filter(img, size=2 * tile + 1, mode="nearest")
    hmax = ndimage.maximum_filter(img, size=2 * tile + 1, mode="nearest")
    thresh = 0.5 * (hmin + hmax)
    valid = (hmax - hmin) >= min_contrast
    return (img > thresh).astype(np.uint8), valid


def _pose_from_homography(H: np.ndarray, K: np.ndarray,
                          tagsize: float) -> np.ndarray:
    """Camera->tag SE3 from the tag->image homography. Tag corners live at
    (+-1, +-1) in tag coords, i.e. units of tagsize/2."""
    Hn = np.linalg.inv(K) @ H
    s = np.sqrt(np.linalg.norm(Hn[:, 0]) * np.linalg.norm(Hn[:, 1]))
    if s <= 0:
        s = 1.0
    Hn = Hn / s
    if Hn[2, 2] < 0:       # tag must be in front of the camera
        Hn = -Hn
    r1, r2, t = Hn[:, 0], Hn[:, 1], Hn[:, 2]
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t * (tagsize / 2.0)
    return T


def detect(img: np.ndarray, family: TagFamily,
           K: Optional[np.ndarray] = None, tagsize: float = 0.17,
           max_hamming: int = 2, min_side_px: float = 12.0,
           min_contrast: float = 20.0) -> List[TagDetection]:
    """Detect tags of `family` in a grayscale image [H,W] (uint8/float)."""
    binary, valid = _adaptive_threshold(img, min_contrast=min_contrast)
    dark = ((binary == 0) & valid).astype(np.uint8)
    labels, n = ndimage.label(dark, structure=np.ones((3, 3), int))
    if n == 0:
        return []

    t = family.total_cells
    d = family.d
    dets: List[TagDetection] = []
    areas = ndimage.sum_labels(dark, labels, index=np.arange(1, n + 1))
    img_f = img.astype(np.float32)
    Hh, Ww = img.shape

    for comp in np.argsort(-areas)[:64]:
        lab = comp + 1
        if areas[comp] < min_side_px * min_side_px * 0.3:
            continue
        quad = _quad_from_component(labels == lab)
        if quad is None:
            continue
        sides = np.linalg.norm(quad - np.roll(quad, -1, axis=0), axis=1)
        if sides.min() < min_side_px * 0.5:
            continue
        # quad corners = OUTER black border corners = tag coords (+-1,+-1).
        # ConvexHull gives CCW in (x, y up) = CW on screen; keep consistent
        # with a CCW tag-coordinate square.
        tag_corners = np.asarray([[-1.0, -1.0], [1.0, -1.0],
                                  [1.0, 1.0], [-1.0, 1.0]])
        H = _homography_4pt(tag_corners, quad)
        # sample payload cells: black border spans cell indices [1, t-1) of
        # the t-cell grid; tag coords map cell k center to
        # -1 + 2*(k - 1 + 0.5)/(t - 2)  (black square side = t-2 cells)
        span = t - 2
        centers = []
        for r in range(d):
            for c in range(d):
                cx = -1.0 + 2.0 * (c + 1 + 0.5) / span
                cy = -1.0 + 2.0 * (r + 1 + 0.5) / span
                centers.append((cx, cy))
        # reference samples: black border cells + white ring just outside
        border_cells = []
        for k in range(span):
            u = -1.0 + 2.0 * (k + 0.5) / span
            border_cells += [(u, -1.0 + 1.0 / span), (u, 1.0 - 1.0 / span),
                             (-1.0 + 1.0 / span, u), (1.0 - 1.0 / span, u)]
        white_off = 1.0 + 1.0 / span
        white_cells = []
        for k in range(span):
            u = -1.0 + 2.0 * (k + 0.5) / span
            white_cells += [(u, -white_off), (u, white_off),
                            (-white_off, u), (white_off, u)]

        def sample(pts):
            px = _apply_h(H, np.asarray(pts))
            xi = np.clip(np.round(px[:, 0]).astype(int), 0, Ww - 1)
            yi = np.clip(np.round(px[:, 1]).astype(int), 0, Hh - 1)
            return img_f[yi, xi]

        black_ref = np.median(sample(border_cells))
        white_ref = np.median(sample(white_cells))
        if white_ref - black_ref < min_contrast * 0.5:
            continue
        thr = 0.5 * (black_ref + white_ref)
        bits = sample(centers) > thr
        code = 0
        for b in bits:
            code = (code << 1) | int(b)
        hit = family.decode(code, max_hamming=max_hamming)
        if hit is None:
            continue
        tag_id, rot, hamming = hit
        # undo rotation: observed payload rotated `rot` times CW matches the
        # canonical code, so canonical corner 0 sits `rot` steps around
        quad_c = np.roll(quad, -rot, axis=0)
        Hc = _homography_4pt(tag_corners, quad_c)
        det = TagDetection(
            tag_id=tag_id, hamming=hamming, corners=quad_c,
            center=_apply_h(Hc, np.zeros((1, 2)))[0], H=Hc)
        if K is not None:
            det.pose = _pose_from_homography(Hc, np.asarray(K, np.float64),
                                             tagsize)
        dets.append(det)

    # de-duplicate by tag id (keep largest quad)
    by_id: Dict[int, TagDetection] = {}
    for det in dets:
        prev = by_id.get(det.tag_id)
        if prev is None or _quad_area(det.corners) > _quad_area(prev.corners):
            by_id[det.tag_id] = det
    return list(by_id.values())


def _quad_area(q: np.ndarray) -> float:
    x, y = q[:, 0], q[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


# ---------------------------------------------------------------------------
# Relative-measurement generation (apriltag_meas_gen.cpp)
# ---------------------------------------------------------------------------

def _mat_to_pose7(T: np.ndarray) -> np.ndarray:
    q = se3np.quat_from_matrix(np.asarray(T[:3, :3]))
    return np.concatenate([q, T[:3, 3]]).astype(np.float32)


def _pose7_to_mat(pose: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = se3np.quat_to_matrix(np.asarray(pose[:4], np.float64))
    T[:3, 3] = pose[4:7]
    return T


class ApriltagMeasurer:
    """Camera images -> robot-to-robot relative measurements.

    config: the CoPeD-style dataset YAML as a dict:
      {"dataset": "CoPeD",
       "<robot>": {"id": int, "tags": [{"id", "x","y","z",
                                        "qw","qx","qy","qz"}, ...]}, ...}
    (LoadTransformations, apriltag_meas_gen.cpp:44-91). bot_to_cam is the
    host robot's base->camera SE3 (from the TF tree in the reference,
    apriltag_meas_gen.cpp:108-125)."""

    def __init__(self, family: TagFamily, intrinsics: np.ndarray,
                 tagsize: float, bot_to_cam: np.ndarray, config: dict,
                 host_robot_id: int = 0):
        self.family = family
        self.K = np.asarray(intrinsics, np.float64)
        self.tagsize = float(tagsize)
        self.bot_to_cam = np.asarray(bot_to_cam, np.float64)
        self.config = config
        self.host_robot_id = host_robot_id
        # tag id -> (bot id, tag_to_bot SE3); note the YAML stores
        # bot->tag ("translation ... from detected apriltag -> detected
        # robot" is composed by inverting, :183)
        self.tag_table: Dict[int, Tuple[int, np.ndarray]] = {}
        for key, val in config.items():
            if not isinstance(val, dict) or "tags" not in val:
                continue
            bot_id = int(val["id"])
            for tag in val["tags"]:
                T = _pose7_to_mat(np.asarray(
                    [tag["qw"], tag["qx"], tag["qy"], tag["qz"],
                     tag["x"], tag["y"], tag["z"]], np.float64))
                self.tag_table[int(tag["id"])] = (bot_id, T)

    def relative_transform(self, cam_to_tag: np.ndarray,
                           bot_to_tag_extrinsic: np.ndarray) -> np.ndarray:
        """CalculateRelativeTransformation (apriltag_meas_gen.cpp:177-188):
        host_bot->cam->tag, then tag->observed_bot."""
        H_bot_to_tag = self.bot_to_cam @ cam_to_tag
        return H_bot_to_tag @ np.linalg.inv(bot_to_tag_extrinsic)

    def process_image(self, img: np.ndarray, stamp: float) -> List:
        """-> list of scheduler RelativeMeas (observer side)."""
        from ..runtime.scheduler import RelativeMeas

        out = []
        for det in detect(img, self.family, K=self.K, tagsize=self.tagsize):
            hit = self.tag_table.get(det.tag_id)
            if hit is None:
                continue            # "tag does not belong to any robot"
            bot_id, tag_to_bot = hit
            T = self.relative_transform(det.pose, tag_to_bot)
            out.append(RelativeMeas(
                stamp=stamp,
                relative_pose=_mat_to_pose7(T),
                robot_index=bot_id,
                odom_pose=np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32),
                only_use_odom=False))
        return out
