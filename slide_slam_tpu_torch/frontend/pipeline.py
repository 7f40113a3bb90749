"""Semantic frontend pipeline: labeled point cloud -> object measurements
(PyTorch twin of slide_slam_tpu/frontend/pipeline.py).

Per segmented scan (world frame):

1. range gating,
2. ground points from the ground class,
3. two-stage DBSCAN of every cuboid and cylinder class with at least
   min_samples_cluster points (on the card: one copy up, one launch of the
   CUDA kernel, one copy back), then per class in the config's order:
   - cuboid: instances -> batched bbox seeds -> Hungarian track update,
   - cylinder: instances -> batched cylinder fit against local RANSAC
     ground patches,
4. aged cuboid tracks' accumulated points -> batched PCA cuboid fit ->
   optional yaw snapping,
5. conversion to body-frame measurements for the backend keyframe.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..geometry import se3
from . import clustering, cuboid_fit, cylinder_fit
from .tracker import MultiClassTracker


@dataclass(frozen=True)
class ClassSpec:
    """Per-class geometry/clustering gates."""
    name: str
    label: int
    model: str                   # "cuboid" | "cylinder" | "ground"
    eps_noise: float = 0.5
    min_samples_noise: int = 5
    eps_cluster: float = 1.0
    min_samples_cluster: int = 10
    dim_lo: tuple = (0.5, 0.5, 0.5)
    dim_hi: tuple = (8.0, 4.0, 3.0)
    assignment_threshold: float = 2.0
    track_age_threshold: int = 2
    fit_cuboid_dim_thresh: float = 0.3


def outdoor_classes() -> List[ClassSpec]:
    """The outdoor demo classes: ground=1, car=5 cuboid, tree=8 cylinder,
    lightpole=9 cylinder."""
    return [
        ClassSpec("ground", 1, "ground"),
        ClassSpec("car", 5, "cuboid", dim_lo=(2.0, 1.0, 0.8),
                  dim_hi=(7.0, 3.0, 2.5)),
        ClassSpec("tree", 8, "cylinder", eps_cluster=0.8,
                  min_samples_cluster=8),
        ClassSpec("lightpole", 9, "cylinder", eps_cluster=0.6,
                  min_samples_cluster=5),
    ]


def forest_classes() -> List[ClassSpec]:
    """The outdoor classes without cars: ground, tree, lightpole."""
    return [c for c in outdoor_classes() if c.model != "cuboid"]


def kitti_classes() -> List[ClassSpec]:
    """KITTI semantic-segmentation ids: ground=40, car=10 cuboid (assignment
    threshold 1.0, DBSCAN [0.5, 10], dim cutoffs 0.5-7.5 / 0.5-7.5 /
    0.2-4.0), tree=71 and lightpole=80 cylinders."""
    return [
        ClassSpec("ground", 40, "ground"),
        ClassSpec("car", 10, "cuboid", eps_cluster=0.5,
                  min_samples_cluster=10, assignment_threshold=1.0,
                  dim_lo=(0.5, 0.5, 0.2), dim_hi=(7.5, 7.5, 4.0)),
        ClassSpec("tree", 71, "cylinder", assignment_threshold=1.0),
        ClassSpec("lightpole", 80, "cylinder", assignment_threshold=1.0),
    ]


def kitti_pipeline_config() -> "PipelineConfig":
    """KITTI preset (the 64x1024 HDL-64 cloud layout): 100 m valid range,
    first-layer DBSCAN (epsilon 0.1 / 7 samples), second layer from the
    classes, no car facing-direction estimate, yaw snapping on."""
    classes = [dataclasses.replace(c, eps_noise=0.1, min_samples_noise=7)
               for c in kitti_classes()]
    return PipelineConfig(classes=classes, max_range=100.0,
                          estimate_facing_dir_car=False,
                          cluster_and_fix_cuboid_orientation=True)


@dataclass
class PipelineConfig:
    classes: List[ClassSpec] = field(default_factory=outdoor_classes)
    max_range: float = 30.0
    max_points_per_class: int = 1024     # static clustering capacity
    max_instances: int = 32
    max_points_per_instance: int = 512
    ground_patch_size: float = 4.0
    breast_height: float = 1.37
    default_radius: float = 0.2
    radius_cutoff: tuple = (0.05, 1.0)
    downsample_res: float = 0.15
    estimate_facing_dir_car: bool = False
    cluster_and_fix_cuboid_orientation: bool = True


def _pad_points(pts: np.ndarray, n: int):
    out = np.zeros((n, 3), np.float32)
    k = min(len(pts), n)
    if k:
        out[:k] = pts[:k]
    mask = np.zeros((n,), bool)
    mask[:k] = True
    return out, mask


def cluster_classes(point_sets, params, n: int, device) -> np.ndarray:
    """Two-stage DBSCAN labels [C, n] of C point sets, each padded to n,
    with params[c] = (eps_noise, min_samples_noise, eps_cluster,
    min_samples_cluster): one copy to the device, one launch for every set
    and both stages, one copy back."""
    C = len(point_sets)
    if not C:
        return np.zeros((0, n), np.int32)
    # points f32 [C, n, 3] | params f32 [C, 4] | valid bool [C, n]
    n_pts, n_par = C * n * 12, C * 16
    host = np.zeros(n_pts + n_par + C * n, np.uint8)
    pts = host[:n_pts].view(np.float32).reshape(C, n, 3)
    par = host[n_pts:n_pts + n_par].view(np.float32).reshape(C, 4)
    valid = host[n_pts + n_par:].view(bool).reshape(C, n)
    for c, (p, q) in enumerate(zip(point_sets, params)):
        pts[c], valid[c] = _pad_points(p, n)
        par[c] = clustering.stage_params(*q)
    buf = torch.from_numpy(host).to(device)
    labels = clustering.two_stage_cluster_batch(
        buf[:n_pts].view(torch.float32).view(C, n, 3),
        buf[n_pts + n_par:].view(torch.bool).view(C, n),
        buf[n_pts:n_pts + n_par].view(torch.float32).view(C, 4))
    return labels.cpu().numpy()


def fit_aged_tracks(tracker: MultiClassTracker, classes, n: int, device,
                    **fit_kw):
    """The tracker's tracks past their class's track_age_threshold and one
    batched cuboid_fit.fit_cuboids over each track's first n accumulated
    points (f64 voxel means cast to f32) within its class's dim_lo/dim_hi
    gates. Returns (tracks, fit), fit None when no track is aged."""
    tracks = tracker.aged_tracks({c.label: c.track_age_threshold
                                  for c in classes})
    if not tracks:
        return tracks, None
    specs = {c.label: c for c in classes}
    padded = [_pad_points(t.all_raw_points, n) for t in tracks]

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)
    return tracks, cuboid_fit.fit_cuboids(
        dev([p for p, _ in padded]), dev([m for _, m in padded], bool),
        dev([specs[t.class_label].dim_lo for t in tracks]),
        dev([specs[t.class_label].dim_hi for t in tracks]), **fit_kw)


class ProcessCloudPipeline:
    """`ransac_draws(n_rows, n_hypotheses) -> [I, H, 3]` ints, when given,
    supplies the RANSAC draws (tests pass the JAX package's); otherwise the
    draws come from a torch.Generator seeded with 0 for every fit."""

    def __init__(self, cfg: Optional[PipelineConfig] = None, device="cuda",
                 ransac_draws: Optional[Callable] = None):
        self.cfg = cfg or PipelineConfig()
        self.device = torch.device(device)
        self.ransac_draws = ransac_draws
        self.tracker = MultiClassTracker(
            {c.label: c.assignment_threshold for c in self.cfg.classes},
            downsample_res=self.cfg.downsample_res)
        self.scan_idx = 0
        # per-scan statistics of the last process_scan call
        self.class_points: dict = {}

    def _t(self, a):
        return torch.as_tensor(a, device=self.device)

    @staticmethod
    def _instances_from_labels(pts: np.ndarray, labels: np.ndarray):
        return [pts[labels == lab] for lab in np.unique(labels) if lab >= 0]

    def process_scan(self, xyz: np.ndarray, point_labels: np.ndarray,
                     sensor_pose7: np.ndarray) -> dict:
        """xyz [N, 3] world-frame labeled scan points, point_labels [N]
        semantic ids, sensor_pose7 the synced odometry pose. Returns the
        body-frame measurement dict for the backend keyframe."""
        cfg = self.cfg
        xyz = np.asarray(xyz, np.float32)
        point_labels = np.asarray(point_labels)
        sensor_xyz = np.asarray(sensor_pose7, np.float32)[4:7]
        rng_ok = np.linalg.norm(xyz - sensor_xyz, axis=1) < cfg.max_range
        obs = {k: [] for k in ("cyl_root", "cyl_ray", "cyl_radius",
                               "cyl_label", "cub_pose", "cub_scale",
                               "cub_label")}
        ground_spec = next((c for c in cfg.classes if c.model == "ground"),
                           None)
        ground_pts = (xyz[rng_ok & (point_labels == ground_spec.label)]
                      if ground_spec is not None
                      else np.zeros((0, 3), np.float32))
        self.class_points = {}
        clustered = []
        for spec in cfg.classes:
            if spec.model == "ground":
                continue
            pts = xyz[rng_ok & (point_labels == spec.label)]
            self.class_points[spec.name] = len(pts)
            if len(pts) >= spec.min_samples_cluster:
                clustered.append((spec, pts))
        labels = self._cluster(clustered)
        for (spec, pts), lab in zip(clustered, labels):
            k = min(len(pts), cfg.max_points_per_class)
            instances = self._instances_from_labels(pts[:k], lab[:k])
            if not instances:
                continue
            if spec.model == "cuboid":
                self._track_cuboids(spec, instances)
            elif spec.model == "cylinder":
                self._fit_cylinders(spec, instances, ground_pts, obs)
        self._emit_cuboids(obs)
        self.scan_idx += 1
        return self._to_body_frame(obs, sensor_pose7)

    def _track_cuboids(self, spec: ClassSpec, instances):
        """Bbox seeds of every instance in one batched call, then one
        tracker update with the valid seeds in instance order."""
        cfg = self.cfg
        padded = [_pad_points(p, cfg.max_points_per_instance)
                  for p in instances]
        seeds = cuboid_fit.fit_bbox_seeds(
            self._t(np.stack([p for p, _ in padded])),
            self._t(np.stack([m for _, m in padded])),
            spec.fit_cuboid_dim_thresh)
        seeds = torch.stack([s.float() for s in seeds], dim=1).cpu().numpy()
        ok = seeds[:, 4] > 0
        if ok.any():
            dets = seeds[ok, :4].astype(np.float64)
            raw = [p for p, keep in zip(instances, ok) if keep]
            self.tracker.update(spec.label, dets, raw, self.scan_idx)

    def _cluster(self, clustered) -> np.ndarray:
        return cluster_classes(
            [p for _, p in clustered],
            [(s.eps_noise, s.min_samples_noise, s.eps_cluster,
              s.min_samples_cluster) for s, _ in clustered],
            self.cfg.max_points_per_class, self.device)

    def _fit_cylinders(self, spec: ClassSpec, instances, ground_pts, obs):
        cfg = self.cfg
        I = len(instances)
        padded = [_pad_points(p, cfg.max_points_per_instance)
                  for p in instances]
        pads = self._t(np.stack([p for p, _ in padded]))
        masks = self._t(np.stack([m for _, m in padded]))
        cens = self._t(np.stack([np.median(p, axis=0) for p in instances])
                       .astype(np.float32))
        gp, gm = _pad_points(ground_pts, cfg.max_points_per_class)
        gp_t = self._t(gp)
        patch_masks = cylinder_fit.select_ground_patches(
            gp_t, self._t(gm), cens, cfg.ground_patch_size)
        draws = (None if self.ransac_draws is None
                 else self._t(np.asarray(self.ransac_draws(I, 64))))
        normals, ds, _ = cylinder_fit.fit_plane_ransac(
            gp_t.expand((I,) + gp_t.shape), patch_masks, thresh=0.1,
            draws=draws)
        # fallback: flat ground through the instance's lowest point
        have_patch = patch_masks.sum(dim=1) >= 5
        z0 = torch.where(masks, pads[..., 2], 1e9).amin(dim=1)
        up = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        normals = torch.where(have_patch[:, None], normals, up)
        ds = torch.where(have_patch, ds, -z0)
        fit = cylinder_fit.fit_cylinders(
            pads, masks, normals, ds, breast_height=cfg.breast_height,
            radius_cutoff=cfg.radius_cutoff,
            default_radius=cfg.default_radius)
        valid = fit.valid.cpu().numpy()
        root, ray, radius = (a.cpu().numpy() for a in fit[:3])
        for i in np.nonzero(valid)[0]:
            obs["cyl_root"].append(root[i])
            obs["cyl_ray"].append(ray[i])
            obs["cyl_radius"].append(float(radius[i]))
            obs["cyl_label"].append(spec.label)

    def _emit_cuboids(self, obs):
        """Aged tracks -> one batched PCA cuboid fit -> world cuboid poses,
        yaws snapped when configured."""
        cfg = self.cfg
        tracks, fit = fit_aged_tracks(
            self.tracker, cfg.classes, cfg.max_points_per_instance,
            self.device, estimate_facing_dir=cfg.estimate_facing_dir_car)
        if not tracks:
            return
        host = torch.cat([fit.centroid, fit.dims, fit.yaw[:, None],
                          fit.valid[:, None].float()], dim=1).cpu().numpy()
        cen, dims, valid = host[:, :3], host[:, 3:6], host[:, 7] > 0
        yaws = host[:, 6].astype(np.float64)
        if cfg.cluster_and_fix_cuboid_orientation and valid.sum() > 2:
            yaws[valid] = cuboid_fit.cluster_cuboid_orientation(yaws[valid])
        for i in np.nonzero(valid)[0]:
            obs["cub_pose"].append((cen[i], yaws[i]))
            obs["cub_scale"].append(dims[i])
            obs["cub_label"].append(tracks[i].class_label)

    def _to_body_frame(self, obs, sensor_pose7):
        """World measurements -> body frame."""
        out = {}
        if not (obs["cyl_root"] or obs["cub_pose"]):
            return out
        inv = se3.inverse(self._t(np.asarray(sensor_pose7, np.float32)))
        if obs["cyl_root"]:
            roots = self._t(np.stack(obs["cyl_root"]))
            rays = self._t(np.stack(obs["cyl_ray"]))
            out["cyl_root"] = se3.apply(inv, roots).cpu().numpy()
            out["cyl_ray"] = se3.rotate(inv, rays).cpu().numpy()
            out["cyl_radius"] = np.asarray(obs["cyl_radius"], np.float32)
            out["cyl_label"] = np.asarray(obs["cyl_label"], np.int32)
        if obs["cub_pose"]:
            cen = self._t(np.stack([c for c, _ in obs["cub_pose"]]))
            half = 0.5 * self._t(np.asarray([y for _, y in obs["cub_pose"]],
                                            np.float32))
            zero = torch.zeros_like(half)
            poses = torch.cat([torch.stack([torch.cos(half), zero, zero,
                                            torch.sin(half)], dim=-1), cen],
                              dim=-1)
            out["cub_pose"] = se3.compose(inv, poses).cpu().numpy()
            out["cub_scale"] = np.stack(obs["cub_scale"]).astype(np.float32)
            out["cub_label"] = np.asarray(obs["cub_label"], np.int32)
        return out
