"""Semantic frontend pipeline: labeled point cloud -> object measurements
(PyTorch twin of slide_slam_tpu/frontend/pipeline.py, ground and cylinder
branches).

Per segmented scan (world frame):

1. range gating,
2. ground points from the ground class,
3. per cylinder class: two-stage DBSCAN (the CUDA kernel on the card) ->
   instances -> batched cylinder fit against local RANSAC ground patches,
4. conversion to body-frame measurements for the backend keyframe.

The cuboid branch (bbox seeds, tracker, PCA cuboid fit) is not ported yet:
a class with model "cuboid" raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..geometry import se3
from . import clustering, cylinder_fit


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


class ProcessCloudPipeline:
    """`ransac_draws(n_rows, n_hypotheses) -> [I, H, 3]` ints, when given,
    supplies the RANSAC draws (tests pass the JAX package's); otherwise the
    draws come from a torch.Generator seeded with 0 for every fit."""

    def __init__(self, cfg: Optional[PipelineConfig] = None, device="cuda",
                 ransac_draws: Optional[Callable] = None):
        self.cfg = cfg or PipelineConfig()
        for spec in self.cfg.classes:
            if spec.model == "cuboid":
                raise NotImplementedError(
                    f"class {spec.name!r}: the cuboid branch (cuboid_fit, "
                    "tracker) is not ported yet (ROADMAP, port queue item 2: "
                    "the car branch); use forest_classes()")
        self.device = torch.device(device)
        self.ransac_draws = ransac_draws
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
                               "cyl_label")}
        ground_spec = next((c for c in cfg.classes if c.model == "ground"),
                           None)
        ground_pts = (xyz[rng_ok & (point_labels == ground_spec.label)]
                      if ground_spec is not None
                      else np.zeros((0, 3), np.float32))
        self.class_points = {}
        for spec in cfg.classes:
            if spec.model == "ground":
                continue
            pts = xyz[rng_ok & (point_labels == spec.label)]
            self.class_points[spec.name] = len(pts)
            if len(pts) < spec.min_samples_cluster:
                continue
            pad, mask = _pad_points(pts, cfg.max_points_per_class)
            labels = clustering.two_stage_cluster(
                self._t(pad), self._t(mask), spec.eps_noise,
                spec.min_samples_noise, spec.eps_cluster,
                spec.min_samples_cluster).cpu().numpy()
            instances = self._instances_from_labels(pad[:len(pts)],
                                                    labels[:len(pts)])
            if instances:
                self._fit_cylinders(spec, instances, ground_pts, obs)
        self.scan_idx += 1
        return self._to_body_frame(obs, sensor_pose7)

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

    def _to_body_frame(self, obs, sensor_pose7):
        """World measurements -> body frame."""
        out = {}
        if obs["cyl_root"]:
            inv = se3.inverse(self._t(np.asarray(sensor_pose7, np.float32)))
            roots = self._t(np.stack(obs["cyl_root"]))
            rays = self._t(np.stack(obs["cyl_ray"]))
            out["cyl_root"] = se3.apply(inv, roots).cpu().numpy()
            out["cyl_ray"] = se3.rotate(inv, rays).cpu().numpy()
            out["cyl_radius"] = np.asarray(obs["cyl_radius"], np.float32)
            out["cyl_label"] = np.asarray(obs["cyl_label"], np.int32)
        return out
