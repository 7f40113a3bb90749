"""YAML configuration loading (copy of slide_slam_tpu/io/config_yaml.py over
the port's config dataclasses and frontend.pipeline).

Mirrors the reference's three config tiers: the master param file
(sloam.yaml names preserved), per-class frontend class-info YAMLs
(process_cloud_node_*_class_info.yaml style), and programmatic overrides.
PyYAML is imported inside the functions: the package imports without it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..config import (CapacityConfig, NoiseConfig, PlaceRecognitionConfig,
                      SlamConfig, SlideGraphConfig, SolverConfig)
from ..frontend.pipeline import ClassSpec, PipelineConfig


def _fill(dc_cls, data: dict, base=None):
    """Construct a frozen dataclass from a dict, keeping unknown keys out."""
    base = base or dc_cls()
    fields = {f.name for f in dataclasses.fields(dc_cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in (data or {}).items() if k in fields}
    return dataclasses.replace(base, **kw)


def load_slam_config(path: str) -> SlamConfig:
    """Load a sloam.yaml-style file. Top-level keys follow the reference
    (`sloam:` section with nested `place_recognition`,
    `place_recognition_slidegraph`, `factor_graph`), plus the engine's
    `capacity:` and `solver:` sections."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    top = raw.get("sloam", raw)
    cfg = _fill(SlamConfig, top)
    cfg = dataclasses.replace(
        cfg,
        place_recognition=_fill(PlaceRecognitionConfig,
                                top.get("place_recognition")),
        slidegraph=_fill(SlideGraphConfig,
                         top.get("place_recognition_slidegraph")),
        noise=_load_noise(top.get("factor_graph")),
        capacity=_fill(CapacityConfig, top.get("capacity")),
        solver=_fill(SolverConfig, top.get("solver")),
    )
    return cfg


def _load_noise(fg: Optional[dict]) -> NoiseConfig:
    if not fg:
        return NoiseConfig()
    m = {
        "noise_model_prior_first_pose_vec": "prior_first_pose",
        "noise_model_odom_vec": "odom",
        "noise_model_cube_vec": "cube",
        "noise_model_rel_meas_vec": "rel_meas",
    }
    kw = {}
    for yk, fk in m.items():
        if yk in fg:
            kw[fk] = tuple(fg[yk])
    return dataclasses.replace(NoiseConfig(), **kw)


def load_class_info(path: str) -> PipelineConfig:
    """Frontend class-info YAML -> PipelineConfig.

    Format (process_cloud_node_outdoor_class_info.yaml style):

        classes:
          car:
            id: 5
            model: cuboid
            eps_cluster: 1.0
            dim_lo: [2.0, 1.0, 0.8]
            ...
        pipeline:
          max_range: 30.0
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    specs: List[ClassSpec] = []
    for name, d in (raw.get("classes") or {}).items():
        d = dict(d)
        label = int(d.pop("id"))
        model = d.pop("model", "cuboid")
        fields = {f.name for f in dataclasses.fields(ClassSpec)}
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in d.items() if k in fields}
        specs.append(ClassSpec(name=name, label=label, model=model, **kw))
    pc = raw.get("pipeline") or {}
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in pc.items() if k in fields}
    cfg = PipelineConfig(**kw)
    if specs:
        cfg.classes = specs
    return cfg


def dump_slam_config(cfg: SlamConfig) -> str:
    """Serialize back to the yaml layout (round-trip support)."""
    import yaml

    def dcdict(dc):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(dc).items()}
    top = {k: v for k, v in dcdict(cfg).items()
           if not isinstance(v, dict)}
    top["place_recognition"] = dcdict(cfg.place_recognition)
    top["place_recognition_slidegraph"] = dcdict(cfg.slidegraph)
    top["capacity"] = dcdict(cfg.capacity)
    top["solver"] = dcdict(cfg.solver)
    top["factor_graph"] = {
        "noise_model_prior_first_pose_vec": list(cfg.noise.prior_first_pose),
        "noise_model_odom_vec": list(cfg.noise.odom),
        "noise_model_cube_vec": list(cfg.noise.cube),
        "noise_model_rel_meas_vec": list(cfg.noise.rel_meas),
    }
    return yaml.safe_dump({"sloam": top})
