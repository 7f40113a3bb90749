"""Open-vocabulary RGBD detection path (PyTorch twin of
slide_slam_tpu/frontend/open_vocab.py).

Twin of the reference's YOLO-World node
(frontend/object_modeller/object_detector_utils/detect_open_vocab.py):
text queries come straight from the class-info YAML keys
(detect_open_vocab.py:34-38 builds `list_of_queries` and calls
`yolo.set_classes`), the detector returns *boxes* (not masks — the
reference fills the whole bbox as the mask, :160-168), and the labeled
depth backprojection (:170-186) produces the syncPcOdom-equivalent labeled
cloud the indoor process pipeline consumes.

The open-vocabulary model itself (yolov8x-worldv2) is an external network
here exactly as in the reference and the JAX package (no weights are
bundled): any callable `detect_fn(rgb) -> [Detection]` plugs in. Query
mapping, confidence gating and bbox rasterization run on the host; the
backprojection and the world transform run on the frontend's device
(`rgbd.py`); the per-instance gates read the cloud back to the host once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import rgbd


@dataclass
class Detection:
    """One open-vocab detection: class by query string, axis-aligned box."""
    class_name: str
    confidence: float
    box_xyxy: np.ndarray                  # [4] x1 y1 x2 y2 (px)
    mask: Optional[np.ndarray] = None     # [H, W] bool (None -> bbox fill)


@dataclass
class OpenVocabClassInfo:
    """Per-class gates from open_vocab_cls_all.yaml (id, length/height
    cutoffs, Hungarian assignment threshold)."""
    name: str
    class_id: int
    length_cutoff: tuple = (0.0, np.inf)
    height_cutoff: tuple = (0.0, np.inf)
    class_assignment_thresh: float = 1.0


def parse_class_info(cls_yaml: Dict[str, dict]) -> List[OpenVocabClassInfo]:
    """open_vocab_cls_all.yaml layout: {name: {id, length_cutoff,
    height_cutoff, class_assignment_thresh, ...}} -> specs (queries are the
    dict keys, detect_open_vocab.py:34-38)."""
    out = []
    for name, row in cls_yaml.items():
        if not isinstance(row, dict) or "id" not in row:
            continue
        out.append(OpenVocabClassInfo(
            name=name, class_id=int(row["id"]),
            length_cutoff=tuple(row.get("length_cutoff", (0.0, np.inf))),
            height_cutoff=tuple(row.get("height_cutoff", (0.0, np.inf))),
            class_assignment_thresh=float(
                row.get("class_assignment_thresh", 1.0))))
    return out


@dataclass
class OpenVocabFrontend:
    """detector + intrinsics -> labeled clouds (camera or world frame) on
    `device`.

    detect_fn: rgb [H,W,3] uint8 -> list[Detection]; the text queries the
    external model should be primed with are `self.queries` (the
    set_classes mirror)."""
    detect_fn: Callable[[np.ndarray], Sequence[Detection]]
    classes: List[OpenVocabClassInfo]
    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float = 1.0e-3            # k_depth_scaling_factor=1000
    confidence_threshold: float = 0.4      # detect_open_vocab.py:45
    max_depth: float = 10.0
    device: str = "cuda"
    _by_name: Dict[str, OpenVocabClassInfo] = field(default_factory=dict)

    def __post_init__(self):
        self._by_name = {c.name: c for c in self.classes}

    @property
    def queries(self) -> List[str]:
        return [c.name for c in self.classes]

    def process_frame(self, rgb: np.ndarray, depth: np.ndarray,
                      cam_pose7: Optional[np.ndarray] = None
                      ) -> rgbd.LabeledCloud:
        """One RGBD frame -> labeled cloud (world frame if cam_pose7)."""
        H, W = depth.shape
        dets = [d for d in self.detect_fn(rgb)
                if d.class_name in self._by_name
                and d.confidence >= self.confidence_threshold]
        K = max(len(dets), 1)
        masks = np.zeros((K, H, W), bool)
        labels = np.full((K,), -1, np.int32)
        confs = np.zeros((K,), np.float32)
        for i, d in enumerate(dets):
            if d.mask is not None:
                masks[i] = d.mask
            else:
                # Python int truncates toward zero, as the JAX frontend
                x1, y1, x2, y2 = [int(v) for v in d.box_xyxy]
                masks[i, max(y1, 0):min(y2, H), max(x1, 0):min(x2, W)] = True
            labels[i] = self._by_name[d.class_name].class_id
            confs[i] = d.confidence
        dev = torch.device(self.device)
        cloud = rgbd.backproject(
            torch.from_numpy(np.asarray(depth, np.float32)).to(dev),
            torch.from_numpy(masks).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(confs).to(dev),
            self.fx, self.fy, self.cx, self.cy,
            depth_scale=self.depth_scale, max_depth=self.max_depth,
            conf_thresh=self.confidence_threshold)
        if cam_pose7 is not None:
            cloud = rgbd.to_world(cloud, cam_pose7)
        return cloud

    def instance_measurements(self, cloud: rgbd.LabeledCloud,
                              max_points: int = 512):
        """Per-instance (points, mask, class_id, confidence) tuples with the
        class length/height gates applied (the cutoffs the indoor pipeline
        enforces per open_vocab_cls_all.yaml)."""
        cloud = rgbd.host_cloud(cloud)
        inst_ids = np.unique(cloud.instance[cloud.valid])
        out = []
        for iid in inst_ids[inst_ids >= 0]:
            pts, mask = rgbd.instance_points(cloud, int(iid), max_points)
            if mask.sum() < 5:
                continue
            sel = cloud.valid & (cloud.instance == iid)
            cls_id = int(cloud.label[sel][0])
            conf = float(cloud.confidence[sel].mean())
            spec = next((c for c in self.classes if c.class_id == cls_id),
                        None)
            if spec is not None:
                p = pts[mask]
                ext = p.max(axis=0) - p.min(axis=0)
                length = float(np.max(ext[:2]))
                height = float(ext[2])
                if not (spec.length_cutoff[0] <= length <= spec.length_cutoff[1]
                        and spec.height_cutoff[0] <= height
                        <= spec.height_cutoff[1]):
                    continue
            out.append((pts, mask, cls_id, conf))
        return out
