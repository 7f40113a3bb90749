"""Training of the range-image segmentator on simulated scans (PyTorch twin
of slide_slam_tpu/frontend/train_segmentation.py).

No released weights can be downloaded, so the net is trained from the
simulator's ground-truth labels: simulated scans are projected to range
images, labelled, and the RangeSegmentator is trained with a masked
cross-entropy and Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8),
batches drawn with numpy's default_rng(seed).integers(0, n, batch) as the
JAX package draws them. Runs on the card by default.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import segmentator_from_flax
from . import range_projection
from .segmentation import RangeSegmentator, init_params


def make_synthetic_dataset(scans, poses, labeler: Callable, height: int,
                           width: int, fov_up_deg: float = 15.0,
                           fov_down_deg: float = -15.0, device="cuda"):
    """(inputs [N, H, W, 5], labels [N, H, W], valid [N, H, W]) as numpy
    arrays. scans: list of [Ni, 3] body-frame clouds; poses: the matching
    sensor poses (the labeler reads its own); labeler: fn([1, H, W, 5]) ->
    [1, H, W] labels."""
    dev = torch.device(device)
    xs, ys, vs = [], [], []
    for pts, _pose in zip(scans, poses):
        pts = torch.as_tensor(np.asarray(pts, np.float32), device=dev)
        n = pts.shape[0]
        ri = range_projection.project(
            pts, torch.zeros(n, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), height=height,
            width=width, fov_up_deg=fov_up_deg, fov_down_deg=fov_down_deg)
        x = torch.movedim(range_projection.make_model_input(ri)[None], 1, -1)
        y = torch.as_tensor(labeler(x))
        xs.append(x[0].cpu().numpy())
        ys.append(y[0].cpu().numpy())
        vs.append(xs[-1][..., 0] > 0)
    return np.stack(xs), np.stack(ys), np.stack(vs)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel softmax cross-entropy over the valid pixels:
    logits [B, H, W, C], labels [B, H, W] ints, valid [B, H, W]."""
    ce = F.cross_entropy(logits.permute(0, 3, 1, 2), labels.long(),
                         reduction="none")
    v = valid.to(ce.dtype)
    return (ce * v).sum() / torch.clamp(v.sum(), min=1.0)


def train_segmentator(model: RangeSegmentator, inputs, labels, valid,
                      steps: int = 200, lr: float = 1e-3, batch: int = 2,
                      seed: int = 0, init_variables: Optional[dict] = None,
                      device="cuda"):
    """Train `model` in place on `device`, starting from `init_variables`
    (flax-layout numpy variables, e.g. the JAX package's init) or, without
    them, from init_params with a torch.Generator seeded with `seed`.
    BatchNorm normalises with batch statistics and updates its running
    ones as flax does. Returns (model in eval mode, metrics)."""
    dev = torch.device(device)
    if init_variables is not None:
        segmentator_from_flax(init_variables, model)
    else:
        init_params(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    inputs = torch.as_tensor(np.asarray(inputs, np.float32), device=dev)
    labels = torch.as_tensor(np.asarray(labels), device=dev).long()
    valid = torch.as_tensor(np.asarray(valid), device=dev)
    order = np.random.default_rng(seed)
    n = len(inputs)
    loss = torch.tensor(float("inf"))
    t0 = time.perf_counter()
    for _ in range(steps):
        idx = torch.as_tensor(order.integers(0, n, batch), device=dev)
        loss = masked_cross_entropy(model(inputs[idx]), labels[idx],
                                    valid[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    final = float(loss.detach())
    model.eval()
    return model, {"final_loss": final, "steps": steps,
                   "seconds": time.perf_counter() - t0}


def mean_iou(pred, true, valid, num_classes: int) -> float:
    """Mean intersection-over-union over the classes present in `true`."""
    pred = np.asarray(pred)[np.asarray(valid)]
    true = np.asarray(true)[np.asarray(valid)]
    ious = []
    for c in range(num_classes):
        t, p = true == c, pred == c
        if t.sum() == 0:
            continue
        ious.append(np.logical_and(t, p).sum()
                    / max(np.logical_or(t, p).sum(), 1))
    return float(np.mean(ious)) if ious else 0.0
