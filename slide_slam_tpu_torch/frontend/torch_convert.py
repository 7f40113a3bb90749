"""Load the reference's torch darknet weights into the port's
RangeSegmentator (PyTorch twin of slide_slam_tpu/frontend/torch_convert.py).

The reference ships RangeNet++ weights as torch state_dicts of Conv2d /
BatchNorm2d modules. They load by (conv, bn) pairs in declaration order
onto the port's ConvBNLeaky modules in the order the JAX package walks its
flax tree: children sorted by (name prefix, index), so the encoder's
`ConvBNLeaky_*` come before its `ResidualBlock_*`, and the encoder before
the decoder. Kernels stay OIHW (the port's layout).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..convert import copy_weight
from .segmentation import ConvBNLeaky


def extract_conv_bn_pairs(state_dict: Dict[str, np.ndarray]
                          ) -> List[Tuple[np.ndarray, dict]]:
    """Ordered (conv_weight, bn_params) pairs from a torch state_dict,
    bn_params = dict(scale, bias, mean, var); assumes conv -> bn with no
    conv bias."""
    items = [(k, np.asarray(v)) for k, v in state_dict.items()]
    pairs = []
    i = 0
    while i < len(items):
        k, v = items[i]
        if k.endswith("weight") and v.ndim == 4:
            conv_w, bn = v, {}
            j = i + 1
            while j < len(items) and len(bn) < 4:
                bk, bv = items[j]
                if bv.ndim == 1 and len(bv) == conv_w.shape[0]:
                    if bk.endswith(".weight"):
                        bn["scale"] = bv
                    elif bk.endswith(".bias"):
                        bn["bias"] = bv
                    elif bk.endswith("running_mean"):
                        bn["mean"] = bv
                    elif bk.endswith("running_var"):
                        bn["var"] = bv
                j += 1
            pairs.append((conv_w, bn))
            i = j if len(bn) == 4 else i + 1
        else:
            i += 1
    return pairs


def _sort_key(name: str):
    m = re.match(r"([A-Za-z]+)_(\d+)", name)
    return (m.group(1), int(m.group(2))) if m else (name, -1)


def conv_bn_modules(model: torch.nn.Module) -> List[Tuple[str, ConvBNLeaky]]:
    """The model's ConvBNLeaky modules in the flax tree's sorted walk."""
    out = []

    def walk(mod, path):
        if isinstance(mod, ConvBNLeaky):
            out.append((path, mod))
            return
        for name, child in sorted(mod.named_children(),
                                  key=lambda kv: _sort_key(kv[0])):
            walk(child, f"{path}.{name}" if path else name)

    walk(model, "")
    return out


def load_torch_weights(model: torch.nn.Module,
                       state_dict: Dict[str, np.ndarray]):
    """Copy the state_dict's (conv, bn) pairs into the model's ConvBNLeaky
    modules in order; shapes must match pairwise (raises otherwise).
    Returns (model, number of pairs loaded)."""
    pairs = extract_conv_bn_pairs(state_dict)
    mods = conv_bn_modules(model)
    n = min(len(pairs), len(mods))
    for (conv_w, bn), (path, mod) in zip(pairs[:n], mods[:n]):
        copy_weight(mod.Conv_0.weight, conv_w, f"{path}.Conv_0")
        for key in ("scale", "bias", "mean", "var"):
            copy_weight(getattr(mod.BatchNorm_0, key), bn[key],
                        f"{path}.BatchNorm_0.{key}")
    return model, n


def load_head_conv(model: torch.nn.Module, weight: np.ndarray,
                   bias: np.ndarray) -> torch.nn.Module:
    """Load the biased 1x1 classification head (the top-level Conv_0) from
    a torch OIHW weight and bias. Returns the model."""
    copy_weight(model.Conv_0.weight, weight, "Conv_0.weight")
    copy_weight(model.Conv_0.bias, bias, "Conv_0.bias")
    return model


def load_crf_compat(state_dict: Dict[str, np.ndarray],
                    prefix: str = "CRF.compat_conv"):
    """The learned CRF class-compatibility 1x1 conv as (compat [C_in, C_out],
    bias [C_out]) float32 tensors for segmentation.crf_refine, which applies
    `msg @ compat + bias`."""
    w = np.asarray(state_dict[f"{prefix}.weight"])        # [C_out, C_in, 1, 1]
    if w.ndim != 4 or w.shape[2:] != (1, 1):
        raise ValueError(f"{prefix}.weight is not a 1x1 conv: {w.shape}")
    compat = np.ascontiguousarray(w[:, :, 0, 0].T.astype(np.float32))
    b = state_dict.get(f"{prefix}.bias")
    bias = (np.zeros((compat.shape[1],), np.float32) if b is None
            else np.asarray(b, np.float32))
    return torch.from_numpy(compat), torch.from_numpy(bias)
