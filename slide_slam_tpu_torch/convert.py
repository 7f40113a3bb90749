"""Carry a factor-graph state and segmentation weights between the JAX
package and the port.

`state_from_numpy` takes a JAX GraphState as a dict of numpy arrays (each
field through `np.asarray`) and returns the port's GraphState on `device`,
with the same dtypes (int32 fields stay int32). `state_to_numpy` goes back.
`segmentator_from_flax` copies a flax RangeSegmentator's variables (as numpy
arrays) onto the port's module by path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .factorgraph.graph import GraphState


def state_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> GraphState:
    missing = set(GraphState._fields) - set(d)
    if missing:
        raise KeyError(f"state dict lacks fields {sorted(missing)}")
    return GraphState(**{
        k: torch.as_tensor(np.array(d[k], copy=True), device=device)
        for k in GraphState._fields})


def state_to_numpy(s: GraphState) -> Dict[str, np.ndarray]:
    return {k: getattr(s, k).detach().cpu().numpy() for k in GraphState._fields}


# flax leaf name -> (the port's attribute, HWIO kernel?)
_FLAX_LEAVES = {("params", "kernel"): ("weight", True),
                ("params", "bias"): ("bias", False),
                ("params", "scale"): ("scale", False),
                ("batch_stats", "mean"): ("mean", False),
                ("batch_stats", "var"): ("var", False)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def copy_weight(t: torch.Tensor, value: np.ndarray, where: str):
    """Copy `value` into the parameter or buffer `t` as f32; the shapes must
    match (raises otherwise)."""
    value = np.asarray(value, np.float32)
    if tuple(t.shape) != value.shape:
        raise ValueError(f"{where}: model {tuple(t.shape)} vs weights "
                         f"{value.shape}")
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def segmentator_from_flax(variables_np: dict, model: torch.nn.Module
                          ) -> torch.nn.Module:
    """Copy flax variables {"params": ..., "batch_stats": ...} (numpy leaves,
    HWIO conv kernels) onto the port's RangeSegmentator, whose submodules
    carry the flax names; conv kernels become OIHW. Every leaf must find its
    tensor with the same shape and every tensor of the module must be
    written, else it raises. Returns the model."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    written = set()
    for (collection, *mods, leaf), value in _leaves(variables_np):
        attr, hwio = _FLAX_LEAVES[(collection, leaf)]
        name = ".".join(mods + [attr])
        if name not in targets:
            raise KeyError(f"flax leaf {collection}/{'/'.join(mods)}/{leaf} "
                           f"has no tensor {name} in the model")
        if hwio:
            value = np.transpose(value, (3, 2, 0, 1))
        copy_weight(targets[name], value, name)
        written.add(name)
    missing = set(targets) - written
    if missing:
        raise KeyError(f"flax variables lack {sorted(missing)}")
    return model
