"""Carry a factor-graph state between the JAX package and the port.

`state_from_numpy` takes a JAX GraphState as a dict of numpy arrays (each
field through `np.asarray`) and returns the port's GraphState on `device`,
with the same dtypes (int32 fields stay int32). `state_to_numpy` goes back.
No weights cross: the slice's segmenter is the ground-truth labeller.
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
