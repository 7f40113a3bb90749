"""Which inter-robot merges a node accepts, worked out again from the
transforms its searches found, in the order they were found.

The rule (SlamConfig.inter_tf_confirmations, the port's addition to
upstream's interLoopClosureThread_, sloamNode.cpp:578-697): a peer whose
transform the node already holds is passed over. With `need` = 1 a found
transform is accepted at once. Otherwise the node keeps, for each peer,
the last transform found and how many consistent detections in a row it
has: a detection consistent with the kept one (the relative transform
moves by at most `inter_tf_confirm_pos` metres and turns by at most
`inter_tf_confirm_yaw_deg` about z) raises the count and replaces the
kept transform; an inconsistent one starts the count again at 1; the
detection that brings the count to `need` is accepted, and the peer's
entry is dropped.

Transforms are [qw, qx, qy, qz, tx, ty, tz].
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .precision import exact
from .slidematch import pose_matrix


def relative(a, b, rnd=exact) -> Tuple[float, float]:
    """(translation norm, |yaw|) of inv(A) @ B."""
    A, B = pose_matrix(a), pose_matrix(b)
    A[:3, 3], B[:3, 3] = rnd(A[:3, 3]), rnd(B[:3, 3])
    D = np.linalg.inv(A) @ B
    return float(np.linalg.norm(D[:3, 3])), abs(float(np.arctan2(D[1, 0],
                                                               D[0, 0])))


def accepted_merges(calls: Sequence[dict], rule: dict, rnd=exact):
    """One node's calls in order, each {"known": peers whose transform the
    node held as it began, "found": [(peer, tf7), ...] in order}: the
    peers each call accepts, and the smallest margin of any consistency
    test to its tolerances (a test decided by less is on a knife edge)."""
    need = rule["inter_tf_confirmations"]
    pos, yaw = rule["inter_tf_confirm_pos"], np.deg2rad(
        rule["inter_tf_confirm_yaw_deg"])
    pending: Dict[int, Tuple[np.ndarray, int]] = {}
    out: List[List[int]] = []
    edge = np.inf
    for call in calls:
        held = set(call["known"])
        ids = []
        for rid, tf in call["found"]:
            if rid in held:
                continue
            if need > 1:
                pend = pending.get(rid)
                consistent = False
                if pend is not None:
                    dp, dy = relative(pend[0], tf, rnd)
                    edge = min(edge, abs(dp - pos), abs(dy - yaw))
                    consistent = dp <= pos and dy <= yaw
                if not consistent:
                    pending[rid] = (tf, 1)
                    continue
                if pend[1] + 1 < need:
                    pending[rid] = (tf, pend[1] + 1)
                    continue
                pending.pop(rid, None)
            held.add(rid)
            ids.append(rid)
        out.append(ids)
    return out, edge
