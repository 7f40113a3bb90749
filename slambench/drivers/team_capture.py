"""What a team run's closure and merge decisions were, kept for the team
judge (slambench/judges/team_decisions.py).

`install()` wraps, in this process only, the program's SlideMatch entry
points, its search and its raster kernel, its SlideGraph entry point with
its votes and CLIPPER's inliers, and a node's merge acceptance and merge
polish, and keeps for each call its host inputs and the program's outputs
(the raster's packed result stays a reference to the program's own
tensor).
Nothing is judged or read back from the device while the program runs.
Calls nest per thread: a kernel, votes or inliers belong to the entry
point open on their thread. Each merge call and polish names its node by
robot id (`node`) and by instance (`instance`, numbered in the order the
capture first sees a node), so that the episodes of one capture, whose
nodes share robot ids, are told apart.

`settings()` states the program's closure and merge settings in the form
the judge reads from a configuration.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import threading
import weakref

import numpy as np


def _copy(a):
    return None if a is None else np.array(a, copy=True)


class Capture:
    """`rec` holds `searches` (SlideMatch and SlideGraph calls), `merges`
    (a node's acceptance calls, in order) and `refines` (merge polishes).
    `close()` restores what `install()` wrapped."""

    def __init__(self):
        self.rec = {"searches": [], "merges": [], "refines": []}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._restore = []
        self._instances = weakref.WeakKeyDictionary()
        self._serial = itertools.count()

    def _instance(self, node) -> int:
        """`node`'s number in this capture, the same for each of its calls."""
        with self._lock:
            if node not in self._instances:
                self._instances[node] = next(self._serial)
            return self._instances[node]

    def _open(self):
        return getattr(self._local, "open", None)

    def _entry(self, record: dict, call):
        """Run `call` with `record` open on this thread, then keep both."""
        outer = self._open()
        self._local.open = record
        try:
            out = call()
        finally:
            self._local.open = outer
        record["out"] = out
        with self._lock:
            self.rec["searches"].append(record)
        return out

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._restore.append((owner, name, orig))

    def install(self, slidematch, slidegraph, node):
        """Wrap the program's modules `slidematch`, `slidegraph` (its
        place_recognition modules) and `node` (runtime.node)."""
        cap = self
        pr_cls, sg_cls, node_cls = (slidematch.PlaceRecognition,
                                    slidegraph.SlideGraph, node.SlamNode)

        def intra(orig):
            def wrapped(self, measurements, submap, query_pose,
                        candidate_pose):
                rec = dict(kind="slidematch_intra", kernels=[],
                           inputs=dict(measurements=_copy(measurements),
                                       submap=_copy(submap),
                                       query_pose=_copy(query_pose),
                                       candidate_pose=_copy(candidate_pose)))
                return cap._entry(rec, lambda: orig(
                    self, measurements, submap, query_pose, candidate_pose))
            return wrapped

        def inter(orig):
            def wrapped(self, reference_map, query_map):
                rec = dict(kind="slidematch_inter", kernels=[],
                           inputs=dict(reference_map=_copy(reference_map),
                                       query_map=_copy(query_map)))
                return cap._entry(rec, lambda: orig(self, reference_map,
                                                    query_map))
            return wrapped

        def transform(orig):
            def wrapped(self, reference_objects, query_objects, intra):
                out = orig(self, reference_objects, query_objects, intra)
                rec = cap._open()
                if rec is not None and "kernels" in rec:
                    rec["transform"] = dict(found=bool(out[0]),
                                            n_inliers=int(out[3]),
                                            fit=(int(out[4][0]),
                                                 float(out[4][1])))
                return out
            return wrapped

        def kernel(orig):
            def wrapped(dims, ref, ref_mask, qry, qry_mask, *a, **k):
                packed = orig(dims, ref, ref_mask, qry, qry_mask, *a, **k)
                rec = cap._open()
                if rec is not None and "kernels" in rec:
                    rec["kernels"].append(dict(ref=ref, packed=packed))
                return packed
            return wrapped

        def graph(orig):
            def wrapped(self, reference_map, query_map, seed=0):
                rec = dict(kind="slidegraph", votes=None, inliers=None,
                           inputs=dict(reference_map=_copy(reference_map),
                                       query_map=_copy(query_map),
                                       seed=int(seed)))
                return cap._entry(rec, lambda: orig(self, reference_map,
                                                    query_map, seed))
            return wrapped

        def votes(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                rec = cap._open()
                if rec is not None and "votes" in rec:
                    rec["votes"] = np.array(out[0], copy=True)
                return out
            return wrapped

        def clique(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                rec = cap._open()
                if rec is not None and "inliers" in rec:
                    rec["inliers"] = np.array(out, copy=True)
                return out
            return wrapped

        def accept(orig):
            def wrapped(self, found):
                rec = dict(node=int(self.robot_id),
                           instance=cap._instance(self),
                           known=sorted(int(r) for r in
                                        self.dbm.loop_closure_tf),
                           found=[(int(r), _copy(tf))
                                  for r, tf in found.items()])
                ids = orig(self, found)
                rec["accepted"] = [int(r) for r in ids]
                with cap._lock:
                    cap.rec["merges"].append(rec)
                return ids
            return wrapped

        def polish(orig):
            def wrapped(self, rid, tf7):
                rec = dict(node=int(self.robot_id),
                           instance=cap._instance(self), peer=int(rid),
                           tf_in=_copy(tf7),
                           own=_copy(self.dbm.get_robot_map(self.robot_id)),
                           peer_map=_copy(self.dbm.get_robot_map(rid)))
                out = orig(self, rid, tf7)
                rec["tf_out"] = _copy(out)
                with cap._lock:
                    cap.rec["refines"].append(rec)
                return out
            return wrapped

        self._patch(pr_cls, "find_intra_loop_closure", intra)
        self._patch(pr_cls, "find_inter_loop_closure", inter)
        self._patch(pr_cls, "find_transformation", transform)
        self._patch(slidematch, "_slidematch_kernel", kernel)
        self._patch(sg_cls, "find_inter_loop_closure", graph)
        self._patch(slidegraph, "vote_associations", votes)
        self._patch(slidegraph, "dense_clique_inliers", clique)
        self._patch(node_cls, "_apply_inter_result", accept)
        self._patch(node_cls, "_refine_inter_tf", polish)
        return self

    def close(self):
        while self._restore:
            owner, name, orig = self._restore.pop()
            setattr(owner, name, orig)


def settings(scfg, dims=None) -> dict:
    """The judge's `closures` group from the program's SlamConfig (and
    SlideMatchDims, the raster's grid), for a run that builds its program
    from its own objects; a configuration file states the same keys."""
    from slide_slam_tpu_torch.place_recognition import clipper, slidegraph
    from slide_slam_tpu_torch.place_recognition.slidematch import \
        SlideMatchDims
    dims = dims or SlideMatchDims()
    cp = clipper.ClipperParams(sigma=scfg.slidegraph.sigma,
                               epsilon=scfg.slidegraph.epsilon)
    cap = inspect.signature(slidegraph.run_semantic_clipper).parameters[
        "max_associations"].default
    return {
        "use_slidematch": bool(scfg.use_slidematch),
        "place_recognition": dataclasses.asdict(scfg.place_recognition),
        "grid": {"fine_grid": dims.fine_grid,
                 "disk_radius_cells": dims.disk_radius_cells,
                 "n_yaw": dims.n_yaw},
        "slidegraph": dataclasses.asdict(scfg.slidegraph),
        "clipper": dict(cp._asdict()),
        "max_associations": int(cap),
        "merge": {"inter_tf_confirmations": scfg.inter_tf_confirmations,
                  "inter_tf_confirm_pos": scfg.inter_tf_confirm_pos,
                  "inter_tf_confirm_yaw_deg": scfg.inter_tf_confirm_yaw_deg,
                  "polish_iters": 4, "polish_min_objects": 5,
                  "polish_min_pairs": 5},
    }
