"""Checkpoint / resume of the full SLAM state (PyTorch twin of
slide_slam_tpu/io/checkpoint.py).

The reference has NO runtime recovery: a crashed sloam_node restarts empty
and loses its own history (SURVEY §5). Here the engine state is a NamedTuple
of tensors, so checkpointing is a snapshot: the GraphState goes to one
compressed `graph.npz` and the host database (packets, bookmarks, TF table,
maps) to `node.json`.

Both files keep the JAX package's format: the 44 GraphState fields under
their names and dtypes, and the same JSON keys, so a checkpoint written by
either package loads into the other. The port's node also keeps counters
that neither file has a key for (keyframes since the last mirror refresh and
since the last full solve, buffered relative sightings, the closure
bookkeeping); `save_node` writes them to a third file, `runtime.json`, which
the JAX loader ignores. The file carries the key of the snapshot it belongs
to (the keyframe count and the last keyframe stamp of `node.json`):
`load_node` applies it only when that key matches, since the JAX `save_node`
rewrites the other two files and leaves a port's older `runtime.json`
beside them. Without a matching file (a JAX checkpoint) the counters start
afresh, as they do in the JAX node.
"""
from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..factorgraph.graph import GraphState

if TYPE_CHECKING:
    from ..runtime.node import SlamNode


def save_graph_state(path: str, state: GraphState):
    np.savez_compressed(path, **{f: getattr(state, f).cpu().numpy()
                                 for f in state._fields})


def load_graph_state(path: str, device="cuda") -> GraphState:
    """Every field on `device` with the dtype it was saved with (f32, int32
    slots and counters, bool prior_valid)."""
    with np.load(path) as z:
        return GraphState(**{f: torch.from_numpy(z[f]).to(device)
                             for f in GraphState._fields})


def _packet_to_dict(p):
    return {k: np.asarray(getattr(p, k)).tolist() if k != "stamp" else p.stamp
            for k in p.__dataclass_fields__}


def _snapshot_key(key_stamps) -> list:
    """What ties runtime.json to its node.json: keyframe count, last stamp."""
    return [len(key_stamps), key_stamps[-1] if key_stamps else None]


def _runtime_to_dict(node: "SlamNode") -> dict:
    return {
        "snapshot": _snapshot_key(node.key_stamps),
        "kf_since_refresh": node._kf_since_refresh,
        "kf_since_full_solve": node._kf_since_full_solve,
        "feasible_relative_meas": [
            {"stamp": m.stamp,
             "relative_pose": np.asarray(m.relative_pose).tolist(),
             "robot_index": int(m.robot_index),
             "odom_pose": np.asarray(m.odom_pose).tolist(),
             "only_use_odom": bool(m.only_use_odom)}
            for m in node.feasible_relative_meas],
        "pending_inter_tf": {str(k): [np.asarray(tf).tolist(), int(n)]
                             for k, (tf, n) in node._pending_inter_tf.items()},
        "last_intra_attempt_pose": node.last_intra_attempt_pose,
        "last_intra_success_stamp": float(node.last_intra_success_stamp),
        "last_intra_attempt_stamp": node._last_intra_attempt_stamp,
        "counters": {k: getattr(node, k) for k in (
            "num_attempts_intra", "num_success_intra", "num_attempts_inter",
            "num_success_inter", "num_rel_factors")},
    }


def _restore_runtime(node: "SlamNode", rt: dict):
    from ..runtime.scheduler import RelativeMeas

    node._kf_since_refresh = int(rt["kf_since_refresh"])
    node._kf_since_full_solve = int(rt["kf_since_full_solve"])
    node.feasible_relative_meas = [
        RelativeMeas(stamp=float(m["stamp"]),
                     relative_pose=np.asarray(m["relative_pose"], np.float32),
                     robot_index=int(m["robot_index"]),
                     odom_pose=np.asarray(m["odom_pose"], np.float32),
                     only_use_odom=bool(m["only_use_odom"]))
        for m in rt["feasible_relative_meas"]]
    node._pending_inter_tf = {
        int(k): (np.asarray(tf, np.float32), int(n))
        for k, (tf, n) in rt["pending_inter_tf"].items()}
    node.last_intra_attempt_pose = int(rt["last_intra_attempt_pose"])
    node.last_intra_success_stamp = float(rt["last_intra_success_stamp"])
    node._last_intra_attempt_stamp = rt["last_intra_attempt_stamp"]
    for k, v in rt["counters"].items():
        setattr(node, k, int(v))


def save_node(dirpath: str, node: "SlamNode"):
    """Full node snapshot: device graph + host database + bookkeeping."""
    os.makedirs(dirpath, exist_ok=True)
    # a background pose fetch still in flight belongs in the mirrors
    node.collect_pose_refresh(block=True)
    save_graph_state(os.path.join(dirpath, "graph.npz"), node.state)

    db = {}
    for rid, rec in node.dbm.records.items():
        db[str(rid)] = {
            "bookmark_fg": rec.bookmark_fg,
            "packets": [_packet_to_dict(p) for p in rec.packets],
        }
    meta = {
        "robot_id": node.robot_id,
        "key_stamps": node.key_stamps,
        "key_poses": [p.tolist() for p in node.key_poses],
        "latest_odom": (node.latest_odom.tolist()
                        if node.latest_odom is not None else None),
        "loop_closure_tf": {str(k): v.tolist()
                            for k, v in node.dbm.loop_closure_tf.items()},
        "maps": {str(k): v.tolist() for k, v in node.dbm.maps.items()},
        "db": db,
    }
    with open(os.path.join(dirpath, "node.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(dirpath, "runtime.json"), "w") as f:
        json.dump(_runtime_to_dict(node), f)


def load_node(dirpath: str, cfg, node_cls=None, device="cuda",
              **node_kwargs) -> "SlamNode":
    """A node restored from `dirpath` on `device` (node_kwargs go to the
    node's constructor, e.g. a worker pool)."""
    from ..comm.database import PoseMstPair, RobotRecord
    from ..runtime.node import SlamNode

    node_cls = node_cls or SlamNode
    with open(os.path.join(dirpath, "node.json")) as f:
        meta = json.load(f)
    node = node_cls(cfg, robot_id=int(meta["robot_id"]), device=device,
                    **node_kwargs)
    node.state = load_graph_state(os.path.join(dirpath, "graph.npz"),
                                  device=node.device)
    node.key_stamps = list(meta["key_stamps"])
    node.key_poses = [np.asarray(p, np.float32) for p in meta["key_poses"]]
    node.latest_odom = (np.asarray(meta["latest_odom"], np.float32)
                        if meta["latest_odom"] is not None else None)
    node.dbm.loop_closure_tf = {
        int(k): np.asarray(v, np.float32)
        for k, v in meta["loop_closure_tf"].items()}
    node.dbm.maps = {int(k): np.asarray(v, np.float32).reshape(-1, 7)
                     for k, v in meta["maps"].items()}
    node.dbm.records = {}
    for rid, rec in meta["db"].items():
        rr = RobotRecord(bookmark_fg=int(rec["bookmark_fg"]))
        for pd in rec["packets"]:
            rr.packets.append(PoseMstPair(
                stamp=float(pd["stamp"]),
                **{k: np.asarray(pd[k],
                                 np.int32 if k.endswith("label") else np.float32)
                   for k in pd if k != "stamp"}))
        node.dbm.records[int(rid)] = rr
    node.rebuild_mirrors()
    rt_path = os.path.join(dirpath, "runtime.json")
    if os.path.exists(rt_path):
        with open(rt_path) as f:
            rt = json.load(f)
        if rt.get("snapshot") == _snapshot_key(meta["key_stamps"]):
            _restore_runtime(node, rt)
    return node
