"""ctypes binding to the C++ runtime core (PyTorch port's copy of
slide_slam_tpu/native.py).

The sources are the repository's native/runtime_core.cpp and
native/graph_algos.cpp: measurement queues with PickNextMeasurementToAdd,
the packet wire codec, and the exact and heuristic max-clique and
densest-subgraph solvers. They are built with g++ at first use into
slide_slam_tpu_torch/_build/ (listed in .gitignore), under a name that
carries a hash of the sources and flags, so an edited source is rebuilt
and the JAX package's native/libslideslam_runtime.so is never touched.
Where g++ or the sources are missing, `available()` reads False and the
callers (runtime/input_manager.py) keep the Python queues, as in the JAX
package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
_SRCS = [_ROOT / "native" / "runtime_core.cpp",
         _ROOT / "native" / "graph_algos.cpp"]
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslideslam_runtime-{h.hexdigest()[:12]}.so"


def _build() -> Optional[Path]:
    """The library, compiled unless an up-to-date one exists; None where
    the sources or g++ are missing or the build fails."""
    try:
        out = library_path()
    except OSError:
        return None
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, *map(str, _SRCS), "-o", str(tmp)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ssq_create.restype = ctypes.c_void_p
        lib.ssq_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ssq_destroy.argtypes = [ctypes.c_void_p]
        lib.ssq_push_odom.argtypes = [ctypes.c_void_p, ctypes.c_double, f32p]
        h, d = ctypes.c_void_p, ctypes.c_double
        lib.ssq_push_observation.argtypes = [h, d, f32p, ctypes.c_int64]
        lib.ssq_push_relative.argtypes = [h, d, f32p, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int]
        lib.ssq_set_latest_odom.argtypes = [h, d, f32p]
        lib.ssq_pick_next.restype = ctypes.c_int
        lib.ssq_pick_next.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_double, f64p,
                                      f32p, i64p, i32p, i32p]
        lib.ssq_pop_front.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ssq_sizes.argtypes = [ctypes.c_void_p, i32p, i32p, i32p]
        lib.ssc_encode_packet.restype = ctypes.c_int64
        lib.ssc_encode_packet.argtypes = [
            ctypes.c_double, f32p, f32p,
            ctypes.c_int, f32p, i32p,
            ctypes.c_int, f32p, i32p,
            ctypes.c_int, f32p, i32p,
            u8p, ctypes.c_int64]
        lib.ssc_packet_counts.restype = ctypes.c_int64
        lib.ssc_packet_counts.argtypes = [u8p, ctypes.c_int64, i32p, i32p,
                                          i32p]
        lib.ssc_decode_packet.restype = ctypes.c_int64
        lib.ssc_decode_packet.argtypes = [u8p, ctypes.c_int64, f64p, f32p,
                                          f32p, f32p, i32p, f32p, i32p, f32p,
                                          i32p]
        lib.ssg_max_clique.restype = ctypes.c_int32
        lib.ssg_max_clique.argtypes = [ctypes.c_int32, u8p, ctypes.c_double,
                                       ctypes.c_int32, i32p]
        lib.ssg_densest_subgraph.restype = ctypes.c_int32
        lib.ssg_densest_subgraph.argtypes = [ctypes.c_int32, ctypes.c_int64,
                                             i32p, i32p, f64p, i32p, f64p]
        _lib = lib
        return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeQueues:
    """C++ measurement queues + PickNextMeasurementToAdd."""

    KIND_NONE, KIND_ODOM, KIND_OBS, KIND_REL = 0, 1, 2, 3

    def __init__(self, max_odom=2000, max_obs=200):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime not available (no g++?)")
        self._h = self._lib.ssq_create(max_odom, max_obs)
        self._payloads = {}
        self._next_payload = 0

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ssq_destroy(self._h)
        except Exception:
            pass

    def _store(self, obj) -> int:
        pid = self._next_payload
        self._next_payload += 1
        self._payloads[pid] = obj
        return pid

    def push_odom(self, stamp: float, pose: np.ndarray):
        pose = np.ascontiguousarray(pose, np.float32)
        self._lib.ssq_push_odom(self._h, stamp, _fp(pose))

    def push_observation(self, stamp: float, pose: np.ndarray, obs):
        pose = np.ascontiguousarray(pose, np.float32)
        self._lib.ssq_push_observation(self._h, stamp, _fp(pose),
                                       self._store(obs))

    def push_relative(self, stamp: float, pose: np.ndarray, meas,
                      robot_index: int, only_use_odom: bool):
        pose = np.ascontiguousarray(pose, np.float32)
        self._lib.ssq_push_relative(self._h, stamp, _fp(pose),
                                    self._store(meas), robot_index,
                                    int(only_use_odom))

    def set_latest_odom(self, stamp: float, pose: np.ndarray):
        pose = np.ascontiguousarray(pose, np.float32)
        self._lib.ssq_set_latest_odom(self._h, stamp, _fp(pose))

    def pick_next(self, current_time: float, msg_delay_tolerance: float,
                  min_odom_distance: float):
        """Returns (kind, stamp, pose, payload_obj_or_None)."""
        stamp = ctypes.c_double()
        pose = np.zeros(7, np.float32)
        payload = ctypes.c_int64(-1)
        ridx = ctypes.c_int32(-1)
        oodom = ctypes.c_int32(0)
        kind = self._lib.ssq_pick_next(
            self._h, current_time, msg_delay_tolerance, min_odom_distance,
            ctypes.byref(stamp), _fp(pose), ctypes.byref(payload),
            ctypes.byref(ridx), ctypes.byref(oodom))
        obj = self._payloads.get(payload.value) if payload.value >= 0 else None
        return kind, stamp.value, pose, obj

    def pop(self, kind: int):
        self._lib.ssq_pop_front(self._h, kind)

    def sizes(self):
        a, b, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        self._lib.ssq_sizes(self._h, ctypes.byref(a), ctypes.byref(b),
                            ctypes.byref(c))
        return a.value, b.value, c.value


def encode_packet(packet) -> bytes:
    """PoseMstPair -> wire bytes (C codec)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native runtime not available")
    nc = len(packet.cyl_radius)
    nk = len(packet.cub_label)
    ne = len(packet.ell_label)
    cyl = np.ascontiguousarray(np.concatenate([
        packet.cyl_root.reshape(nc, 3), packet.cyl_ray.reshape(nc, 3),
        packet.cyl_radius.reshape(nc, 1)], axis=1), np.float32) \
        if nc else np.zeros((0, 7), np.float32)
    cub = np.ascontiguousarray(np.concatenate([
        packet.cub_pose.reshape(nk, 7), packet.cub_scale.reshape(nk, 3)],
        axis=1), np.float32) if nk else np.zeros((0, 10), np.float32)
    ell = np.ascontiguousarray(np.concatenate([
        packet.ell_pose.reshape(ne, 7), packet.ell_scale.reshape(ne, 3)],
        axis=1), np.float32) if ne else np.zeros((0, 10), np.float32)
    cap = 8 + 56 + 12 + nc * 32 + nk * 44 + ne * 44 + 64
    out = np.zeros(cap, np.uint8)
    key_pose = np.ascontiguousarray(packet.key_pose, np.float32)
    rel = np.ascontiguousarray(packet.rel_odom, np.float32)
    cl = np.ascontiguousarray(packet.cyl_label, np.int32)
    kl = np.ascontiguousarray(packet.cub_label, np.int32)
    el = np.ascontiguousarray(packet.ell_label, np.int32)
    n = lib.ssc_encode_packet(
        packet.stamp, _fp(key_pose), _fp(rel),
        nc, _fp(cyl), _ip(cl), nk, _fp(cub), _ip(kl), ne, _fp(ell), _ip(el),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError("encode buffer too small")
    return bytes(out[:n])


def decode_packet(data: bytes):
    """Wire bytes -> PoseMstPair."""
    from .comm.database import PoseMstPair

    lib = load()
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    nc, nk, ne = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    used = lib.ssc_packet_counts(bp, len(buf), ctypes.byref(nc),
                                 ctypes.byref(nk), ctypes.byref(ne))
    if used < 0:
        raise ValueError("corrupt packet")
    nc, nk, ne = nc.value, nk.value, ne.value
    stamp = ctypes.c_double()
    key_pose = np.zeros(7, np.float32)
    rel = np.zeros(7, np.float32)
    cyl = np.zeros((max(nc, 1), 7), np.float32)
    cl = np.zeros(max(nc, 1), np.int32)
    cub = np.zeros((max(nk, 1), 10), np.float32)
    kl = np.zeros(max(nk, 1), np.int32)
    ell = np.zeros((max(ne, 1), 10), np.float32)
    el = np.zeros(max(ne, 1), np.int32)
    lib.ssc_decode_packet(bp, len(buf), ctypes.byref(stamp), _fp(key_pose),
                          _fp(rel), _fp(cyl), _ip(cl), _fp(cub), _ip(kl),
                          _fp(ell), _ip(el))
    return PoseMstPair(
        stamp=stamp.value, key_pose=key_pose, rel_odom=rel,
        cyl_root=cyl[:nc, 0:3].copy(), cyl_ray=cyl[:nc, 3:6].copy(),
        cyl_radius=cyl[:nc, 6].copy(), cyl_label=cl[:nc].copy(),
        cub_pose=cub[:nk, 0:7].copy(), cub_scale=cub[:nk, 7:10].copy(),
        cub_label=kl[:nk].copy(),
        ell_pose=ell[:ne, 0:7].copy(), ell_scale=ell[:ne, 7:10].copy(),
        ell_label=el[:ne].copy(),
    )


def max_clique(adjacency: np.ndarray, method: str = "exact",
               time_limit_s: float = 3600.0) -> np.ndarray:
    """Maximum clique of a 0/1 adjacency matrix via the native solver.

    method: 'exact' (branch & bound, the reference's Method::EXACT),
    'heu' (greedy), 'kcore' (max-core vertices, Method::KCORE);
    mirrors clipper_semantic_object maxclique.cpp:46-147."""
    lib = load()
    if lib is None:
        raise RuntimeError("native runtime not available")
    a = np.ascontiguousarray((np.asarray(adjacency) != 0), np.uint8)
    n = a.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    out = np.zeros(n, np.int32)
    code = {"exact": 0, "heu": 1, "kcore": 2}[method]
    sz = lib.ssg_max_clique(
        n, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        float(time_limit_s), code, _ip(out))
    return np.sort(out[:abs(sz)].copy())


def densest_subgraph(affinity: np.ndarray,
                     subset: Optional[np.ndarray] = None):
    """Exact densest subgraph (max_S w(S)/|S|) of a weighted symmetric
    affinity matrix; optionally restricted to `subset` vertices. Returns
    (nodes, density). Mirrors clipper dsd.cpp:273-311 (Goldberg + Dinic)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native runtime not available")
    A = np.asarray(affinity, np.float64)
    n = A.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32), 0.0
    if subset is not None:
        keep = np.zeros(n, bool)
        keep[np.asarray(subset, np.int64)] = True
        mask = np.outer(keep, keep)
        A = np.where(mask, A, 0.0)
    iu, ju = np.triu_indices(n, k=1)
    w = np.maximum(A, A.T)[iu, ju]
    nz = w > 0
    ei = np.ascontiguousarray(iu[nz], np.int32)
    ej = np.ascontiguousarray(ju[nz], np.int32)
    wv = np.ascontiguousarray(w[nz], np.float64)
    out = np.zeros(n, np.int32)
    dens = ctypes.c_double()
    cnt = lib.ssg_densest_subgraph(
        n, len(wv), _ip(ei), _ip(ej),
        wv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ip(out), ctypes.byref(dens))
    return np.sort(out[:cnt].copy()), dens.value


def available() -> bool:
    return load() is not None
