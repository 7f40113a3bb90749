"""Pure-python ROS1 bag ingestion (no ROS installation required); a copy of
slide_slam_tpu/io/rosbag.py on the stdlib and numpy, over the port's own
Keyframe / RobotLog (io.synthetic) and RelativeMeas (runtime.scheduler).

The reference consumes its released demo data as rosbags replayed through
roslaunch (multi_robot_utils_launch/script/tmux_multi_robot_with_bags_*.sh);
the backend subscribes to `/robotN/semantic_meas_sync_odom`
(sloam_msgs/SemanticMeasSyncOdom.msg) and
`/relative_inter_robot_meas_sync` (RelativeInterRobotMeasurementOdom.msg).
This module reads those bags directly — a from-scratch rosbag **V2.0**
format parser plus a message deserializer *driven by the message-definition
text embedded in each bag connection record* — and converts the streams
into this package's npz `RobotLog` format, removing ROS from the data path
entirely.

Format notes (rosbag V2.0, public spec):
  file = magic line + records; record = u32 header_len, header fields
  (`u32 len, name=value`), u32 data_len, data. Record kinds by `op` byte:
  0x03 bag header, 0x05 chunk (none/bz2/lz4 compressed inner records),
  0x07 connection (topic + type + md5 + full message definition),
  0x02 message data, 0x04/0x06 index (ignored — this reader streams
  chunks, so truncated/index-less bags still load).

Also provides `write_bag` — a minimal conformant writer used to build test
fixtures and to re-export logs as bags for the reference stack.
"""
from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

# ---------------------------------------------------------------------------
# Message-definition registry + (de)serializer
# ---------------------------------------------------------------------------

_PRIMITIVES = {
    "bool": ("B", 1), "int8": ("b", 1), "uint8": ("B", 1), "byte": ("b", 1),
    "char": ("B", 1), "int16": ("<h", 2), "uint16": ("<H", 2),
    "int32": ("<i", 4), "uint32": ("<I", 4), "int64": ("<q", 8),
    "uint64": ("<Q", 8), "float32": ("<f", 4), "float64": ("<d", 8),
}
_NP_DTYPES = {
    "bool": np.uint8, "int8": np.int8, "uint8": np.uint8, "byte": np.int8,
    "char": np.uint8, "int16": np.int16, "uint16": np.uint16,
    "int32": np.int32, "uint32": np.uint32, "int64": np.int64,
    "uint64": np.uint64, "float32": np.float32, "float64": np.float64,
}


@dataclass
class _Field:
    name: str
    type: str               # resolved full type name or primitive
    array_len: Optional[int] = None   # None = scalar, -1 = var array, N = fixed


@dataclass
class _MsgSpec:
    full_name: str
    fields: List[_Field] = field(default_factory=list)


class TypeRegistry:
    """Message specs keyed by full type name ('pkg/Name')."""

    def __init__(self):
        self.specs: Dict[str, _MsgSpec] = {}

    def parse_definition(self, full_name: str, text: str):
        """Parse a connection-record `message_definition`: the main type's
        body followed by `====`-separated `MSG: pkg/Name` dependency blocks
        (gendeps --cat output, what rosbag embeds)."""
        blocks = text.split("=" * 80)
        names = [full_name]
        bodies = [blocks[0]]
        for blk in blocks[1:]:
            lines = blk.strip("\n").split("\n")
            header = lines[0].strip()
            if header.startswith("MSG:"):
                names.append(header[4:].strip())
                bodies.append("\n".join(lines[1:]))
        for name, body in zip(names, bodies):
            self._parse_block(name, body)

    def _parse_block(self, full_name: str, body: str):
        pkg = full_name.split("/")[0] if "/" in full_name else ""
        spec = _MsgSpec(full_name)
        for raw in body.split("\n"):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            ftype, rest = parts
            if "=" in rest:      # constant declaration
                continue
            fname = rest.strip()
            alen: Optional[int] = None
            if ftype.endswith("]"):
                base, dim = ftype[:-1].rsplit("[", 1)
                ftype = base
                alen = -1 if dim == "" else int(dim)
            ftype = self._resolve(ftype, pkg)
            spec.fields.append(_Field(fname, ftype, alen))
        self.specs[full_name] = spec

    @staticmethod
    def _resolve(ftype: str, pkg: str) -> str:
        if ftype in _PRIMITIVES or ftype in ("string", "time", "duration"):
            return ftype
        if "/" in ftype:
            return ftype
        if ftype == "Header":
            return "std_msgs/Header"
        return f"{pkg}/{ftype}" if pkg else ftype

    # -- deserialize --------------------------------------------------------

    def read(self, full_name: str, buf: bytes, offset: int = 0):
        val, _ = self._read(full_name, buf, offset)
        return val

    def _read(self, ftype: str, buf: bytes, o: int):
        if ftype == "string":
            (n,) = struct.unpack_from("<I", buf, o)
            return buf[o + 4:o + 4 + n].decode("utf-8", "replace"), o + 4 + n
        if ftype in ("time", "duration"):
            sec, nsec = struct.unpack_from(
                "<II" if ftype == "time" else "<ii", buf, o)
            return sec + nsec * 1e-9, o + 8
        if ftype in _PRIMITIVES:
            fmt, size = _PRIMITIVES[ftype]
            (v,) = struct.unpack_from(fmt, buf, o)
            if ftype == "bool":
                v = bool(v)
            return v, o + size
        spec = self.specs[ftype]
        out = {}
        for f in spec.fields:
            if f.array_len is None:
                out[f.name], o = self._read(f.type, buf, o)
            else:
                n = f.array_len
                if n == -1:
                    (n,) = struct.unpack_from("<I", buf, o)
                    o += 4
                if f.type in _NP_DTYPES:
                    dt = np.dtype(_NP_DTYPES[f.type]).newbyteorder("<")
                    arr = np.frombuffer(buf, dt, count=n, offset=o)
                    out[f.name] = arr.astype(_NP_DTYPES[f.type])
                    o += n * arr.itemsize
                else:
                    items = []
                    for _ in range(n):
                        v, o = self._read(f.type, buf, o)
                        items.append(v)
                    out[f.name] = items
        return out, o

    # -- serialize (for fixtures / re-export) -------------------------------

    def write(self, full_name: str, msg) -> bytes:
        chunks: List[bytes] = []
        self._write(full_name, msg, chunks)
        return b"".join(chunks)

    def _write(self, ftype: str, v, out: List[bytes]):
        if ftype == "string":
            b = str(v).encode()
            out.append(struct.pack("<I", len(b)) + b)
            return
        if ftype in ("time", "duration"):
            sec = int(v)
            nsec = int(round((v - sec) * 1e9))
            out.append(struct.pack("<II" if ftype == "time" else "<ii",
                                   sec, nsec))
            return
        if ftype in _PRIMITIVES:
            fmt, _ = _PRIMITIVES[ftype]
            out.append(struct.pack(fmt, v))
            return
        spec = self.specs[ftype]
        for f in spec.fields:
            fv = v.get(f.name) if isinstance(v, dict) else getattr(v, f.name)
            if f.array_len is None:
                self._write(f.type, fv, out)
            else:
                items = list(fv) if fv is not None else []
                if f.array_len == -1:
                    out.append(struct.pack("<I", len(items)))
                elif len(items) != f.array_len:
                    raise ValueError(
                        f"{ftype}.{f.name}: fixed array length mismatch")
                for item in items:
                    self._write(f.type, item, out)


# ---------------------------------------------------------------------------
# Built-in definitions (standard ROS types + the reference's sloam_msgs
# wire contract, SemanticMeasSyncOdom.msg / ROS{Cylinder,Cube,Ellipsoid}.msg
# / RelativeInterRobotMeasurementOdom.msg) — used by the writer; the reader
# always trusts the definitions embedded in the bag itself.
# ---------------------------------------------------------------------------

BUILTIN_DEFS: Dict[str, str] = {
    "std_msgs/Header": "uint32 seq\ntime stamp\nstring frame_id\n",
    "geometry_msgs/Point": "float64 x\nfloat64 y\nfloat64 z\n",
    "geometry_msgs/Quaternion":
        "float64 x\nfloat64 y\nfloat64 z\nfloat64 w\n",
    "geometry_msgs/Pose":
        "geometry_msgs/Point position\ngeometry_msgs/Quaternion orientation\n",
    "geometry_msgs/Vector3": "float64 x\nfloat64 y\nfloat64 z\n",
    "geometry_msgs/Twist":
        "geometry_msgs/Vector3 linear\ngeometry_msgs/Vector3 angular\n",
    "geometry_msgs/PoseWithCovariance":
        "geometry_msgs/Pose pose\nfloat64[36] covariance\n",
    "geometry_msgs/TwistWithCovariance":
        "geometry_msgs/Twist twist\nfloat64[36] covariance\n",
    "nav_msgs/Odometry":
        "std_msgs/Header header\nstring child_frame_id\n"
        "geometry_msgs/PoseWithCovariance pose\n"
        "geometry_msgs/TwistWithCovariance twist\n",
    "sloam_msgs/ROSCylinder":
        "float32[3] root\nfloat32[3] ray\nfloat64[] radii\nfloat32 radius\n"
        "int64 id\nint8 semantic_label\n",
    "sloam_msgs/ROSCube":
        "float32[3] dim\nint8 semantic_label\ngeometry_msgs/Pose pose\n",
    "sloam_msgs/ROSEllipsoid":
        "float32[3] scale\nint8 semantic_label\ngeometry_msgs/Pose pose\n",
    "sloam_msgs/SemanticMeasSyncOdom":
        "std_msgs/Header header\n"
        "sloam_msgs/ROSEllipsoid[] ellipsoid_factors\n"
        "sloam_msgs/ROSCylinder[] cylinder_factors\n"
        "sloam_msgs/ROSCube[] cuboid_factors\n"
        "nav_msgs/Odometry odometry\n",
    "sloam_msgs/RelativeInterRobotMeasurementOdom":
        "std_msgs/Header header\ngeometry_msgs/Pose relativePose\n"
        "int8 robotIdObserver\nint8 robotIdObserved\n"
        "nav_msgs/Odometry odometryObserver\n"
        "nav_msgs/Odometry odometryObserved\n",
}

_DEPS: Dict[str, List[str]] = {
    "std_msgs/Header": [],
    "geometry_msgs/Point": [],
    "geometry_msgs/Quaternion": [],
    "geometry_msgs/Vector3": [],
    "geometry_msgs/Pose": ["geometry_msgs/Point", "geometry_msgs/Quaternion"],
    "geometry_msgs/Twist": ["geometry_msgs/Vector3"],
    "geometry_msgs/PoseWithCovariance": ["geometry_msgs/Pose"],
    "geometry_msgs/TwistWithCovariance": ["geometry_msgs/Twist"],
    "nav_msgs/Odometry": ["std_msgs/Header",
                          "geometry_msgs/PoseWithCovariance",
                          "geometry_msgs/TwistWithCovariance"],
    "sloam_msgs/ROSCylinder": [],
    "sloam_msgs/ROSCube": ["geometry_msgs/Pose"],
    "sloam_msgs/ROSEllipsoid": ["geometry_msgs/Pose"],
    "sloam_msgs/SemanticMeasSyncOdom": [
        "std_msgs/Header", "sloam_msgs/ROSEllipsoid",
        "sloam_msgs/ROSCylinder", "sloam_msgs/ROSCube", "nav_msgs/Odometry"],
    "sloam_msgs/RelativeInterRobotMeasurementOdom": [
        "std_msgs/Header", "geometry_msgs/Pose", "nav_msgs/Odometry"],
}


def full_definition(full_name: str) -> str:
    """Build the gendeps-style concatenated definition for a builtin type
    (main body + '=' * 80 separated MSG: blocks, transitively)."""
    seen: List[str] = []

    def visit(t):
        for d in _DEPS[t]:
            if d not in seen:
                seen.append(d)
                visit(d)

    visit(full_name)
    parts = [BUILTIN_DEFS[full_name]]
    for dep in seen:
        parts.append("=" * 80 + f"\nMSG: {dep}\n" + BUILTIN_DEFS[dep])
    return "\n".join(parts)


def definition_from_specs(reg: TypeRegistry, full_name: str) -> str:
    """Regenerate a gendeps-style concatenated definition from a registry's
    parsed specs (main body + '='*80-separated MSG: dependency blocks), so
    bags written from a custom registry stay self-describing."""
    if full_name not in reg.specs:
        raise KeyError(f"no message definition for {full_name!r} in registry")

    def body(t: str) -> str:
        lines = []
        for f in reg.specs[t].fields:
            suffix = ("" if f.array_len is None
                      else "[]" if f.array_len == -1 else f"[{f.array_len}]")
            lines.append(f"{f.type}{suffix} {f.name}")
        return "\n".join(lines) + "\n"

    seen: List[str] = []

    def visit(t):
        for f in reg.specs[t].fields:
            ft = f.type
            if ft in reg.specs and ft not in seen:
                seen.append(ft)
                visit(ft)

    visit(full_name)
    out = body(full_name)
    for dep in seen:
        out += "=" * 80 + f"\nMSG: {dep}\n" + body(dep)
    return out


def builtin_registry() -> TypeRegistry:
    reg = TypeRegistry()
    for name in BUILTIN_DEFS:
        reg._parse_block(name, BUILTIN_DEFS[name])
    return reg


# ---------------------------------------------------------------------------
# Verbatim .msg catkin-package ingestion
# ---------------------------------------------------------------------------

def load_msg_package(msg_dir: str, package: str = "sloam_msgs"):
    """Ingest a catkin package's msg/ directory VERBATIM: every `Name.msg`
    file's raw text becomes the definition of `package/Name`
    (e.g. the reference repository's backend/sloam_msgs/msg — its actual
    IDL sources, SemanticMeasSyncOdom.msg:16-26 etc.).

    Returns (registry, raw_texts) where raw_texts maps full type name ->
    the file's exact text. The registry also contains the standard ROS
    types (std_msgs/geometry_msgs/nav_msgs) the package depends on, which
    live in the ROS distro rather than the package itself."""
    reg = builtin_registry()
    raw: Dict[str, str] = {}
    for fname in sorted(os.listdir(msg_dir)):
        if not fname.endswith(".msg"):
            continue
        full_name = f"{package}/{fname[:-4]}"
        with open(os.path.join(msg_dir, fname)) as f:
            text = f.read()
        raw[full_name] = text
        reg._parse_block(full_name, text)
    return reg, raw


def definition_from_msg_package(full_name: str, reg: TypeRegistry,
                                raw: Dict[str, str]) -> str:
    """gendeps-style concatenated definition whose blocks are the VERBATIM
    .msg file texts for package types (falling back to the builtin text for
    distro types) — what `rosbag record` embeds in connection records."""
    seen: List[str] = []

    def visit(t):
        for f in reg.specs[t].fields:
            ft = f.type
            if ft in reg.specs and ft not in seen:
                seen.append(ft)
                visit(ft)

    visit(full_name)
    body = raw.get(full_name) or BUILTIN_DEFS[full_name]
    parts = [body]
    for dep in seen:
        dep_body = raw.get(dep) or BUILTIN_DEFS[dep]
        parts.append("=" * 80 + f"\nMSG: {dep}\n" + dep_body)
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# Bag record I/O
# ---------------------------------------------------------------------------

def _read_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    o = 0
    while o < len(buf):
        (n,) = struct.unpack_from("<I", buf, o)
        o += 4
        item = buf[o:o + n]
        o += n
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _write_header(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _records(buf: bytes) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    o = 0
    n_total = len(buf)
    while o + 8 <= n_total:
        (hlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        header = _read_header(buf[o:o + hlen])
        o += hlen
        (dlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        data = buf[o:o + dlen]
        o += dlen
        yield header, data


@dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str
    md5sum: str
    definition: str


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float          # record (receive) time
    msg: dict


def read_bag(path: str,
             topics: Optional[List[str]] = None) -> Iterator[BagMessage]:
    """Stream deserialized messages from a ROS1 V2.0 bag (none/bz2 chunk
    compression; index records ignored so truncated bags still read; an
    lz4 chunk raises ValueError)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0 (magic={magic!r})")
        body = f.read()

    reg = TypeRegistry()
    conns: Dict[int, Connection] = {}

    def handle(header: Dict[str, bytes], data: bytes):
        op = header.get("op", b"\x00")[0]
        if op == 0x07:  # connection
            cid = struct.unpack("<I", header["conn"])[0]
            h = _read_header(data)
            conn = Connection(
                conn_id=cid,
                topic=header.get("topic", h.get("topic", b"")).decode(),
                msg_type=h.get("type", b"").decode(),
                md5sum=h.get("md5sum", b"").decode(),
                definition=h.get("message_definition", b"").decode())
            conns[cid] = conn
            if conn.msg_type and conn.msg_type not in reg.specs:
                reg.parse_definition(conn.msg_type, conn.definition)
        elif op == 0x02:  # message data
            cid = struct.unpack("<I", header["conn"])[0]
            sec, nsec = struct.unpack("<II", header["time"])
            conn = conns.get(cid)
            if conn is None:
                return None
            if topics is not None and conn.topic not in topics:
                return None
            msg = reg.read(conn.msg_type, data)
            return BagMessage(conn.topic, conn.msg_type,
                              sec + nsec * 1e-9, msg)
        return None

    for header, data in _records(body):
        op = header.get("op", b"\x00")[0]
        if op == 0x05:  # chunk
            comp = header.get("compression", b"none").decode()
            if comp == "bz2":
                inner = bz2.decompress(data)
            elif comp == "none":
                inner = data
            else:
                raise ValueError(f"unsupported chunk compression: {comp}")
            for h2, d2 in _records(inner):
                out = handle(h2, d2)
                if out is not None:
                    yield out
        else:
            out = handle(header, data)
            if out is not None:
                yield out


def bag_topics(path: str) -> Dict[str, str]:
    """topic -> msg type map (connections only; cheap scan)."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError("not a ROS bag v2.0")
        body = f.read()
    out: Dict[str, str] = {}
    for header, data in _records(body):
        op = header.get("op", b"\x00")[0]
        blobs = [(header, data)]
        if op == 0x05:
            comp = header.get("compression", b"none").decode()
            inner = bz2.decompress(data) if comp == "bz2" else data
            blobs = list(_records(inner)) if comp in ("none", "bz2") else []
        for h2, d2 in blobs:
            if h2.get("op", b"\x00")[0] == 0x07:
                h = _read_header(d2)
                topic = h2.get("topic", h.get("topic", b"")).decode()
                out[topic] = h.get("type", b"").decode()
    return out


def write_bag(path: str, messages: List[Tuple[str, str, float, dict]],
              registry: Optional[TypeRegistry] = None,
              definitions: Optional[Dict[str, str]] = None):
    """Write a minimal uncompressed V2.0 bag: one chunk holding connection +
    message records (no index — every compliant reader streams fine).
    messages: (topic, full_type, stamp, msg_dict), builtin types only unless
    a registry with extra specs is supplied. `definitions` overrides the
    embedded connection definition text per type (e.g. the verbatim
    reference .msg sources via definition_from_msg_package)."""
    reg = registry or builtin_registry()
    definitions = definitions or {}
    topics: Dict[str, int] = {}
    inner = b""
    for topic, mtype, stamp, msg in messages:
        if topic not in topics:
            cid = len(topics)
            topics[topic] = cid
            conn_hdr = _write_header({"op": b"\x07",
                                      "conn": struct.pack("<I", cid),
                                      "topic": topic.encode()})
            conn_data = _write_header({
                "topic": topic.encode(),
                "type": mtype.encode(),
                "md5sum": b"*",
                # always embed a real definition so written bags stay
                # self-describing (an empty one would silently deserialize
                # every message of this type as {})
                "message_definition": (
                    definitions[mtype] if mtype in definitions
                    else full_definition(mtype) if mtype in BUILTIN_DEFS
                    else definition_from_specs(reg, mtype)).encode()})
            inner += struct.pack("<I", len(conn_hdr)) + conn_hdr
            inner += struct.pack("<I", len(conn_data)) + conn_data
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        mhdr = _write_header({"op": b"\x02",
                              "conn": struct.pack("<I", topics[topic]),
                              "time": struct.pack("<II", sec, nsec)})
        mdata = reg.write(mtype, msg)
        inner += struct.pack("<I", len(mhdr)) + mhdr
        inner += struct.pack("<I", len(mdata)) + mdata

    with open(path, "wb") as f:
        f.write(_MAGIC)
        # bag header record (op 0x03), padded to 4096 like rosbag does
        bh = _write_header({"op": b"\x03",
                            "index_pos": struct.pack("<Q", 0),
                            "conn_count": struct.pack("<I", len(topics)),
                            "chunk_count": struct.pack("<I", 1)})
        pad = b" " * max(0, 4096 - len(bh) - 8)
        f.write(struct.pack("<I", len(bh)) + bh)
        f.write(struct.pack("<I", len(pad)) + pad)
        ch = _write_header({"op": b"\x05", "compression": b"none",
                            "size": struct.pack("<I", len(inner))})
        f.write(struct.pack("<I", len(ch)) + ch)
        f.write(struct.pack("<I", len(inner)) + inner)


# ---------------------------------------------------------------------------
# Conversion to RobotLog / RelativeMeas
# ---------------------------------------------------------------------------

def _pose_from_ros(p: dict) -> np.ndarray:
    """geometry_msgs/Pose dict -> [qw qx qy qz tx ty tz]."""
    q = p["orientation"]
    t = p["position"]
    return np.asarray([q["w"], q["x"], q["y"], q["z"],
                       t["x"], t["y"], t["z"]], np.float32)


def _pose_to_ros(pose: np.ndarray) -> dict:
    pose = np.asarray(pose, np.float64)
    return {"position": {"x": pose[4], "y": pose[5], "z": pose[6]},
            "orientation": {"x": pose[1], "y": pose[2], "z": pose[3],
                            "w": pose[0]}}


def _keyframe_from_meas(stamp: float, msg: dict):
    from .synthetic import Keyframe

    odom = _pose_from_ros(msg["odometry"]["pose"]["pose"])
    cyl = msg.get("cylinder_factors") or []
    cub = msg.get("cuboid_factors") or []
    ell = msg.get("ellipsoid_factors") or []
    return Keyframe(
        stamp=stamp,
        odom_pose=odom,
        true_pose=odom.copy(),   # real bags carry no ground truth
        cyl_root=np.asarray([c["root"] for c in cyl], np.float32).reshape(-1, 3),
        cyl_ray=np.asarray([c["ray"] for c in cyl], np.float32).reshape(-1, 3),
        cyl_radius=np.asarray([c["radius"] for c in cyl], np.float32),
        cyl_label=np.asarray([c["semantic_label"] for c in cyl], np.int32),
        cub_pose=(np.stack([_pose_from_ros(c["pose"]) for c in cub])
                  if cub else np.zeros((0, 7), np.float32)),
        cub_scale=np.asarray([c["dim"] for c in cub], np.float32).reshape(-1, 3),
        cub_label=np.asarray([c["semantic_label"] for c in cub], np.int32),
        ell_pose=(np.stack([_pose_from_ros(e["pose"]) for e in ell])
                  if ell else np.zeros((0, 7), np.float32)),
        ell_scale=np.asarray([e["scale"] for e in ell], np.float32).reshape(-1, 3),
        ell_label=np.asarray([e["semantic_label"] for e in ell], np.int32),
    )


def bag_to_robot_log(path: str, robot_id: int = 0,
                     meas_topic: Optional[str] = None):
    """Convert a bag's SemanticMeasSyncOdom stream into a RobotLog.

    If meas_topic is None, the first topic of type
    sloam_msgs/SemanticMeasSyncOdom is used (the reference remaps it per
    robot to /robotN/semantic_meas_sync_odom)."""
    from .synthetic import RobotLog

    if meas_topic is None:
        for topic, mtype in bag_topics(path).items():
            if mtype.endswith("SemanticMeasSyncOdom"):
                meas_topic = topic
                break
        if meas_topic is None:
            raise ValueError(f"{path}: no SemanticMeasSyncOdom topic found")
    log = RobotLog(robot_id=robot_id)
    for bm in read_bag(path, topics=[meas_topic]):
        stamp = bm.msg["header"]["stamp"] or bm.stamp
        log.keyframes.append(_keyframe_from_meas(stamp, bm.msg))
    log.keyframes.sort(key=lambda k: k.stamp)
    return log


def bag_relative_measurements(path: str,
                              host_robot_id: Optional[int] = None) -> List:
    """Extract RelativeInterRobotMeasurementOdom messages as the host
    robot's RelativeMeas view (robot.cpp:148-175 observer/observed
    asymmetry: the observed robot keeps only its own odometry). With
    host_robot_id=None, returns the observer-side view of every message."""
    from ..runtime.scheduler import RelativeMeas

    out: List = []
    for topic, mtype in bag_topics(path).items():
        if not mtype.endswith("RelativeInterRobotMeasurementOdom"):
            continue
        for bm in read_bag(path, topics=[topic]):
            m = bm.msg
            stamp = m["header"]["stamp"] or bm.stamp
            observer = int(m["robotIdObserver"])
            observed = int(m["robotIdObserved"])
            if host_robot_id is None or host_robot_id == observer:
                out.append(RelativeMeas(
                    stamp=stamp,
                    relative_pose=_pose_from_ros(m["relativePose"]),
                    robot_index=observed,
                    odom_pose=_pose_from_ros(
                        m["odometryObserver"]["pose"]["pose"]),
                    only_use_odom=False))
            elif host_robot_id == observed:
                out.append(RelativeMeas(
                    stamp=stamp,
                    relative_pose=_pose_from_ros(m["relativePose"]),
                    robot_index=observer,
                    odom_pose=_pose_from_ros(
                        m["odometryObserved"]["pose"]["pose"]),
                    only_use_odom=True))
    out.sort(key=lambda r: r.stamp)
    return out


def robot_log_to_bag(path: str, log, topic: Optional[str] = None,
                     registry: Optional[TypeRegistry] = None,
                     definitions: Optional[Dict[str, str]] = None):
    """Re-export a RobotLog as a SemanticMeasSyncOdom bag the reference
    stack can replay (inverse of bag_to_robot_log)."""
    topic = topic or f"/robot{log.robot_id}/semantic_meas_sync_odom"
    msgs = []
    for k in log.keyframes:
        header = {"seq": 0, "stamp": k.stamp, "frame_id": "body"}
        odom = {"header": header, "child_frame_id": "body",
                "pose": {"pose": _pose_to_ros(k.odom_pose),
                         "covariance": [0.0] * 36},
                "twist": {"twist": {"linear": {"x": 0, "y": 0, "z": 0},
                                    "angular": {"x": 0, "y": 0, "z": 0}},
                          "covariance": [0.0] * 36}}
        msg = {
            "header": header,
            "ellipsoid_factors": [
                {"scale": k.ell_scale[i], "semantic_label": int(k.ell_label[i]),
                 "pose": _pose_to_ros(k.ell_pose[i])}
                for i in range(len(k.ell_label))],
            "cylinder_factors": [
                {"root": k.cyl_root[i], "ray": k.cyl_ray[i], "radii": [],
                 "radius": float(k.cyl_radius[i]), "id": 0,
                 "semantic_label": int(k.cyl_label[i])}
                for i in range(len(k.cyl_label))],
            "cuboid_factors": [
                {"dim": k.cub_scale[i], "semantic_label": int(k.cub_label[i]),
                 "pose": _pose_to_ros(k.cub_pose[i])}
                for i in range(len(k.cub_label))],
            "odometry": odom,
        }
        msgs.append((topic, "sloam_msgs/SemanticMeasSyncOdom", k.stamp, msg))
    write_bag(path, msgs, registry=registry, definitions=definitions)
