"""ROS1 `.bag` ingestion, stdlib and numpy only, no ROS.

Counterpart: kimera_semantics_tpu/io/rosbag.py (its own copy here: the port
imports nothing of the JAX package). The reference replays rosbags
(`RosbagDataProvider`, rosbag_data_provider.cpp:83-193: synchronized
depth/semantic image streams plus the TF tree, handed to the integrator in
timestamp lockstep), and its live node consumes organized
`sensor_msgs/PointCloud2`. This module reads and writes that surface:

  - `BagReader` / `BagWriter`: the ROS1 bag v2.0 container (record framing,
    chunks with none/bz2 compression, connections);
  - codecs for `sensor_msgs/Image`, `sensor_msgs/CameraInfo`,
    `tf2_msgs/TFMessage` and `sensor_msgs/PointCloud2`;
  - `TfBuffer`: time-interpolated transform-tree lookup with static
    extrinsics from CSV (kimera_semantics_rosbag.cpp:124-133);
  - `RosbagDataset`: the dataset protocol of io/dataset.DirectoryDataset.
    `host_frames()` decodes each frame to numpy (on the prefetch thread of
    server/pipeline.py) and `to_frame` moves it to the dataset's device;
  - `write_dataset_bag`: any dataset written as a replayable bag.

Parsing stays numpy on the host; a Frame lands on the device once.
"""

from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.camera import PinholeIntrinsics
from ..core.color import LabelColorMap
from ..device import resolve
from ..models.common import Frame, frame_from_images

MAGIC = b"#ROSBAG V2.0\n"

_OP_MSGDATA = 0x02
_OP_BAGHDR = 0x03
_OP_IDXDATA = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONNECTION = 0x07

# sensor_msgs/PointField datatype codes
_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


# ---------------------------------------------------------------------------
# Record framing


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    """A record header is a list of u32-length-prefixed `name=value` fields."""
    fields: Dict[bytes, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        fld = buf[off:off + flen]
        off += flen
        eq = fld.index(b"=")
        fields[fld[:eq]] = fld[eq + 1:]
    return fields


def _build_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        fld = k + b"=" + v
        out += struct.pack("<I", len(fld)) + fld
    return out


def _read_records(buf: bytes) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    """Iterate (header, data) records packed back-to-back in `buf`.

    A truncated final record (bag from a crashed recorder) is dropped rather
    than raising — the same recovery contract as `rosbag reindex`."""
    off = 0
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        if off + 4 + hlen + 4 > n:
            return  # truncated header
        hdr = _parse_header(buf[off + 4:off + 4 + hlen])
        off += 4 + hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + dlen > n:
            return  # truncated data
        data = buf[off:off + dlen]
        off += dlen
        yield hdr, data


def _pack_time(secs: int, nsecs: int) -> bytes:
    return struct.pack("<II", secs, nsecs)


def _unpack_time(raw: bytes) -> float:
    secs, nsecs = struct.unpack("<II", raw)
    return secs + 1e-9 * nsecs


# ---------------------------------------------------------------------------
# Message (de)serialization — ROS1 little-endian wire format


class _Cursor:
    """Sequential deserializer over one serialized ROS message."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n].decode("utf-8", "replace")
        self.off += n
        return s

    def time(self) -> float:
        secs, nsecs = struct.unpack_from("<II", self.buf, self.off)
        self.off += 8
        return secs + 1e-9 * nsecs

    def f64_array(self, n: Optional[int] = None) -> np.ndarray:
        if n is None:  # variable-length
            n = self.u32()
        a = np.frombuffer(self.buf, dtype="<f8", count=n, offset=self.off)
        self.off += 8 * n
        return np.asarray(a)

    def bytes_array(self) -> bytes:
        n = self.u32()
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def header(self) -> Tuple[float, str]:
        """std_msgs/Header → (stamp_seconds, frame_id); seq discarded."""
        self.u32()
        stamp = self.time()
        return stamp, self.string()


def _ser_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def _ser_header(stamp: float, frame_id: str, seq: int = 0) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<I", seq) + _pack_time(secs, nsecs) + _ser_string(frame_id)


@dataclass
class ImageMsg:
    stamp: float
    frame_id: str
    encoding: str
    data: np.ndarray  # decoded (H, W) or (H, W, C)

    def as_depth_m(self) -> np.ndarray:
        """Depth image in meters — mm-vs-m handling of
        depth_map_to_pointcloud.h:183-204 (16UC1 is millimeters)."""
        if self.encoding in ("16UC1", "mono16"):
            return self.data.astype(np.float32) * 1e-3
        if self.encoding == "32FC1":
            return self.data.astype(np.float32)
        raise ValueError(f"not a depth encoding: {self.encoding}")

    def as_rgb(self) -> np.ndarray:
        if self.encoding in ("rgb8", "rgba8"):
            return self.data[..., :3]
        if self.encoding in ("bgr8", "bgra8"):
            return self.data[..., 2::-1]
        if self.encoding == "mono8":
            return np.repeat(self.data[..., None], 3, axis=-1)
        raise ValueError(f"not a color encoding: {self.encoding}")


_ENC_CHANNELS = {"rgb8": (np.uint8, 3), "bgr8": (np.uint8, 3),
                 "rgba8": (np.uint8, 4), "bgra8": (np.uint8, 4),
                 "mono8": (np.uint8, 1), "mono16": (np.uint16, 1),
                 "16UC1": (np.uint16, 1), "32FC1": (np.float32, 1),
                 "32SC1": (np.int32, 1)}


def decode_image(raw: bytes) -> ImageMsg:
    c = _Cursor(raw)
    stamp, frame_id = c.header()
    height, width = c.u32(), c.u32()
    encoding = c.string()
    c.u8()  # is_bigendian (ROS1 messages are little-endian in practice)
    step = c.u32()
    data = c.bytes_array()
    if encoding not in _ENC_CHANNELS:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    dtype, ch = _ENC_CHANNELS[encoding]
    rows = np.frombuffer(data, dtype=np.uint8).reshape(height, step)
    rowbytes = width * ch * np.dtype(dtype).itemsize
    img = rows[:, :rowbytes].reshape(height, -1).view(dtype)
    img = img.reshape(height, width, ch)
    if ch == 1:
        img = img[..., 0]
    return ImageMsg(stamp=stamp, frame_id=frame_id, encoding=encoding,
                    data=img)


def encode_image(img: np.ndarray, encoding: str, stamp: float,
                 frame_id: str) -> bytes:
    dtype, ch = _ENC_CHANNELS[encoding]
    arr = np.ascontiguousarray(img, dtype=dtype)
    h, w = arr.shape[:2]
    step = w * ch * np.dtype(dtype).itemsize
    raw = arr.tobytes()
    return (_ser_header(stamp, frame_id) + struct.pack("<II", h, w)
            + _ser_string(encoding) + struct.pack("<BI", 0, step)
            + struct.pack("<I", len(raw)) + raw)


@dataclass
class CameraInfoMsg:
    stamp: float
    frame_id: str
    height: int
    width: int
    K: np.ndarray  # (3, 3)

    def intrinsics(self) -> PinholeIntrinsics:
        return PinholeIntrinsics(fx=float(self.K[0, 0]), fy=float(self.K[1, 1]),
                                 cx=float(self.K[0, 2]), cy=float(self.K[1, 2]),
                                 width=self.width, height=self.height)


def decode_camera_info(raw: bytes) -> CameraInfoMsg:
    c = _Cursor(raw)
    stamp, frame_id = c.header()
    height, width = c.u32(), c.u32()
    c.string()           # distortion_model
    c.f64_array()        # D (variable)
    K = c.f64_array(9).reshape(3, 3)
    return CameraInfoMsg(stamp=stamp, frame_id=frame_id, height=height,
                         width=width, K=K)


def encode_camera_info(intr: PinholeIntrinsics, stamp: float,
                       frame_id: str) -> bytes:
    K = np.array([intr.fx, 0, intr.cx, 0, intr.fy, intr.cy, 0, 0, 1], "<f8")
    R = np.eye(3, dtype="<f8").ravel()
    P = np.array([intr.fx, 0, intr.cx, 0, 0, intr.fy, intr.cy, 0,
                  0, 0, 1, 0], "<f8")
    return (_ser_header(stamp, frame_id)
            + struct.pack("<II", intr.height, intr.width)
            + _ser_string("plumb_bob") + struct.pack("<I", 0)  # empty D
            + K.tobytes() + R.tobytes() + P.tobytes()
            + struct.pack("<II", 0, 0)                  # binning
            + struct.pack("<IIIIB", 0, 0, 0, 0, 0))     # roi


@dataclass
class TransformStampedMsg:
    stamp: float
    parent: str     # header.frame_id
    child: str      # child_frame_id
    qxyzw: np.ndarray
    trans: np.ndarray


def decode_tf_message(raw: bytes) -> List[TransformStampedMsg]:
    c = _Cursor(raw)
    out = []
    for _ in range(c.u32()):
        stamp, parent = c.header()
        child = c.string()
        t = np.array([c.f64(), c.f64(), c.f64()], np.float64)
        q = np.array([c.f64(), c.f64(), c.f64(), c.f64()], np.float64)
        out.append(TransformStampedMsg(stamp=stamp, parent=parent,
                                       child=child, qxyzw=q, trans=t))
    return out


def encode_tf_message(transforms: List[TransformStampedMsg]) -> bytes:
    out = struct.pack("<I", len(transforms))
    for tf in transforms:
        out += _ser_header(tf.stamp, tf.parent) + _ser_string(tf.child)
        out += struct.pack("<3d", *np.asarray(tf.trans, np.float64))
        out += struct.pack("<4d", *np.asarray(tf.qxyzw, np.float64))
    return out


@dataclass
class PointCloud2Msg:
    stamp: float
    frame_id: str
    height: int
    width: int
    fields: Dict[str, Tuple[int, np.dtype]]  # name -> (offset, dtype)
    point_step: int
    row_step: int
    data: bytes

    def column(self, name: str) -> np.ndarray:
        off, dtype = self.fields[name]
        # rows may carry padding (row_step > width * point_step)
        rows = np.frombuffer(self.data, dtype=np.uint8,
                             count=self.height * self.row_step)
        rows = rows.reshape(self.height, self.row_step)
        raw = rows[:, :self.width * self.point_step].reshape(
            self.height * self.width, self.point_step)
        col = raw[:, off:off + np.dtype(dtype).itemsize].copy().view(dtype)[:, 0]
        return col.reshape(self.height, self.width)

    def organized_depth_colors(self) -> Tuple[np.ndarray, np.ndarray]:
        """Organized cloud → (depth z-image meters, RGB u8 image) — inverts
        PointCloudFromDepth (the live node's input, depth_map_to_pointcloud.h)."""
        if self.height <= 1:
            raise ValueError("pointcloud is not organized (height <= 1)")
        z = self.column("z").astype(np.float32)
        if "rgb" in self.fields:
            packed = self.column("rgb")
            packed = packed.view(np.uint32) if packed.dtype == np.float32 \
                else packed.astype(np.uint32)
            rgb = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                            packed & 0xFF], axis=-1).astype(np.uint8)
        else:
            rgb = np.zeros(z.shape + (3,), np.uint8)
        return np.nan_to_num(z, nan=0.0), rgb


def decode_pointcloud2(raw: bytes) -> PointCloud2Msg:
    c = _Cursor(raw)
    stamp, frame_id = c.header()
    height, width = c.u32(), c.u32()
    fields: Dict[str, Tuple[int, np.dtype]] = {}
    for _ in range(c.u32()):
        name = c.string()
        offset, datatype, count = c.u32(), c.u8(), c.u32()
        del count
        fields[name] = (offset, np.dtype(_PF_DTYPES[datatype]).newbyteorder("<"))
    c.u8()  # is_bigendian
    point_step = c.u32()
    row_step = c.u32()
    data = c.bytes_array()
    if row_step == 0:  # permissive: some writers leave it 0 for dense rows
        row_step = width * point_step
    return PointCloud2Msg(stamp=stamp, frame_id=frame_id, height=height,
                          width=width, fields=fields, point_step=point_step,
                          row_step=row_step, data=data)


_MSG_TYPES = {
    "sensor_msgs/Image": decode_image,
    "sensor_msgs/CameraInfo": decode_camera_info,
    "tf2_msgs/TFMessage": decode_tf_message,
    "tf/tfMessage": decode_tf_message,  # legacy tf1 wire format is identical
    "sensor_msgs/PointCloud2": decode_pointcloud2,
}

# Well-known md5s, written into connection records for interop with rosbag
# tooling (our reader never checks them).
_MSG_MD5 = {
    "sensor_msgs/Image": "060021388200f6f0f447d0fcd9c64743",
    "sensor_msgs/CameraInfo": "c9a58c1b0b154e0e6da7578cb991d214",
    "tf2_msgs/TFMessage": "94810edda583a504dfda3829e70d7eec",
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
}


# ---------------------------------------------------------------------------
# Bag container


@dataclass
class BagMessage:
    topic: str
    msgtype: str
    time: float   # record (receive) time
    raw: bytes

    def decode(self):
        try:
            dec = _MSG_TYPES[self.msgtype]
        except KeyError:
            raise ValueError(f"no decoder for {self.msgtype!r}") from None
        return dec(self.raw)


class BagReader:
    """Sequential ROS1 bag v2.0 reader (chunked, none/bz2 compression).

    The reference loads entire bags to RAM before integrating
    (rosbag_data_provider.cpp:83 `parseRosbag`); this reader streams records
    but `RosbagDataset` below materializes selected topics the same way.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a ROS1 v2.0 bag (magic {magic!r})")

    def _file_records(self) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
        """Stream top-level records from the file — only one record (or one
        decompressed chunk) is resident at a time, so multi-GB bags don't
        need multi-GB RAM. Truncated tails are dropped (_read_records
        contract)."""
        with open(self.path, "rb") as f:
            f.seek(len(MAGIC))
            while True:
                lenbuf = f.read(4)
                if len(lenbuf) < 4:
                    return
                (hlen,) = struct.unpack("<I", lenbuf)
                hdr_raw = f.read(hlen)
                lenbuf = f.read(4)
                if len(hdr_raw) < hlen or len(lenbuf) < 4:
                    return  # truncated header
                (dlen,) = struct.unpack("<I", lenbuf)
                data = f.read(dlen)
                if len(data) < dlen:
                    return  # truncated data
                yield _parse_header(hdr_raw), data

    def messages(self, topics: Optional[List[str]] = None
                 ) -> Iterator[BagMessage]:
        want = set(topics) if topics is not None else None
        conns: Dict[int, Tuple[str, str]] = {}  # conn id -> (topic, type)

        def handle(hdr, data):
            op = hdr[b"op"][0]
            if op == _OP_CONNECTION:
                dfields = _parse_header(data)
                cid = struct.unpack("<I", hdr[b"conn"])[0]
                topic = (dfields.get(b"topic") or hdr[b"topic"]).decode()
                conns[cid] = (topic, dfields[b"type"].decode())
            elif op == _OP_MSGDATA:
                cid = struct.unpack("<I", hdr[b"conn"])[0]
                topic, mtype = conns.get(cid, ("?", "?"))
                if want is None or topic in want:
                    return BagMessage(topic=topic, msgtype=mtype,
                                      time=_unpack_time(hdr[b"time"]),
                                      raw=data)
            return None

        for hdr, data in self._file_records():
            op = hdr[b"op"][0]
            if op == _OP_CHUNK:
                comp = hdr.get(b"compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp != "none":
                    raise ValueError(
                        f"{self.path}: unsupported chunk compression {comp!r}"
                        " (supported: none, bz2; recompress with "
                        "`rosbag compress --bz2`)")
                for ihdr, idata in _read_records(data):
                    msg = handle(ihdr, idata)
                    if msg is not None:
                        yield msg
            elif op in (_OP_CONNECTION, _OP_MSGDATA):
                msg = handle(hdr, data)
                if msg is not None:
                    yield msg
            # index / chunk-info / bag-header records: not needed for a scan

    def topics(self) -> Dict[str, str]:
        """topic -> message type, from connection records."""
        out: Dict[str, str] = {}
        for msg in self.messages():
            out.setdefault(msg.topic, msg.msgtype)
        return out


class BagWriter:
    """Minimal single-chunk ROS1 v2.0 bag writer (fixtures + interop)."""

    def __init__(self, path: str, compression: str = "none"):
        if compression not in ("none", "bz2"):
            raise ValueError("compression must be 'none' or 'bz2'")
        self.path = path
        self.compression = compression
        self._conns: Dict[str, int] = {}
        self._conn_records: List[bytes] = []
        self._msg_records: List[bytes] = []
        self._times: List[float] = []

    def _record(self, hdr: Dict[bytes, bytes], data: bytes) -> bytes:
        h = _build_header(hdr)
        return (struct.pack("<I", len(h)) + h
                + struct.pack("<I", len(data)) + data)

    def _conn_id(self, topic: str, msgtype: str) -> int:
        if topic not in self._conns:
            cid = len(self._conns)
            self._conns[topic] = cid
            data = _build_header({
                b"topic": topic.encode(), b"type": msgtype.encode(),
                b"md5sum": _MSG_MD5.get(msgtype, "*").encode(),
                b"message_definition": b""})
            self._conn_records.append(self._record(
                {b"op": bytes([_OP_CONNECTION]),
                 b"conn": struct.pack("<I", cid),
                 b"topic": topic.encode()}, data))
        return self._conns[topic]

    def write(self, topic: str, msgtype: str, raw: bytes, stamp: float):
        cid = self._conn_id(topic, msgtype)
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        self._msg_records.append(self._record(
            {b"op": bytes([_OP_MSGDATA]), b"conn": struct.pack("<I", cid),
             b"time": _pack_time(secs, nsecs)}, raw))
        self._times.append(stamp)

    def close(self):
        chunk = b"".join(self._conn_records) + b"".join(self._msg_records)
        payload = bz2.compress(chunk) if self.compression == "bz2" else chunk
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            # bag header record, padded to 4 KB with ASCII spaces (spec)
            hdr = _build_header({
                b"op": bytes([_OP_BAGHDR]),
                b"index_pos": struct.pack("<Q", 0),
                b"conn_count": struct.pack("<I", len(self._conns)),
                b"chunk_count": struct.pack("<I", 1)})
            pad = max(0, 4096 - len(hdr) - 8)
            f.write(struct.pack("<I", len(hdr)) + hdr
                    + struct.pack("<I", pad) + b" " * pad)
            f.write(self._record(
                {b"op": bytes([_OP_CHUNK]),
                 b"compression": self.compression.encode(),
                 b"size": struct.pack("<I", len(chunk))}, payload))
            # repeat connections at top level (spec: after the chunks)
            for rec in self._conn_records:
                f.write(rec)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


# ---------------------------------------------------------------------------
# TF tree


def _quat_trans_to_mat(qxyzw: np.ndarray, t: np.ndarray) -> np.ndarray:
    q = np.asarray(qxyzw, np.float64)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    m[:3, 3] = t
    return m


class TfBuffer:
    """Time-interpolated transform tree (tf2 lookupTransform equivalent).

    Edges are (parent, child) with a time series of (stamp, quat, trans);
    lookups walk the undirected frame graph and compose, interpolating each
    dynamic edge at the query stamp (nlerp rotation, lerp translation) and
    clamping outside the recorded range. Static transforms (from /tf_static)
    are timeless single entries — the reference composes one of each
    (kimera_semantics_rosbag.cpp:124-133: dynamic base→world ∘ static cam→base).
    """

    def __init__(self):
        self._series: Dict[Tuple[str, str], List[TransformStampedMsg]] = {}
        self._sorted = True

    def add(self, tf: TransformStampedMsg):
        self._series.setdefault((tf.parent, tf.child), []).append(tf)
        self._sorted = False

    def add_static(self, parent: str, child: str, qxyzw, trans):
        self.add(TransformStampedMsg(stamp=0.0, parent=parent, child=child,
                                     qxyzw=np.asarray(qxyzw, np.float64),
                                     trans=np.asarray(trans, np.float64)))

    def _ensure_sorted(self):
        if not self._sorted:
            for series in self._series.values():
                series.sort(key=lambda tf: tf.stamp)
            self._sorted = True

    def _edge_at(self, key: Tuple[str, str], stamp: float) -> np.ndarray:
        series = self._series[key]
        if len(series) == 1:
            tf = series[0]
            return _quat_trans_to_mat(tf.qxyzw, tf.trans)
        stamps = [tf.stamp for tf in series]
        i = int(np.searchsorted(stamps, stamp))
        if i <= 0:
            tf = series[0]
            return _quat_trans_to_mat(tf.qxyzw, tf.trans)
        if i >= len(series):
            tf = series[-1]
            return _quat_trans_to_mat(tf.qxyzw, tf.trans)
        a, b = series[i - 1], series[i]
        u = (stamp - a.stamp) / max(b.stamp - a.stamp, 1e-12)
        qa, qb = np.asarray(a.qxyzw, np.float64), np.asarray(b.qxyzw, np.float64)
        if np.dot(qa, qb) < 0:
            qb = -qb
        q = (1 - u) * qa + u * qb
        t = (1 - u) * np.asarray(a.trans) + u * np.asarray(b.trans)
        return _quat_trans_to_mat(q, t)

    def frames(self) -> List[str]:
        names = set()
        for p, c in self._series:
            names.add(p)
            names.add(c)
        return sorted(names)

    def lookup(self, target: str, source: str, stamp: float) -> np.ndarray:
        """T_target_source at `stamp` as float32 (4, 4); raises KeyError if
        the frames are not connected."""
        self._ensure_sorted()
        if target == source:
            return np.eye(4, dtype=np.float32)
        adj: Dict[str, List[Tuple[str, Tuple[str, str], bool]]] = {}
        for (p, c) in self._series:
            adj.setdefault(p, []).append((c, (p, c), False))   # parent→child
            adj.setdefault(c, []).append((p, (p, c), True))    # child→parent
        # BFS from source to target
        prev: Dict[str, Tuple[str, Tuple[str, str], bool]] = {source: None}
        queue = [source]
        while queue and target not in prev:
            node = queue.pop(0)
            for nxt, key, inv in adj.get(node, ()):
                if nxt not in prev:
                    prev[nxt] = (node, key, inv)
                    queue.append(nxt)
        if target not in prev:
            raise KeyError(f"no TF path {source!r} -> {target!r} "
                           f"(frames: {self.frames()})")
        # Walk back target→source collecting hops, then compose source→target.
        hops = []
        node = target
        while node != source:
            pnode, key, inv = prev[node]
            hops.append((key, inv))
            node = pnode
        m = np.eye(4, dtype=np.float64)
        for key, inv in hops:  # hops are ordered target-side first
            e = self._edge_at(key, stamp)
            # edge is T_parent_child; walking child→parent applies it as-is,
            # walking parent→child applies the inverse
            step = np.linalg.inv(e) if not inv else e
            m = m @ step
        return m.astype(np.float32)

    @classmethod
    def from_bag(cls, reader: BagReader,
                 topics: Tuple[str, ...] = ("/tf", "/tf_static")) -> "TfBuffer":
        buf = cls()
        for msg in reader.messages(list(topics)):
            for tf in msg.decode():
                buf.add(tf)
        return buf

    def load_static_csv(self, path: str, parent: str = "base_link"):
        """Load a reference static-TF CSV (`child,x,y,z,qx,qy,qz,qw` rows —
        cfg/*_static_tfs*.csv; the extrinsics the reference's data provider
        routes separately from the dynamic tree,
        rosbag_data_provider.cpp:152-159)."""
        import csv as _csv
        with open(path, newline="") as f:
            for row in _csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue  # '#name,...' header (tesse_* variant)
                if len(row) < 8:
                    raise ValueError(
                        f"{path}: expected child,x,y,z,qx,qy,qz,qw[,comment] "
                        f"rows, got {len(row)} fields: {row!r}")
                # trailing fields (the tesse files carry a comment column)
                # are ignored
                child = row[0].strip()
                vals = [float(v) for v in row[1:8]]
                self.add_static(parent, child, np.array(vals[3:7]),
                                np.array(vals[0:3]))
        return self


# ---------------------------------------------------------------------------
# Dataset


class RosbagDataset:
    """Frames from a ROS1 bag — the RosbagDataProvider equivalent.

    Two input modes, matching the reference's two front doors:
      - depth_topic (+ optional semantic_topic image): CS2's synchronized
        image streams (kimera_semantics_rosbag.cpp:78-145);
      - pointcloud_topic (organized XYZRGB cloud): the live node's
        "pointcloud" subscription (CS1), inverted back to depth+color images.

    Timestamp lockstep is enforced like the reference's CHECKs
    (rosbag_data_provider.cpp:178-190, kimera_semantics_rosbag.cpp:94-97):
    streams must pair within `stamp_tolerance`, else ValueError. Frames
    go to `device`.
    """

    def __init__(self, path: str, depth_topic: Optional[str] = None,
                 semantic_topic: Optional[str] = None,
                 cam_info_topic: Optional[str] = None,
                 pointcloud_topic: Optional[str] = None,
                 world_frame: str = "world",
                 sensor_frame: Optional[str] = None,
                 label_map: Optional[LabelColorMap] = None,
                 intr: Optional[PinholeIntrinsics] = None,
                 stamp_tolerance: float = 0.01,
                 semantic_is_label_image: bool = False,
                 static_tf_csv: Optional[str] = None,
                 static_tf_parent: str = "base_link", device="cuda"):
        if (depth_topic is None) == (pointcloud_topic is None):
            raise ValueError("need exactly one of depth_topic / pointcloud_topic")
        self.device = resolve(device)
        self.label_map = label_map or LabelColorMap.random()
        reader = BagReader(path)
        self.tf = TfBuffer()
        if static_tf_csv:
            self.tf.load_static_csv(static_tf_csv, parent=static_tf_parent)
        self.world_frame = world_frame
        self._semantic_is_label_image = semantic_is_label_image

        # Single pass over the bag (it is fully read + decompressed per
        # messages() call): TF and the selected data topics together.
        tf_topics = ("/tf", "/tf_static")
        topics = [t for t in (depth_topic, semantic_topic, cam_info_topic,
                              pointcloud_topic) if t] + list(tf_topics)
        depth_msgs: List[ImageMsg] = []
        sem_msgs: List[ImageMsg] = []
        clouds: List[PointCloud2Msg] = []
        for msg in reader.messages(topics):
            if msg.topic == depth_topic:
                depth_msgs.append(msg.decode())
            elif msg.topic == semantic_topic:
                sem_msgs.append(msg.decode())
            elif msg.topic == pointcloud_topic:
                clouds.append(msg.decode())
            elif msg.topic in tf_topics:
                for tf in msg.decode():
                    self.tf.add(tf)
            elif msg.topic == cam_info_topic and intr is None:
                intr = msg.decode().intrinsics()

        if pointcloud_topic:
            clouds.sort(key=lambda m: m.stamp)
            self._clouds = clouds
            self._pairs = None
            if not clouds:
                raise ValueError(f"{path}: no messages on {pointcloud_topic!r}")
            if intr is None:
                raise ValueError("pointcloud mode needs cam_info_topic or intr")
            self.sensor_frame = sensor_frame or clouds[0].frame_id
        else:
            depth_msgs.sort(key=lambda m: m.stamp)
            sem_msgs.sort(key=lambda m: m.stamp)
            if not depth_msgs:
                raise ValueError(f"{path}: no messages on {depth_topic!r}")
            if intr is None:
                raise ValueError(
                    f"{path}: no CameraInfo on {cam_info_topic!r} — pass intr=")
            self._clouds = None
            self._pairs = self._pair_streams(depth_msgs, sem_msgs,
                                             semantic_topic, stamp_tolerance)
            self.sensor_frame = sensor_frame or depth_msgs[0].frame_id
        self.intr = intr

    @staticmethod
    def _pair_streams(depth_msgs, sem_msgs, semantic_topic, tol):
        if not semantic_topic:
            return [(d, None) for d in depth_msgs]
        if not sem_msgs:
            raise ValueError(
                f"no messages on semantic topic {semantic_topic!r} — is the "
                "topic name right? (pass --semantic-topic '' for "
                "geometric-only integration)")
        # lockstep pairing with the reference's stream-consistency contract
        if len(sem_msgs) != len(depth_msgs):
            raise ValueError(
                f"stream length mismatch: {len(depth_msgs)} depth vs "
                f"{len(sem_msgs)} semantic frames (rosbag_data_provider.cpp"
                ":178-190 contract)")
        pairs = list(zip(depth_msgs, sem_msgs))
        for d, s in pairs:
            if abs(d.stamp - s.stamp) > tol:
                raise ValueError(
                    f"depth/semantic timestamps diverge: {d.stamp} vs "
                    f"{s.stamp} (> {tol}s; kimera_semantics_rosbag.cpp:94-97)")
        return pairs

    def __len__(self):
        return len(self._clouds if self._clouds is not None else self._pairs)

    def pose(self, stamp: float) -> np.ndarray:
        return self.tf.lookup(self.world_frame, self.sensor_frame, stamp)

    def host_frame(self, i: int) -> dict:
        """Frame i decoded to numpy arrays (no device work): depth (m),
        labels (decoded from the semantic colours through the label map
        where the bag carries colours), colors where it does, T_G_C."""
        if self._clouds is not None:
            cloud = self._clouds[i]
            depth, rgb = cloud.organized_depth_colors()
            return {"depth": depth, "colors": rgb,
                    "labels": self.label_map.labels_from_colors(rgb),
                    "T_G_C": self.pose(cloud.stamp)}
        d, s = self._pairs[i]
        out = {"depth": d.as_depth_m(), "T_G_C": self.pose(d.stamp)}
        if s is None:
            out["labels"] = np.zeros(d.data.shape[:2], np.int32)
        elif self._semantic_is_label_image or s.encoding in ("mono8",
                                                             "mono16",
                                                             "32SC1"):
            out["labels"] = s.data.astype(np.int32)
        else:
            out["colors"] = s.as_rgb()
            out["labels"] = self.label_map.labels_from_colors(out["colors"])
        return out

    def to_frame(self, arrays: dict) -> Frame:
        return frame_from_images(
            depth=arrays["depth"], intr=self.intr, label_map=self.label_map,
            labels=arrays.get("labels"), colors=arrays.get("colors"),
            T_G_C=arrays["T_G_C"], device=self.device)

    def frame(self, i: int) -> Frame:
        return self.to_frame(self.host_frame(i))

    def host_frames(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self.host_frame(i)

    def __iter__(self) -> Iterator[Frame]:
        for i in range(len(self)):
            yield self.frame(i)


def write_dataset_bag(path: str, dataset, num_frames: Optional[int] = None,
                      world_frame: str = "world", sensor_frame: str = "cam",
                      depth_topic: str = "/depth/image_raw",
                      semantic_topic: str = "/semantic/image_raw",
                      cam_info_topic: str = "/depth/camera_info",
                      compression: str = "none", t0: float = 100.0,
                      rate_hz: float = 5.0):
    """Materialize any dataset (sim or directory) as a replayable .bag,
    as io/dataset.save_directory_dataset writes a directory. Depth is
    written 16UC1 millimeters (the reference demo bag's encoding), semantics
    as an rgb8 color image via the dataset's label map."""
    n = num_frames if num_frames is not None else len(dataset)
    intr = dataset.intr
    lmap = dataset.label_map
    host = lambda x: (x.cpu().numpy() if hasattr(x, "cpu")  # noqa: E731
                      else np.asarray(x))
    with BagWriter(path, compression=compression) as w:
        for i in range(n):
            f = dataset.frame(i)
            stamp = t0 + i / rate_hz
            depth_mm = np.clip(np.round(host(f.depth) * 1000.0),
                               0, 65535)
            w.write(depth_topic, "sensor_msgs/Image",
                    encode_image(depth_mm.astype(np.uint16), "16UC1", stamp,
                                 sensor_frame), stamp)
            colors = np.asarray(
                lmap.colors_from_labels(host(f.labels))).astype(np.uint8)
            w.write(semantic_topic, "sensor_msgs/Image",
                    encode_image(colors, "rgb8", stamp, sensor_frame), stamp)
            w.write(cam_info_topic, "sensor_msgs/CameraInfo",
                    encode_camera_info(intr, stamp, sensor_frame), stamp)
            T = host(f.T_G_C).astype(np.float64)
            q = _mat_to_quat(T[:3, :3])
            w.write("/tf", "tf2_msgs/TFMessage", encode_tf_message([
                TransformStampedMsg(stamp=stamp, parent=world_frame,
                                    child=sensor_frame, qxyzw=q,
                                    trans=T[:3, 3])]), stamp)
    return path


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (x, y, z, w), Shepperd's method."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        x = 0.25 * s
        w = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        y = 0.25 * s
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        z = 0.25 * s
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
    return np.array([x, y, z, w], np.float64)
