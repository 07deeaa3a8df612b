"""The port's bag I/O (kimera_semantics_tpu_torch/io/rosbag.py, convert.py,
label_csv_tools.py) against the JAX package's (CPU): the four message
codecs on the same bytes, the bag writer writing the JAX writer's bytes
(plain and bz2 chunks), TfBuffer with interpolation and the static-TF CSV,
RosbagDataset on tests/fixtures/golden_scene.bag and in pointcloud mode
yielding the JAX reader's frames, the host/device split used by the
prefetch thread, the convert round trip and the label CSV tools.

Everything compared here is exact, as both packages parse the same bytes
with the same numpy code and build frames from the same arrays; except the
convert round trip's poses, which pass through a quaternion once more
(within 1e-6).
"""

import struct

import numpy as np
import pytest
import torch

from kimera_semantics_tpu.core.camera import PinholeIntrinsics as JIntr
from kimera_semantics_tpu.core.color import LabelColorMap as JLmap
from kimera_semantics_tpu.io import label_csv_tools as jcsv
from kimera_semantics_tpu.io import rosbag as jrb
from kimera_semantics_tpu.io.dataset import SyntheticDataset

from kimera_semantics_tpu_torch.core.camera import PinholeIntrinsics
from kimera_semantics_tpu_torch.core.color import LabelColorMap
from kimera_semantics_tpu_torch.io import convert
from kimera_semantics_tpu_torch.io import label_csv_tools as tcsv
from kimera_semantics_tpu_torch.io import rosbag as trb

BAG = "tests/fixtures/golden_scene.bag"
TOPICS = dict(depth_topic="/depth/image_raw",
              semantic_topic="/semantic/image_raw",
              cam_info_topic="/depth/camera_info")


def N(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_frames_equal(tf, jf, pose_atol=0.0):
    for name in ("depth", "labels", "colors", "T_G_C"):
        a, b = N(getattr(tf, name)), N(getattr(jf, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b.astype(a.dtype), rtol=0,
                                   atol=pose_atol if name == "T_G_C" else 0,
                                   err_msg=name)


def encode_cloud(stamp, frame_id, xyz, rgb):
    """tests/test_rosbag.py's organised XYZRGB PointCloud2 encoder."""
    h, w = xyz.shape[:2]
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("rgb", 16, 7)]
    step = 32
    buf = jrb._ser_header(stamp, frame_id) + struct.pack("<II", h, w)
    buf += struct.pack("<I", len(fields))
    for name, off, dt in fields:
        buf += jrb._ser_string(name) + struct.pack("<IBI", off, dt, 1)
    packed = ((rgb[..., 0].astype(np.uint32) << 16)
              | (rgb[..., 1].astype(np.uint32) << 8)
              | rgb[..., 2].astype(np.uint32))
    pts = np.zeros((h, w, step // 4), np.float32)
    pts[..., 0:3] = xyz
    pts[..., 4] = packed.view(np.float32)
    data = pts.tobytes()
    buf += struct.pack("<BII", 0, step, step * w)
    return buf + struct.pack("<I", len(data)) + data + b"\x01"


def test_codecs_on_the_same_bytes():
    rng = np.random.RandomState(0)
    for img, enc in ((rng.randint(0, 65535, (5, 7)).astype(np.uint16),
                      "16UC1"),
                     (rng.randint(0, 255, (5, 7, 3)).astype(np.uint8),
                      "rgb8"),
                     (rng.rand(5, 7).astype(np.float32), "32FC1")):
        raw = jrb.encode_image(img, enc, 12.5, "cam")
        assert trb.encode_image(img, enc, 12.5, "cam") == raw
        a, b = trb.decode_image(raw), jrb.decode_image(raw)
        np.testing.assert_array_equal(a.data, b.data)
        assert (a.encoding, a.stamp, a.frame_id) == (b.encoding, b.stamp,
                                                      b.frame_id)
        if enc != "rgb8":
            np.testing.assert_array_equal(a.as_depth_m(), b.as_depth_m())
    intr = JIntr(fx=320.0, fy=321.0, cx=319.5, cy=239.5, width=640,
                 height=480)
    raw = jrb.encode_camera_info(intr, 3.0, "cam")
    assert trb.encode_camera_info(PinholeIntrinsics(**intr.__dict__), 3.0,
                                  "cam") == raw
    assert trb.decode_camera_info(raw).intrinsics().__dict__ == \
        jrb.decode_camera_info(raw).intrinsics().__dict__
    tfs = [jrb.TransformStampedMsg(stamp=1.5, parent="world", child="base",
                                   qxyzw=np.array([0.1, 0.2, 0.3, 0.9]),
                                   trans=np.array([1.0, 2.0, 3.0]))]
    raw = jrb.encode_tf_message(tfs)
    assert trb.encode_tf_message([trb.TransformStampedMsg(
        **tfs[0].__dict__)]) == raw
    a, b = trb.decode_tf_message(raw)[0], jrb.decode_tf_message(raw)[0]
    assert (a.parent, a.child, a.stamp) == (b.parent, b.child, b.stamp)
    np.testing.assert_array_equal(a.qxyzw, b.qxyzw)
    xyz = rng.rand(4, 6, 3).astype(np.float32) + 0.5
    rgb = rng.randint(0, 255, (4, 6, 3)).astype(np.uint32)
    raw = encode_cloud(2.0, "cam", xyz, rgb)
    for x, y in zip(trb.decode_pointcloud2(raw).organized_depth_colors(),
                    jrb.decode_pointcloud2(raw).organized_depth_colors()):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def small():
    """Three small frames of the eval world (the JAX renderer)."""
    intr = JIntr(fx=24.0, fy=24.0, cx=15.5, cy=11.5, width=32, height=24)
    return SyntheticDataset(num_frames=3, intr=intr,
                            label_map=JLmap.random(21))


class PortView:
    """The JAX dataset's frames as the port's writer reads a dataset."""

    def __init__(self, ds):
        self.intr = PinholeIntrinsics(**ds.intr.__dict__)
        self.label_map = LabelColorMap.random(21)
        self._ds = ds

    def __len__(self):
        return len(self._ds)

    def frame(self, i):
        from kimera_semantics_tpu_torch.models.common import \
            frame_from_images
        f = self._ds.frame(i)
        return frame_from_images(np.asarray(f.depth),
                                 labels=np.asarray(f.labels),
                                 T_G_C=np.asarray(f.T_G_C),
                                 label_map=self.label_map, device="cpu")


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_writer_writes_jax_bytes(small, tmp_path, compression):
    pj, pt = str(tmp_path / "j.bag"), str(tmp_path / "t.bag")
    jrb.write_dataset_bag(pj, small, compression=compression)
    trb.write_dataset_bag(pt, PortView(small), compression=compression)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert trb.BagReader(pt).topics() == jrb.BagReader(pj).topics()


def test_tf_buffer_and_static_csv(tmp_path):
    pairs = []
    for m in (jrb, trb):
        buf = m.TfBuffer()
        for stamp, x in ((1.0, 0.0), (3.0, 2.0)):
            buf.add(m.TransformStampedMsg(
                stamp=stamp, parent="world", child="base",
                qxyzw=np.array([0, 0, np.sin(x / 4), np.cos(x / 4)]),
                trans=np.array([x, 1.0, 0.0])))
        buf.add_static("base", "cam", [0, 0, 0, 1.0], [0, 0, 0.5])
        pairs.append(buf)
    for stamp in (0.5, 2.0, 2.7, 9.0):
        np.testing.assert_array_equal(pairs[1].lookup("world", "cam", stamp),
                                      pairs[0].lookup("world", "cam", stamp))
    np.testing.assert_array_equal(pairs[1].lookup("cam", "world", 2.0),
                                  pairs[0].lookup("cam", "world", 2.0))
    with pytest.raises(KeyError):
        pairs[1].lookup("world", "nowhere", 1.0)
    csv = tmp_path / "static.csv"
    csv.write_text("#name,x,y,z,qx,qy,qz,qw,comment\n"
                   "cam,0.05,0.0,-0.25,0.0,0.0,0.7071067811865475,"
                   "0.7071067811865475,left\n")
    a = trb.TfBuffer().load_static_csv(str(csv), parent="base_link")
    b = jrb.TfBuffer().load_static_csv(str(csv), parent="base_link")
    np.testing.assert_array_equal(a.lookup("base_link", "cam", 0.0),
                                  b.lookup("base_link", "cam", 0.0))
    csv.write_text("cam,1,2\n")
    with pytest.raises(ValueError, match="expected child"):
        trb.TfBuffer().load_static_csv(str(csv))
    R = a.lookup("base_link", "cam", 0.0)[:3, :3].astype(np.float64)
    np.testing.assert_array_equal(trb._mat_to_quat(R), jrb._mat_to_quat(R))


def test_golden_bag_frames_match_jax_reader():
    jd = jrb.RosbagDataset(BAG, label_map=JLmap.random(21, seed=0), **TOPICS)
    td = trb.RosbagDataset(BAG, label_map=LabelColorMap.random(21, seed=0),
                           device="cpu", **TOPICS)
    assert len(td) == len(jd) == 12
    assert td.intr.__dict__ == jd.intr.__dict__
    assert td.sensor_frame == jd.sensor_frame
    for i in (0, 5, 11):
        assert_frames_equal(td.frame(i), jd.frame(i))
    # The prefetch split: numpy on the host, then the device.
    host = next(iter(td.host_frames()))
    assert all(isinstance(v, np.ndarray) for v in host.values())
    assert_frames_equal(td.to_frame(host), jd.frame(0))
    assert_frames_equal(next(iter(td)), jd.frame(0))


def test_pointcloud_mode_matches_jax_reader(tmp_path):
    path = str(tmp_path / "pc.bag")
    rng = np.random.RandomState(4)
    xyz = rng.rand(6, 8, 3).astype(np.float32) + 0.5
    rgb = rng.randint(0, 255, (6, 8, 3)).astype(np.uint32)
    intr = JIntr(fx=8, fy=8, cx=4, cy=3, width=8, height=6)
    with jrb.BagWriter(path) as w:
        w.write("/points", "sensor_msgs/PointCloud2",
                encode_cloud(5.0, "cam", xyz, rgb), 5.0)
        w.write("/tf", "tf2_msgs/TFMessage", jrb.encode_tf_message([
            jrb.TransformStampedMsg(stamp=5.0, parent="world", child="cam",
                                    qxyzw=np.array([0, 0, 0, 1.0]),
                                    trans=np.array([0.0, 0, 1.0]))]), 5.0)
    jd = jrb.RosbagDataset(path, pointcloud_topic="/points", intr=intr,
                           label_map=JLmap.random(21))
    td = trb.RosbagDataset(path, pointcloud_topic="/points",
                           intr=PinholeIntrinsics(**intr.__dict__),
                           label_map=LabelColorMap.random(21), device="cpu")
    assert len(td) == 1
    assert_frames_equal(td.frame(0), jd.frame(0))
    with pytest.raises(ValueError, match="exactly one"):
        trb.RosbagDataset(path, device="cpu")


def test_stream_contract_errors(tmp_path):
    path = str(tmp_path / "d.bag")
    img = np.zeros((4, 5), np.uint16)
    intr = PinholeIntrinsics(fx=4, fy=4, cx=2, cy=2, width=5, height=4)
    with trb.BagWriter(path) as w:
        for t in (1.0, 2.0):
            w.write("/d", "sensor_msgs/Image",
                    trb.encode_image(img, "16UC1", t, "cam"), t)
            w.write("/tf", "tf2_msgs/TFMessage", trb.encode_tf_message([
                trb.TransformStampedMsg(stamp=t, parent="world", child="cam",
                                        qxyzw=np.array([0, 0, 0, 1.0]),
                                        trans=np.array([t, 0, 0]))]), t)
        w.write("/s", "sensor_msgs/Image",
                trb.encode_image(np.zeros((4, 5), np.uint8), "mono8", 1.0,
                                 "cam"), 1.0)
    with pytest.raises(ValueError, match="no messages on semantic topic"):
        trb.RosbagDataset(path, depth_topic="/d", semantic_topic="/nope",
                          intr=intr, device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        trb.RosbagDataset(path, depth_topic="/d", semantic_topic="/s",
                          intr=intr, device="cpu")
    ds = trb.RosbagDataset(path, depth_topic="/d", intr=intr, device="cpu")
    assert len(ds) == 2 and int(ds.frame(1).labels.abs().sum()) == 0
    assert float(ds.frame(1).T_G_C[0, 3]) == 2.0


def test_convert_round_trip(small, tmp_path, capsys):
    bag1 = str(tmp_path / "a.bag")
    trb.write_dataset_bag(bag1, PortView(small))
    out_dir = str(tmp_path / "dir")
    convert.main(["bag-to-dir", bag1, out_dir, "--device", "cpu",
                  "--depth-topic", "/depth/image_raw",
                  "--semantic-topic", "/semantic/image_raw",
                  "--cam-info-topic", "/depth/camera_info"])
    bag2 = str(tmp_path / "b.bag")
    convert.main(["dir-to-bag", out_dir, bag2, "--compression", "bz2",
                  "--device", "cpu"])
    assert "wrote 3 frames" in capsys.readouterr().out
    kw = dict(label_map=LabelColorMap.random(21), device="cpu", **TOPICS)
    d1 = trb.RosbagDataset(bag1, **kw)
    d2 = trb.RosbagDataset(bag2, **kw)
    assert len(d2) == 3
    for i in range(3):
        assert_frames_equal(d2.frame(i), d1.frame(i), pose_atol=1e-6)


def test_label_csv_tools(tmp_path):
    rows = [dict(name="wall", red=10, green=20, blue=30),
            dict(name="floor", red=1, green=2, blue=3, alpha=128)]
    ids = {"wall": 3, "floor": 7}
    assert tcsv.join_color_and_id(rows, ids) == jcsv.join_color_and_id(rows,
                                                                       ids)
    with pytest.raises(KeyError):
        tcsv.join_color_and_id(rows, {"wall": 1})
    pt, pj = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    colors = {3: (10, 20, 30), 7: (1, 2, 3)}
    tcsv.write_label_csv(pt, colors, names={3: "wall"})
    jcsv.write_label_csv(pj, colors, names={3: "wall"})
    assert open(pt).read() == open(pj).read()
    lm = LabelColorMap.from_csv(pt)
    assert tuple(lm.label_colors[7]) == (1, 2, 3)
