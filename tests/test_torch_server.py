"""The port's serving pipeline and CLI (kimera_semantics_tpu_torch/server)
against the JAX package's (CPU): the fast server over a few tiny synthetic
frames (stats exact, the final mesh equal as welded vertex and triangle
sets), its pointclouds and compare_grids, throttling, the incremental mesh
clearing `updated`, checkpoints, the presets, the `batch` and `sim-eval`
commands (batch also from a .bag with --esdf and --enable-icp), and the
flags that are not ported yet.

Tolerances: stats, triangle counts and welded sets exact (vertices welded
on the 2^-10-voxel grid of connect_mesh); sim-eval's errors within 1e-6
relative, its label accuracy and counts exact.
"""

import json

import numpy as np
import pytest
import torch

from kimera_semantics_tpu import config as jcfg
from kimera_semantics_tpu.core.camera import PinholeIntrinsics
from kimera_semantics_tpu.core.color import LabelColorMap as JLabelColorMap
from kimera_semantics_tpu.io.dataset import SyntheticDataset
from kimera_semantics_tpu.server import node as jnode
from kimera_semantics_tpu.server import pipeline as jpipeline

from kimera_semantics_tpu_torch import config as tcfg
from kimera_semantics_tpu_torch.core.camera import PinholeIntrinsics as TIntr
from kimera_semantics_tpu_torch.core.color import LabelColorMap
from kimera_semantics_tpu_torch.grid import blocks as tblocks
from kimera_semantics_tpu_torch.io import dataset as tdataset
from kimera_semantics_tpu_torch.models import common as tcommon
from kimera_semantics_tpu_torch.server import node as tnode
from kimera_semantics_tpu_torch.server import pipeline as tpipeline
from kimera_semantics_tpu_torch.server import presets as tpresets

INTR = PinholeIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                         height=60)
TINTR = TIntr(**INTR.__dict__)


def configs(method="fast"):
    return [m.FusionConfig(
        grid=m.GridConfig(voxel_size=0.2, voxels_per_side=8,
                          block_capacity=1024),
        tsdf=m.TsdfConfig(truncation_distance=0.4, max_ray_length_m=8.0),
        semantic=m.SemanticConfig(semantic_measurement_probability=0.8),
        pipeline=m.PipelineConfig(block_budget=512, alloc_stride=2,
                                  max_rays=4096),
        integrator=m.IntegratorType(method)) for m in (jcfg, tcfg)]


def frames(n):
    ds = SyntheticDataset(num_frames=8, intr=INTR,
                          label_map=JLabelColorMap.random())
    fs = [ds.frame(i) for i in range(n)]
    return fs, [tcommon.frame_from_images(
        np.asarray(f.depth), labels=np.asarray(f.labels),
        colors=np.asarray(f.colors), T_G_C=np.asarray(f.T_G_C),
        device="cpu") for f in fs]


def welded(mesh, voxel_size):
    """The mesh as welded sets: quantized vertex positions and triangles of
    them."""
    q = np.round(mesh.vertices / (voxel_size / 1024.0)).astype(np.int64)
    verts = set(map(tuple, q))
    tris = {tuple(sorted(map(tuple, q[t]))) for t in mesh.triangles}
    return verts, tris


@pytest.fixture(scope="module")
def servers():
    """The fast server of each package after three frames, meshing every
    second frame (the port's pipelined)."""
    cj, ct = configs()
    fj, ft = frames(3)
    sj = jpipeline.SemanticTsdfServer(
        cj, INTR, JLabelColorMap.random(),
        jpipeline.ServerConfig(mesh_every_n_frames=2))
    st = tpipeline.SemanticTsdfServer(
        ct, TINTR, LabelColorMap.random(),
        tpipeline.ServerConfig(mesh_every_n_frames=2, live_mesh_port=-1,
                               live_mesh_path=""), device="cpu")
    for a, b in zip(fj, ft):
        assert sj.insert_frame(a) and st.insert_frame(b)
    return ct, sj, st


def test_fast_server_matches_jax(servers):
    ct, sj, st = servers
    assert st.stats() == sj.stats()
    assert st.stats()["blocks"] > 0 and st.mesh_cycles == 1
    a, b = sj.generate_mesh(), st.generate_mesh()
    assert a.num_triangles == b.num_triangles > 0
    assert welded(b, 0.2) == welded(a, 0.2)


def test_pointclouds_match_jax(servers):
    """The surface (with mesh colours), tsdf and freespace pointclouds, as
    sets of voxel centres: points and colours exact, distances within 1e-6
    relative (the grids' float channels agree to that)."""
    _, sj, st = servers

    def rows(*cols):
        a = np.concatenate([np.asarray(c, np.float64).reshape(len(c), -1)
                            for c in cols], axis=1)
        return a[np.lexsort(a.T[::-1])]
    (pj, cj), (pt, ct_) = sj.surface_pointcloud(), st.surface_pointcloud()
    assert len(pt) > 0
    np.testing.assert_array_equal(rows(pt, ct_), rows(pj, cj))
    (pj, dj), (pt, dt) = sj.tsdf_pointcloud(), st.tsdf_pointcloud()
    a, b = rows(pt, dt), rows(pj, dj)
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    np.testing.assert_allclose(a[:, 3], b[:, 3], rtol=1e-6, atol=1e-7)
    fj, ft = sj.freespace_pointcloud(), st.freespace_pointcloud()
    assert len(ft) > 0
    np.testing.assert_array_equal(rows(ft), rows(fj))


def test_compare_grids_matches_jax(servers):
    """sim/eval.py compare_grids of the port's grid against the JAX
    server's, in each package (the other's grid carried across): the same
    errors, counts exact."""
    import jax.numpy as jnp
    from kimera_semantics_tpu.grid import blocks as jblocks
    from kimera_semantics_tpu.sim import eval as jeval
    from kimera_semantics_tpu_torch import interop
    from kimera_semantics_tpu_torch.sim import eval as teval
    cj, _ = configs()
    ct, sj, st = servers
    j_of_t = jblocks.VoxelGrid(**{k: jnp.asarray(v) for k, v in
                                  interop.grid_to_numpy(st.grid).items()})
    t_of_j = interop.grid_from_numpy(
        {k: np.asarray(getattr(sj.grid, k)) for k in tblocks.FIELDS}, ct,
        device="cpu")
    a = jeval.compare_grids(j_of_t, sj.grid, cj, cj)
    b = teval.compare_grids(st.grid, t_of_j, ct, ct)
    assert b.num_compared == a.num_compared > 0
    assert b.label_accuracy == a.label_accuracy
    assert b.rmse_tsdf == pytest.approx(a.rmse_tsdf, rel=1e-6, abs=1e-9)
    assert b.mae_tsdf == pytest.approx(a.mae_tsdf, rel=1e-6, abs=1e-9)


def test_incremental_mesh_clears_updated(servers):
    ct, _, st = servers
    st.join_mesh()
    assert bool(st.grid.updated.any())      # frame 3 came after the cycle
    m = st.update_mesh()
    assert m.num_triangles > 0
    assert not bool(st.grid.updated.any())
    assert st.update_mesh().num_triangles == 0


def test_throttling():
    _, ct = configs("projective")
    _, ft = frames(3)
    st = tpipeline.SemanticTsdfServer(
        ct, TINTR, server_cfg=tpipeline.ServerConfig(min_frame_interval=0.5),
        device="cpu")
    assert st.insert_frame(ft[0], stream_time=10.0)
    assert not st.insert_frame(ft[1], stream_time=10.2)
    assert st.insert_frame(ft[2], stream_time=10.6)
    assert st.stats()["frames"] == 2


def test_live_cache_equals_generate_mesh(tmp_path):
    """Pipelined incremental meshing into the MeshLayer cache (and the live
    PLY): after a final update_mesh the cached full mesh equals
    generate_mesh as welded sets."""
    _, ct = configs("projective")
    _, ft = frames(4)
    live = str(tmp_path / "live.ply")
    st = tpipeline.SemanticTsdfServer(
        ct, TINTR, server_cfg=tpipeline.ServerConfig(
            mesh_every_n_frames=2, live_mesh_path=live), device="cpu")
    for f in ft:
        st.insert_frame(f)
    st.update_mesh()
    full, gen = st.mesh_cache.full_mesh(), st.generate_mesh()
    assert gen.num_triangles == full.num_triangles > 0
    assert welded(full, 0.2) == welded(gen, 0.2)
    from kimera_semantics_tpu_torch.io import ply
    assert len(ply.read_ply(live)[2]) == full.num_triangles


def test_checkpoint_round_trip(servers, tmp_path):
    ct, _, st = servers
    st.save_map(str(tmp_path / "m.ksdv"))
    st.save_map(str(tmp_path / "m.vxblx"))
    for ext in ("ksdv", "vxblx"):
        other = tpipeline.SemanticTsdfServer(ct, TINTR, device="cpu")
        other.load_map(str(tmp_path / f"m.{ext}"))
        names = (tblocks.FIELDS if ext == "ksdv"
                 else ("n_blocks", "wsum"))
        for name in names:
            a, b = getattr(st.grid, name), getattr(other.grid, name)
            if ext == "vxblx" and name == "wsum":
                nb = int(st.grid.n_blocks)
                s2 = tblocks.lookup_slots(other.grid, st.grid.block_coords[:nb],
                                          ct.grid)
                a, b = a[:nb], b[s2.long()]
            assert torch.equal(a, b), (ext, name)


def test_every_preset_parses():
    for name in tpresets.PRESETS:
        args = tnode.parse_args(["sim-eval", "--preset", name, "--device",
                                 "cpu"])
        cfg, lmap = tnode._build(args)
        assert cfg.grid.io_vps == tpresets.PRESETS[name]["voxels_per_side"]
        assert cfg.integrator.value == tpresets.PRESETS[name]["method"]
    args = tnode.parse_args(["batch", "d", "--preset", "demo",
                             "--method", "projective", "--storage-vps", "32"])
    cfg, _ = tnode._build(args)
    assert cfg.grid.voxels_per_side == 32 and cfg.grid.io_vps == 32
    with pytest.raises(SystemExit):
        tnode.parse_args(["sim-eval", "--preset", "nope"])


SIM = ["sim-eval", "--num-viewpoints", "4", "--voxel-size", "0.2",
       "--voxels-per-side", "8", "--block-capacity", "1024", "--truncation",
       "0.4", "--method", "projective", "--block-budget", "512",
       "--mesh-out", ""]


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_sim_eval_matches_jax(capsys):
    jnode.main(SIM)
    ref = last_json(capsys)
    got = tnode.main(SIM + ["--device", "cpu"])
    assert last_json(capsys) == json.loads(json.dumps(got))
    for k in ("label_accuracy", "compared", "frames", "blocks", "overflow",
              "dropped_rays", "observed_voxels"):
        assert got[k] == ref[k], k
    for k in ("rmse_tsdf", "mae_tsdf"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
    assert got["mesh_error"]["num"] == ref["mesh_error"]["num"] > 0
    for k in ("mean", "rms", "p95"):
        assert got["mesh_error"][k] == pytest.approx(
            ref["mesh_error"][k], rel=1e-6), k


def test_cli_batch(tmp_path, capsys):
    """batch on a directory dataset at 32^3 literal storage (the unfused
    route): a mesh, a .vxblx that reloads to the grid's TSDF voxels."""
    intr = PinholeIntrinsics(fx=40.0, fy=40.0, cx=31.5, cy=23.5, width=64,
                             height=48)
    ds = SyntheticDataset(num_frames=3, intr=intr,
                          label_map=JLabelColorMap.random())
    tdataset.save_directory_dataset(str(tmp_path / "d"), ds)
    mesh, vx = str(tmp_path / "m.ply"), str(tmp_path / "m.vxblx")
    out = tnode.main(["batch", str(tmp_path / "d"), "--device", "cpu",
                      "--voxel-size", "0.2", "--voxels-per-side", "32",
                      "--storage-vps", "32", "--block-capacity", "16",
                      "--block-budget", "16", "--method", "projective",
                      "--mesh-out", mesh, "--map-out", vx, "--validate"])
    assert last_json(capsys)["triangles"] == out["triangles"] > 0
    assert out["frames"] == 3 and out["overflow"] == 0
    assert out["frames_per_s"] > 0 and out["invariants"]["n_blocks"] > 0
    from kimera_semantics_tpu_torch.io import ply, vxblx
    assert len(ply.read_ply(mesh)[2]) == out["triangles"]
    args = tnode.parse_args(["batch", "d", "--voxel-size", "0.2",
                             "--voxels-per-side", "32", "--storage-vps",
                             "32", "--block-capacity", "16"])
    cfg, _ = tnode._build(args)
    g = vxblx.load_vxblx(vx, cfg, device="cpu")
    assert int(g.n_blocks) == out["blocks"]


@pytest.mark.parametrize("flag", [["--esdf"], ["--esdf-every", "3"],
                                  ["--enable-icp"], ["--devices", "2"]])
def test_slice_d_flags_exit(flag, tmp_path):
    """The flags of slice D run now; only --devices > 1 (slice E) exits
    with a message."""
    args = tnode.parse_args(["batch", str(tmp_path / "x.bag"), "--device",
                             "cpu"] + flag)
    if flag[0] == "--devices":
        with pytest.raises(SystemExit, match="slice E"):
            tnode._refuse_slice_d(args)
        with pytest.raises(SystemExit, match="slice E"):
            tnode.main(["batch", str(tmp_path), "--device", "cpu"] + flag)
        return
    tnode._refuse_slice_d(args)
    srv = tpipeline.SemanticTsdfServer(
        configs()[1], TINTR, device="cpu",
        server_cfg=tpipeline.ServerConfig(
            enable_icp=args.enable_icp,
            esdf_every_n_frames=args.esdf_every))
    assert srv.server_cfg.enable_icp == args.enable_icp


def test_cli_batch_bag_esdf_icp_matches_jax(tmp_path, capsys):
    """`batch golden_scene.bag --esdf --enable-icp` (the reference's rosbag
    batch with scan-to-map ICP and the batch ESDF into tsdf_esdf.vxblx)
    against the JAX CLI on the bag's first 4 frames: the JSON line equal,
    both layers written over the same blocks."""
    from kimera_semantics_tpu_torch.io import vxblx
    argv = ["batch", "tests/fixtures/golden_scene.bag", "--voxel-size",
            "0.1", "--voxels-per-side", "8", "--block-capacity", "1024",
            "--truncation", "0.2", "--max-rays", "12288", "--esdf",
            "--esdf-max-dist", "2.0", "--enable-icp", "--max-frames", "4",
            "--mesh-out", ""]
    pj, pt = str(tmp_path / "j.vxblx"), str(tmp_path / "t.vxblx")
    jnode.main(argv + ["--map-out", pj])
    ref = last_json(capsys)
    got = tnode.main(argv + ["--map-out", pt, "--device", "cpu"])
    assert last_json(capsys) == json.loads(json.dumps(got))
    for k in ("frames", "triangles", "blocks", "overflow", "dropped_rays",
              "observed_voxels", "esdf_voxels"):
        assert got[k] == ref[k], k
    assert got["frames"] == 4 and got["esdf_voxels"] > 0
    sj, st = vxblx.read_sections(pj), vxblx.read_sections(pt)
    assert [s.type for s in st] == [s.type for s in sj] == ["tsdf", "esdf"]
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.block_origins, b.block_origins)
    flags = [s.voxel_data.reshape(len(s.block_origins), -1, 2)[..., 1]
             for s in (st[1], sj[1])]
    np.testing.assert_array_equal(*flags)


def test_cli_bag_missing_static_tf_csv_is_an_error(tmp_path):
    """Dropped extrinsics would corrupt every pose: a static-TF CSV that
    cannot be found ends the run, as in the JAX CLI."""
    for node in (jnode, tnode):
        with pytest.raises(SystemExit, match="static-TF CSV"):
            node.main(["batch", "tests/fixtures/golden_scene.bag",
                       "--static-tf-csv", "no_such_static_tfs.csv",
                       "--cfg-dir", str(tmp_path), "--voxel-size", "0.1",
                       "--block-capacity", "64"]
                      + (["--device", "cpu"] if node is tnode else []))
