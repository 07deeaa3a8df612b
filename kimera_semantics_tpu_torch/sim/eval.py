"""GT-vs-test evaluation utilities — the SimulationServer comparison stage.

Counterpart: kimera_semantics_tpu/sim/eval.py (compare_to_world,
compare_grids, mesh_surface_error). The ground-truth SDF is evaluated on
the grid's device.

Equivalent of the voxblox layer-error utilities used by `semantic_simulator_eval`
(CS3: integrate synthetic views -> compare test vs GT layers) plus mesh-level
error metrics for the BASELINE "mesh within tolerance" contract.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import FusionConfig
from ..grid import blocks as gblocks
from ..grid.blocks import VoxelGrid
from ..sim import world as sim_world


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@dataclasses.dataclass
class LayerErrors:
    rmse_tsdf: float          # RMSE of TSDF vs GT over co-observed voxels
    mae_tsdf: float
    label_accuracy: float     # MLE label match rate over co-observed voxels
    num_compared: int


def compare_to_world(grid: VoxelGrid, cfg: FusionConfig,
                     world: sim_world.World,
                     min_weight: float = 1e-3,
                     surface_band: Optional[float] = None) -> LayerErrors:
    """Compare a reconstructed grid against the analytic world SDF.

    `surface_band`: if set, restrict to voxels whose GT |sdf| is below it
    (surface accuracy — carved free space is clamped by truncation and would
    otherwise dominate)."""
    g = cfg.grid
    vps = g.voxels_per_side
    trunc = cfg.tsdf.truncation_distance
    nb = int(grid.n_blocks)
    dist = _host(gblocks.tsdf_distance(grid, trunc)[:nb])
    wsum = _host(grid.wsum[:nb])
    labels = _host(gblocks.mle_labels(grid)[:nb])
    coords = _host(grid.block_coords[:nb])

    ii = np.arange(vps)
    local = np.stack(np.meshgrid(ii, ii, ii, indexing="ij"), -1).reshape(-1, 3)
    centers = ((coords[:, None, :] * vps + local[None, :, :]) + 0.5) * g.voxel_size
    dev = grid.wsum.device
    sdf_gt, lab_gt = sim_world.world_sdf(
        world.to(dev), torch.as_tensor(centers.reshape(-1, 3),
                                       dtype=torch.float32, device=dev))
    sdf_gt = np.clip(_host(sdf_gt).reshape(nb, -1), -trunc, trunc)
    lab_gt = _host(lab_gt).reshape(nb, -1)

    mask = wsum > min_weight
    if surface_band is not None:
        mask &= np.abs(sdf_gt) < surface_band
    n = int(mask.sum())
    if n == 0:
        return LayerErrors(np.nan, np.nan, np.nan, 0)
    err = (dist - sdf_gt)[mask]
    acc = (labels == lab_gt)[mask].mean()
    return LayerErrors(
        rmse_tsdf=float(np.sqrt((err ** 2).mean())),
        mae_tsdf=float(np.abs(err).mean()),
        label_accuracy=float(acc),
        num_compared=n,
    )


def compare_grids(test: VoxelGrid, gt: VoxelGrid, cfg_test: FusionConfig,
                  cfg_gt: FusionConfig, min_weight: float = 1e-3) -> LayerErrors:
    """Voxel-wise comparison of two grids with identical geometry
    (test vs GT layers, semantic_simulation_server.cpp:26-30 viz path)."""
    assert cfg_test.grid.voxel_size == cfg_gt.grid.voxel_size
    trunc = cfg_test.tsdf.truncation_distance
    nb = int(test.n_blocks)
    coords = test.block_coords[:nb].to(gt.table_keys.device)
    slots_gt = _host(gblocks.lookup_slots(gt, coords, cfg_gt.grid))
    present = slots_gt < cfg_gt.grid.block_capacity
    dist_t = _host(gblocks.tsdf_distance(test, trunc)[:nb])
    dist_g = _host(gblocks.tsdf_distance(gt, trunc))[slots_gt]
    w_t = _host(test.wsum[:nb])
    w_g = _host(gt.wsum)[slots_gt]
    lab_t = _host(gblocks.mle_labels(test)[:nb])
    lab_g = _host(gblocks.mle_labels(gt))[slots_gt]
    mask = (w_t > min_weight) & (w_g > min_weight) & present[:, None]
    n = int(mask.sum())
    if n == 0:
        return LayerErrors(np.nan, np.nan, np.nan, 0)
    err = (dist_t - dist_g)[mask]
    return LayerErrors(
        rmse_tsdf=float(np.sqrt((err ** 2).mean())),
        mae_tsdf=float(np.abs(err).mean()),
        label_accuracy=float((lab_t == lab_g)[mask].mean()),
        num_compared=n,
    )


def mesh_surface_error(mesh_vertices: np.ndarray,
                       world: sim_world.World) -> dict:
    """Mesh-level accuracy: |analytic sdf| at mesh vertices (the 'mesh within
    tolerance' metric of BASELINE.json)."""
    if len(mesh_vertices) == 0:
        return {"mean": np.nan, "rms": np.nan, "p95": np.nan, "num": 0}
    sdf, _ = sim_world.world_sdf(
        world, torch.as_tensor(np.asarray(mesh_vertices),
                               dtype=torch.float32,
                               device=world.center.device))
    a = np.abs(_host(sdf))
    return {"mean": float(a.mean()), "rms": float(np.sqrt((a ** 2).mean())),
            "p95": float(np.percentile(a, 95)), "num": int(len(a))}
