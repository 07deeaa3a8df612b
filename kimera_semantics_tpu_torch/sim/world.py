"""Analytic SDF simulation world, the synthetic ground-truth generator.

Counterpart: kimera_semantics_tpu/sim/world.py (World, WorldBuilder,
default_eval_world, world_sdf, generate_semantic_sdf). Primitive objects with exact signed-distance
functions, each carrying the reference's label convention {Sphere->1,
Cube->2, Plane->3, Cylinder->4}, stored as a struct of tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SPHERE, CUBE, PLANE, CYLINDER = 0, 1, 2, 3
PRIMITIVE_LABELS = {SPHERE: 1, CUBE: 2, PLANE: 3, CYLINDER: 4}


@dataclasses.dataclass(frozen=True)
class World:
    kind: torch.Tensor    # (O,) int32 primitive type
    center: torch.Tensor  # (O, 3) float32
    params: torch.Tensor  # (O, 3) float32: sphere (r,-,-), cube half-extents,
                          #   plane unit normal, cylinder (r, h/2, -)
    label: torch.Tensor   # (O,) int32 semantic label

    @property
    def num_objects(self) -> int:
        return self.kind.shape[0]

    def to(self, device) -> "World":
        return World(*(t.to(device) for t in (self.kind, self.center,
                                               self.params, self.label)))


class WorldBuilder:
    """Host-side accumulation mirroring SimulationWorld::addObject."""

    def __init__(self):
        self._objs = []

    def _add(self, kind, center, params, label):
        self._objs.append((kind, center, params,
                           PRIMITIVE_LABELS[kind] if label is None else label))
        return self

    def add_sphere(self, center, radius, label=None):
        return self._add(SPHERE, center, (radius, 0, 0), label)

    def add_cube(self, center, size, label=None):
        return self._add(CUBE, center, tuple(s / 2 for s in size), label)

    def add_plane(self, point, normal, label=None):
        n = np.asarray(normal, np.float64)
        return self._add(PLANE, point, tuple(n / np.linalg.norm(n)), label)

    def add_cylinder(self, center, radius, height, label=None):
        return self._add(CYLINDER, center, (radius, height / 2, 0), label)

    def build(self, device="cpu") -> World:
        col = lambda i, dt: torch.tensor(  # noqa: E731
            np.array([o[i] for o in self._objs]), dtype=dt, device=device)
        return World(kind=col(0, torch.int32), center=col(1, torch.float32),
                     params=col(2, torch.float32), label=col(3, torch.int32))


def default_eval_world(device="cpu") -> World:
    """The reference eval scene: sphere + walls + cube + ground."""
    b = WorldBuilder()
    b.add_sphere((0.0, 0.0, 2.0), 2.0)
    b.add_plane((-4.0, 0.0, 2.0), (1.0, 0.0, 0.0))
    b.add_plane((4.0, 0.0, 2.0), (-1.0, 0.0, 0.0))
    b.add_plane((0.0, -4.0, 2.0), (0.0, 1.0, 0.0))
    b.add_plane((0.0, 4.0, 2.0), (0.0, -1.0, 0.0))
    b.add_cube((-2.0, -2.0, 1.0), (1.0, 1.0, 2.0))
    b.add_plane((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    return b.build(device)


def object_sdf(world: World, points: torch.Tensor) -> torch.Tensor:
    """(..., 3) points -> (..., O) per-object signed distances."""
    p = points[..., None, :] - world.center
    r = world.params[..., 0]
    sphere = torch.linalg.vector_norm(p, dim=-1) - r
    q = p.abs() - world.params
    cube = (torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
            + torch.clamp(q.amax(dim=-1), max=0.0))
    plane = (p * world.params).sum(dim=-1)
    rho = torch.linalg.vector_norm(p[..., :2], dim=-1)
    d2 = torch.stack([rho - r, p[..., 2].abs() - world.params[..., 1]], dim=-1)
    cyl = (torch.linalg.vector_norm(torch.clamp(d2, min=0.0), dim=-1)
           + torch.clamp(d2.amax(dim=-1), max=0.0))
    out = torch.full_like(sphere, float("inf"))
    for kind, val in ((CYLINDER, cyl), (PLANE, plane), (CUBE, cube),
                      (SPHERE, sphere)):
        out = torch.where(world.kind == kind, val, out)
    return out


def world_sdf(world: World, points: torch.Tensor):
    """(..., 3) -> (sdf (...,), label (...,)): min over objects and the
    nearest object's label."""
    d = object_sdf(world, points)
    dmin, amin = d.min(dim=-1)
    return dmin, world.label[amin]


def generate_semantic_sdf(world: World, cfg, lower, upper,
                          gt_weight: float = 1.0, device="cuda"):
    """A VoxelGrid of ground-truth distance and labels over an AABB
    (generateSemanticSdfFromWorld): every block between `lower` and `upper`
    (world metres, both included) is allocated, and each of its voxels gets
    the world SDF at its center, clamped to the truncation band, weight
    `gt_weight`, and the nearest object's label as one strong vote
    (sem_delta 100, sem_count 1). Raises when the blocks exceed the
    capacity."""
    import torch.nn.functional as F

    from ..device import resolve
    from ..grid import blocks as gblocks
    dev = resolve(device)
    g = cfg.grid
    vps = g.voxels_per_side
    lo_blk = np.floor(np.asarray(lower) / g.block_size).astype(np.int32)
    hi_blk = np.floor(np.asarray(upper) / g.block_size).astype(np.int32)
    axes = [np.arange(lo_blk[d], hi_blk[d] + 1) for d in range(3)]
    coords = np.stack(np.meshgrid(*axes, indexing="ij"),
                      axis=-1).reshape(-1, 3)
    if len(coords) > g.block_capacity:
        raise ValueError(f"world AABB needs {len(coords)} blocks > capacity "
                         f"{g.block_capacity}")
    grid = gblocks.create(cfg, device=dev)
    coords_t = torch.as_tensor(coords, dtype=torch.int32, device=dev)
    grid = gblocks.allocate_blocks(
        grid, coords_t, torch.ones(len(coords), dtype=torch.bool,
                                   device=dev), g)
    slots = gblocks.lookup_slots(grid, coords_t, g).long()
    ii = np.arange(vps)
    local = torch.as_tensor(np.stack(np.meshgrid(ii, ii, ii, indexing="ij"),
                                     axis=-1).reshape(-1, 3),
                            dtype=torch.int32, device=dev)
    centers = ((coords_t[:, None, :] * vps + local[None]).to(torch.float32)
               + 0.5) * g.voxel_size
    sdf, label = world_sdf(world.to(dev), centers)          # (Nb, V3)
    trunc = cfg.tsdf.truncation_distance
    grid.wsum[slots] = gt_weight
    grid.wsdf[slots] = torch.clamp(sdf, -trunc, trunc) * gt_weight
    onehot = F.one_hot(label.long(), g.num_labels).to(torch.float32)
    grid.sem_delta[:, slots] = onehot.permute(2, 0, 1) * 100.0
    grid.sem_count[slots] = 1.0
    grid.updated[slots] = True
    return grid
