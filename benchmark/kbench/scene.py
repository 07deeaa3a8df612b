"""The benchmark's synthetic camera: analytic scenes, an orbit, a renderer.

A frozen copy of the port's `sim/world.py` and `sim/render.py` (sphere
tracing of primitive signed-distance functions) and of the 14 m room that
`chip_smoke.py far_world` builds, so that a later change to the port's
simulator does not move the benchmark's inputs. The seed draws only the
sensor noise: depth noise that grows with the square of the depth, and
label flips to a partner label. The scene, the orbit and the frame count
are the configuration's and the traffic's, the same for every seed.

Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPHERE, CUBE, PLANE, CYLINDER = 0, 1, 2, 3
PRIMITIVE_LABELS = {SPHERE: 1, CUBE: 2, PLANE: 3, CYLINDER: 4}
MAX_MARCH_STEPS = 96
HIT_EPS = 1e-3
EXIT_CHECK_EVERY = 8


def _objects(world: str):
    """(kind, centre, params, label) of each object of a named scene."""
    objs = []

    def plane(point, normal):
        n = np.asarray(normal, np.float64)
        objs.append((PLANE, point, tuple(n / np.linalg.norm(n)),
                     PRIMITIVE_LABELS[PLANE]))

    def sphere(c, r):
        objs.append((SPHERE, c, (r, 0, 0), PRIMITIVE_LABELS[SPHERE]))

    def cube(c, size):
        objs.append((CUBE, c, tuple(s / 2 for s in size),
                     PRIMITIVE_LABELS[CUBE]))

    if world == "eval":
        # The reference eval scene: sphere, four walls, a cube, the ground.
        sphere((0.0, 0.0, 2.0), 2.0)
        plane((-4.0, 0.0, 2.0), (1.0, 0.0, 0.0))
        plane((4.0, 0.0, 2.0), (-1.0, 0.0, 0.0))
        plane((0.0, -4.0, 2.0), (0.0, 1.0, 0.0))
        plane((0.0, 4.0, 2.0), (0.0, -1.0, 0.0))
        cube((-2.0, -2.0, 1.0), (1.0, 1.0, 2.0))
        plane((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    elif world == "room14":
        # The eval scene's sphere, cube and ground in a 14 m room.
        sphere((0.0, 0.0, 1.5), 1.5)
        for c, n in (((-7.0, 0.0, 2.0), (1.0, 0.0, 0.0)),
                     ((7.0, 0.0, 2.0), (-1.0, 0.0, 0.0)),
                     ((0.0, -7.0, 2.0), (0.0, 1.0, 0.0)),
                     ((0.0, 7.0, 2.0), (0.0, -1.0, 0.0))):
            plane(c, n)
        cube((-3.0, -3.0, 1.0), (1.0, 1.0, 2.0))
        plane((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    else:
        raise ValueError(f"unknown scene {world!r}")
    return objs


class World:
    """A scene as tensors on one device."""

    def __init__(self, name: str, device):
        objs = _objects(name)
        col = lambda i, dt: torch.tensor(  # noqa: E731
            np.array([o[i] for o in objs]), dtype=dt, device=device)
        self.kind = col(0, torch.int32)
        self.center = col(1, torch.float32)
        self.params = col(2, torch.float32)
        self.label = col(3, torch.int32)

    def sdf(self, points: torch.Tensor):
        """(..., 3) points -> (distance, label of the nearest object)."""
        p = points[..., None, :] - self.center
        r = self.params[..., 0]
        sphere = torch.linalg.vector_norm(p, dim=-1) - r
        q = p.abs() - self.params
        cube = (torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
                + torch.clamp(q.amax(dim=-1), max=0.0))
        plane = (p * self.params).sum(dim=-1)
        rho = torch.linalg.vector_norm(p[..., :2], dim=-1)
        d2 = torch.stack([rho - r, p[..., 2].abs() - self.params[..., 1]],
                         dim=-1)
        cyl = (torch.linalg.vector_norm(torch.clamp(d2, min=0.0), dim=-1)
               + torch.clamp(d2.amax(dim=-1), max=0.0))
        out = torch.full_like(sphere, float("inf"))
        for kind, val in ((CYLINDER, cyl), (PLANE, plane), (CUBE, cube),
                          (SPHERE, sphere)):
            out = torch.where(self.kind == kind, val, out)
        dmin, amin = out.min(dim=-1)
        return dmin, self.label[amin]


def orbit_pose(angle: float, radius: float, height: float,
               target) -> np.ndarray:
    """A camera on a circle looking at `target`, (4, 4) float32."""
    eye = np.array([radius * np.cos(angle), radius * np.sin(angle), height])
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T


def render(world: World, T_G_C: torch.Tensor, cam: dict,
           max_depth: float = 20.0):
    """Sphere-trace (depth (H, W) float32, 0 where nothing is hit; labels
    (H, W) int32) from pose T_G_C, on its device."""
    dev = T_G_C.device
    h, w = cam["height"], cam["width"]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    dc = [((u - cam["cx"]) / cam["fx"]).expand(h, w),
          ((v - cam["cy"]) / cam["fy"]).expand(h, w),
          torch.ones((h, w), dtype=torch.float32, device=dev)]
    R = T_G_C[:3, :3]
    dirs = torch.stack([dc[0] * R[i, 0] + dc[1] * R[i, 1] + dc[2] * R[i, 2]
                        for i in range(3)], dim=-1)
    origin = T_G_C[:3, 3]
    norm = torch.linalg.vector_norm(dirs, dim=-1)
    t = torch.full((h, w), 1e-3, dtype=torch.float32, device=dev)
    hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for it in range(MAX_MARCH_STEPS):
        if it % EXIT_CHECK_EVERY == 0 and not bool((~hit & (t < max_depth))
                                                    .any()):
            break
        d, _ = world.sdf(origin + dirs * t[..., None])
        hit = hit | (d < HIT_EPS)
        t = torch.where(hit, t, t + d / norm)
    _, labels = world.sdf(origin + dirs * t[..., None])
    ok = hit & (t < max_depth)
    return torch.where(ok, t, 0.0), torch.where(ok, labels, 0)


def label_colors(num_labels: int, seed: int) -> np.ndarray:
    """(num_labels, 3) uint8: a random colour per label, label 0 white (the
    unknown label), every colour distinct."""
    rng = np.random.RandomState(seed)
    while True:
        cols = rng.randint(0, 255, size=(num_labels, 3)).astype(np.uint8)
        cols[0] = 255
        if len({tuple(c) for c in cols}) == num_labels:
            return cols


def trajectory(scene: dict, n_frames: int):
    """The closed orbit's n_frames poses, (4, 4) float32 each."""
    return [orbit_pose(2.0 * math.pi * i / n_frames, scene["orbit_radius"],
                       scene["orbit_height"], scene["orbit_target"])
            for i in range(n_frames)]


def frames(conf: dict, traffic: dict, seed: int, device):
    """The traffic's F frames of the configuration's scene with sensor
    noise drawn from `seed` (depth noise of sigma a + b z^2; a share of
    the labels flipped to their partner label), as host arrays as a camera
    delivers them, one dict a frame (depth (H, W) float32 metres, labels
    (H, W) int32, colors (H, W, 3) uint8, T_G_C (4, 4) float32)."""
    cam, scene = conf["camera"], conf["scene"]
    L = conf["fusion"]["num_labels"]
    noise = traffic["noise"]
    world = World(scene["world"], device)
    table = torch.as_tensor(label_colors(L, conf["label_colors_seed"]),
                            device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = []
    for T in trajectory(scene, traffic["frames"]):
        Tt = torch.as_tensor(T, device=device)
        depth, labels = render(world, Tt, cam)
        shape = depth.shape
        z = torch.randn(shape, generator=gen, device=device)
        sigma = (noise["depth_sigma_m"]
                 + noise["depth_sigma_per_m2"] * depth ** 2)
        depth = torch.where(depth > 0, torch.clamp(depth + sigma * z,
                                                   min=1e-3), 0.0)
        # A flipped label becomes its confusion partner, as a segmenter
        # confuses a class with a similar one.
        flip = torch.rand(shape, generator=gen, device=device) < noise[
            "label_flip"]
        other = (labels - 1 + noise["label_partner_offset"]) % (L - 1) + 1
        labels = torch.where(flip & (labels > 0), other,
                             labels).to(torch.int32)
        out.append({"depth": depth.float().cpu().numpy(),
                    "labels": labels.cpu().numpy(),
                    "colors": table[labels.long()].cpu().numpy(),
                    "T_G_C": T})
    return out
