"""The inputs of the unbounded 360-degree cells, made from ``--seed``: a
scene laid out as a Mip-NeRF 360 outdoor capture is (a dense central
object, a ground disk, a far background shell) and level cameras on an
inward orbit around the object.

World axes are the cameras' (x right, y down, z forward at the first
orbit angle): the object's centre is the origin and the cameras' height,
the ground lies ``GROUND_Y`` below it. Shares and scales (``assumed`` in
``configs/m360-bicycle-6100k.json`` gives the same numbers):

- object, ``OBJECT_SHARE`` of the points: uniform in an ellipsoid of
  semi-axes ``OBJECT_AXES`` (1.5 m across, 1 m tall, resting on the
  ground); log scales in ``OBJECT_LOG_SCALE`` (1.5-6.7 mm);
- ground, ``GROUND_SHARE``: a disk of radius ``GROUND_RADIUS`` (6 m
  across) at ``GROUND_Y``, 2 cm thick; log scales in ``GROUND_LOG_SCALE``
  (4-18 mm);
- background, the rest: directions of azimuth uniform over the circle and
  elevation uniform in ``SHELL_ELEVATION`` rad, distances log-uniform in
  ``SHELL_RANGE`` m; log scales log(distance) + ``SHELL_LOG_SCALE`` (0.4-
  1.8% of the distance).

Every point: a random rotation, an opacity logit in [-2, 3], SH
coefficients N(0, 0.3^2), as ``inputs.truck_scene`` draws them. The rows
are shuffled, so no slot range of the pool is one part of the scene.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import inputs

OBJECT_SHARE = 0.35
GROUND_SHARE = 0.45
OBJECT_AXES = (0.75, 0.5, 0.75)
OBJECT_LOG_SCALE = (-6.5, -5.0)
GROUND_Y = 0.5
GROUND_RADIUS = 3.0
GROUND_THICKNESS = 0.02
GROUND_LOG_SCALE = (-5.5, -4.0)
SHELL_ELEVATION = (-0.2, 0.6)
SHELL_RANGE = (20.0, 200.0)
SHELL_LOG_SCALE = (-5.5, -4.0)
ORBIT_RADIUS = 4.0


def _span(u: torch.Tensor, lo_hi: tuple) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * u


def scene(n: int, seed: int, device):
    """(xyz (n, 3), features (n, 56)) float32 on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    # 9 uniforms a point, of which 7 are read: the draw's shape is part
    # of what the seed makes, and the limits were set on it
    u = torch.rand((n, 9), generator=g, device=device)
    z = torch.randn((n, 55), generator=g, device=device)
    perm = torch.randperm(n, generator=g, device=device)
    n_obj = int(n * OBJECT_SHARE)
    n_ground = int(n * GROUND_SHARE)
    # object: a direction, a radius by the cube root (uniform in volume)
    d = z[:, 52:55] / torch.clamp_min(
        torch.linalg.vector_norm(z[:, 52:55], dim=1, keepdim=True), 1e-12)
    obj = d * torch.pow(u[:, 0:1], 1.0 / 3.0) * torch.tensor(
        OBJECT_AXES, device=device)
    # ground: uniform in the disk
    r = GROUND_RADIUS * torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    ground = torch.stack([r * torch.sin(phi),
                          GROUND_Y + GROUND_THICKNESS * (u[:, 2] - 0.5),
                          r * torch.cos(phi)], -1)
    # background shell (y down: a positive elevation is above the horizon)
    dist = SHELL_RANGE[0] * torch.pow(SHELL_RANGE[1] / SHELL_RANGE[0],
                                      u[:, 2])
    el = _span(u[:, 0], SHELL_ELEVATION)
    shell = torch.stack([dist * torch.cos(el) * torch.sin(phi),
                         -dist * torch.sin(el),
                         dist * torch.cos(el) * torch.cos(phi)], -1)
    rows = torch.arange(n, device=device)[:, None]
    part_obj, part_ground = rows < n_obj, rows < n_obj + n_ground
    xyz = torch.where(part_obj, obj, torch.where(part_ground, ground, shell))
    log_scale = torch.where(
        part_obj, _span(u[:, 3:6], OBJECT_LOG_SCALE),
        torch.where(part_ground, _span(u[:, 3:6], GROUND_LOG_SCALE),
                    torch.log(dist)[:, None]
                    + _span(u[:, 3:6], SHELL_LOG_SCALE)))
    q = z[:, 0:4]
    feats = torch.cat([
        q / torch.linalg.vector_norm(q, dim=1, keepdim=True),
        log_scale,
        u[:, 6:7] * 5.0 - 2.0,
        z[:, 4:52] * 0.3,
    ], 1)
    return xyz[perm].contiguous(), feats[perm].contiguous()


def pose_set(count: int) -> np.ndarray:
    """``count`` camera -> world poses (count, 4, 4): level cameras at the
    object's height, evenly spaced on a circle of radius ``ORBIT_RADIUS``
    around it, each looking at its centre (a rotation about y alone, which
    ``inputs.quaternion_xyzw`` takes)."""
    out = []
    for i in range(count):
        a = 2.0 * math.pi * i / count
        p = np.eye(4, dtype=np.float64)
        p[:3, :3] = [[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                     [-math.sin(a), 0.0, math.cos(a)]]
        p[:3, 3] = [-ORBIT_RADIUS * math.sin(a), 0.0,
                    -ORBIT_RADIUS * math.cos(a)]
        out.append(p)
    return np.stack(out).astype(np.float32)


def poses(count: int, seed: int) -> np.ndarray:
    """``pose_set(count)`` in the order the seed draws."""
    order = np.random.default_rng(
        inputs.sub_seeds(seed, 1)[0]).permutation(count)
    return pose_set(count)[order]
