"""The benchmark's inputs, made from ``--seed``: the scene (on the device,
with a ``torch.Generator`` there, in a few large draws), the poses, the
intrinsics and the training targets (rendered by the plain reference from
a second seeded scene and quantized to 8 bits).

The scene follows the port's seeded Truck-like scene (``chip_smoke.py``
``truck_scene_surround``): 60% of the points in a box in front of the
camera, the rest on a shell behind and beside it; random rotations, log
scales in [-4.5, -2.0] shrunk by sqrt(n / 428,687) for larger scenes,
opacity logits in [-2, 3], SH coefficients N(0, 0.3^2).

Every seed gets the same set of poses, in its own order, so the work of a
run does not depend on the seed beyond the scene's random draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

REFERENCE_POINTS = 428_687


def sub_seeds(seed: int, count: int) -> list:
    """``count`` independent 63-bit seeds drawn from ``seed`` (any
    non-negative integer)."""
    state = np.random.SeedSequence(int(seed)).generate_state(count,
                                                            np.uint64)
    return [int(s) >> 1 for s in state]


def truck_scene(n: int, seed: int, device, visible_frac: float = 0.6):
    """(xyz (n, 3), features (n, 56)) float32 on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand((n, 8), generator=g, device=device)
    z = torch.randn((n, 52), generator=g, device=device)
    perm = torch.randperm(n, generator=g, device=device)
    n_vis = int(n * visible_frac)
    vis = torch.stack([u[:, 0] * 16.0 - 8.0, u[:, 1] * 8.0 - 4.0,
                       u[:, 2] * 29.0 + 1.0], -1)
    theta = (0.6 + 0.8 * u[:, 0]) * math.pi
    rad = 5.0 + 25.0 * u[:, 2]
    shell = torch.stack([rad * torch.sin(theta), u[:, 1] * 8.0 - 4.0,
                         rad * torch.cos(theta)], -1)
    rows = torch.arange(n, device=device)[:, None]
    xyz = torch.where(rows < n_vis, vis, shell)[perm].contiguous()
    q = z[:, 0:4]
    shift = -0.5 * math.log(max(n / REFERENCE_POINTS, 1.0))
    feats = torch.cat([
        q / torch.linalg.vector_norm(q, dim=1, keepdim=True),
        u[:, 3:6] * 2.5 - 4.5 + shift,
        u[:, 6:7] * 5.0 - 2.0,
        z[:, 4:52] * 0.3,
    ], 1).contiguous()
    return xyz, feats


def pose_set(count: int) -> np.ndarray:
    """``count`` camera -> world poses (count, 4, 4) spread over the span
    of the port's ``chip_smoke.py::poses(9)``: a turn about y of up to
    0.16 rad either way, shifts of up to 0.4 m sideways, 0.16 m up and
    0.8 m forward."""
    out = []
    for i in range(count):
        f = 8.0 * i / max(count - 1, 1)
        s = 1.0 if i % 2 == 0 else -1.0
        a = 0.02 * f * s
        p = np.eye(4, dtype=np.float64)
        p[:3, :3] = [[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                     [-math.sin(a), 0.0, math.cos(a)]]
        p[:3, 3] = [0.05 * f * s, 0.02 * f, 0.1 * f]
        out.append(p)
    return np.stack(out).astype(np.float32)


def poses(count: int, seed: int) -> np.ndarray:
    """``pose_set(count)`` in the order the seed draws."""
    order = np.random.default_rng(sub_seeds(seed, 1)[0]).permutation(count)
    return pose_set(count)[order]


def quaternion_xyzw(R: np.ndarray) -> np.ndarray:
    """The unit quaternion (x, y, z, w) of a rotation about y (the only
    rotations ``pose_set`` makes)."""
    a = math.atan2(float(R[0, 2]), float(R[0, 0]))
    return np.asarray([0.0, math.sin(a / 2), 0.0, math.cos(a / 2)],
                      np.float32)


def intrinsics(width: int, height: int, focal: float) -> np.ndarray:
    return np.asarray([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0],
                       [0.0, 0.0, 1.0]], np.float32)
