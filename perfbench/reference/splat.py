"""Plain reference of the tile splat renderer: attributes, tile keys and the
front-to-back blend, in dense PyTorch over blocks of tiles.

The semantics are those the port states (its README and module docs),
written again here with no code of the port:

- a point is projected by the world->camera pose and the pinhole K; its 2D
  covariance is the EWA one, J R_cw R(q) diag(exp s)^2 R(q)^T R_cw^T J^T,
  filtered by +0.3 on the diagonal; the conic is the filtered inverse and
  the rescale sqrt(det / det_filtered);
- opacity sigmoid(feature 7); colour sigmoid(SH up to the band, along the
  camera -> point direction);
- a point is visible when near < z < far and its centre lies within 3 tiles
  of the image; its keys are the tiles of its bounding box (the per-axis
  radius where alpha can still reach 1/255), sorted by tile, then by the
  truncated fixed-point depth key, then by point index;
- a pixel (centre at +0.5) walks its tile's keys in order: alpha =
  exp(-q/2) * rescale * opacity; alpha < 1/255 is skipped; alpha is clamped
  at 0.99 (straight-through for gradients); blending stops for good at the
  key that would take the transmittance below 1e-4, which is excluded; the
  background is black.

Matrix products are written as products (``@``), as the plain formulas
are, so the precision switch of ``precision`` reaches them. Nothing here
imports the program; ``work.block_pairs`` counts the (pixel, key) pairs
that the blend needs.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from perfbench import work

ALPHA_SKIP = 1.0 / 255.0
ALPHA_CLAMP = 0.99
T_SATURATION = 1e-4
COV2D_FILTER = 0.3
BORDER_TILES = 3
# elements of one (tiles, pixels, keys) block tensor
BLOCK_ELEMENTS = 2 ** 25


@contextlib.contextmanager
def precision(mode: str):
    """``"f32"``: matrix products and convolutions in full float32 (TF32
    off), as the configurations state; ``"tf32"``: both in TF32, the
    control's one step below."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class View(NamedTuple):
    """A pinhole view: (4, 4) camera -> world pose, (3, 3) K, size."""

    pose: torch.Tensor
    K: torch.Tensor
    width: int
    height: int


class Attrs(NamedTuple):
    """Per-point screen-space attributes (all (N, ...) float32)."""

    uv: torch.Tensor        # (N, 2)
    depth: torch.Tensor     # (N,)
    conic: torch.Tensor     # (N, 3) filtered inverse covariance a, b, c
    ro: torch.Tensor        # (N,) rescale * opacity
    color: torch.Tensor     # (N, 3)
    radius_xy: torch.Tensor  # (N, 2) per-axis cull radius (no gradient)


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion xyzw -> (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return r.reshape(q.shape[:-1] + (3, 3))


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """(N, 3) direction -> (N, 16) real SH basis to degree 3."""
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1,
                                                     keepdim=True), 1e-12)
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], -1)


def _away_from_zero(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-6,
                       torch.where(z < 0, -1e-6, 1e-6).to(z.dtype), z)


def attributes(xyz: torch.Tensor, feats: torch.Tensor, view: View,
               sh_band: int = 3) -> Attrs:
    """Project every point of (xyz (N, 3), features (N, 56)) into ``view``.
    Differentiable in xyz and features (the radius excepted)."""
    R_wc, centre = view.pose[:3, :3], view.pose[:3, 3]
    R_cw = R_wc.T
    cam = (xyz - centre) @ R_wc       # = R_cw (x - c)
    z = _away_from_zero(cam[:, 2])
    inv_z = 1.0 / z
    uvw = cam @ view.K.T
    uv = uvw[:, 0:2] * inv_z[:, None]
    fx, fy = view.K[0, 0], view.K[1, 1]
    zero = torch.zeros_like(inv_z)
    J = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * cam[:, 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * cam[:, 1] * inv_z * inv_z], -1),
    ], 1)                                                    # (N, 2, 3)
    quat = feats[:, 0:4]
    quat = quat / torch.clamp_min(torch.linalg.vector_norm(
        quat, dim=-1, keepdim=True), 1e-12)
    RS = rotation(quat) * torch.exp(feats[:, 4:7])[:, None, :]  # R(q) S
    B = (J @ R_cw) @ RS                                       # (N, 2, 3)
    cov = B @ B.transpose(1, 2)
    a = torch.clamp(cov[:, 0, 0], -1e18, 1e18)
    b = torch.clamp(cov[:, 0, 1], -1e18, 1e18)
    c = torch.clamp(cov[:, 1, 1], -1e18, 1e18)
    det0 = a * c - b * b
    af, cf = a + COV2D_FILTER, c + COV2D_FILTER
    det = torch.clamp_min(af * cf - b * b, 1e-6)
    ratio = torch.clamp_min(det0 / det, 0.0)
    rescale = torch.where(ratio > 0.0,
                          torch.sqrt(torch.clamp_min(ratio, 1e-30)),
                          torch.zeros_like(ratio))
    conic = torch.stack([cf / det, -b / det, af / det], -1)
    opacity = torch.sigmoid(feats[:, 7])
    with torch.no_grad():
        lam = (a + c + torch.sqrt((a - c) * (a - c) + 4.0 * b * b)) / 2.0
        radius = torch.sqrt(torch.clamp_min(lam, 0.0)) * 3.0
        qm = torch.clamp_min(2.0 * torch.log(torch.clamp_min(
            255.0 * rescale * opacity, 1e-30)), 0.0)
        rx = torch.minimum(radius, torch.sqrt(qm * torch.clamp_min(af, 0.0)))
        ry = torch.minimum(radius, torch.sqrt(qm * torch.clamp_min(cf, 0.0)))
    basis = sh_basis(xyz - centre)
    keep = (torch.arange(16, device=xyz.device) < (sh_band + 1) ** 2)
    basis = basis * keep.to(basis.dtype)
    sh = feats[:, 8:56].reshape(-1, 3, 16)
    color = torch.sigmoid((sh @ basis[:, :, None])[:, :, 0])
    return Attrs(uv=uv, depth=cam[:, 2], conic=conic, ro=rescale * opacity,
                 color=color, radius_xy=torch.stack([rx, ry], -1))


class Keys(NamedTuple):
    """The sorted (tile, point) keys of a frame."""

    point: torch.Tensor       # (total,) int64 point of each sorted key
    tile: torch.Tensor        # (total,) int64 tile of each sorted key
    start: torch.Tensor       # (num_tiles,) int64 first key of each tile
    count: torch.Tensor       # (num_tiles,) int64 keys of each tile
    total: int
    tiles_x: int
    tiles_y: int


@torch.no_grad()
def tile_keys(at: Attrs, view: View, near: float, far: float,
              depth_scale: float, tile: int = 32) -> Keys:
    """Visibility, bounding boxes and the depth-sorted keys of a frame."""
    w, h = view.width, view.height
    tx, ty = w // tile, h // tile
    num_tiles = tx * ty
    dbits = min(31 - max(int(num_tiles + 1).bit_length(), 1), 23)
    u, v, d = at.uv[:, 0], at.uv[:, 1], at.depth
    pad = tile * BORDER_TILES
    visible = ((d > near) & (d < far) & (u >= -pad) & (u < w + pad)
               & (v >= -pad) & (v < h + pad))
    rx = torch.clamp_min(at.radius_xy[:, 0], 1.0)
    ry = torch.clamp_min(at.radius_xy[:, 1], 1.0)
    lo_u, hi_u = torch.clamp_min(u - rx, 0.0), u + rx
    lo_v, hi_v = torch.clamp_min(v - ry, 0.0), v + ry

    def cell(x):
        return torch.div(x, tile, rounding_mode="floor").to(torch.int64)
    min_u = torch.clamp_max(cell(lo_u), tx)
    max_u = torch.clamp_max(torch.maximum(cell(hi_u) + 1, min_u + 1), tx)
    min_v = torch.clamp_max(cell(lo_v), ty)
    max_v = torch.clamp_max(torch.maximum(cell(hi_v) + 1, min_v + 1), ty)
    empty = (hi_u <= 0.0) | (lo_u >= w) | (hi_v <= 0.0) | (lo_v >= h)
    max_u = torch.where(empty, min_u, max_u)
    max_v = torch.where(empty, min_v, max_v)
    bw = max_u - min_u
    counts = torch.where(visible, bw * (max_v - min_v),
                         torch.zeros_like(bw))
    n = counts.shape[0]
    point = torch.repeat_interleave(torch.arange(n, device=d.device), counts)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(point.shape[0], device=d.device) - first[point]
    bwp = torch.clamp_min(bw[point], 1)
    t = ((min_v[point] + torch.div(j, bwp, rounding_mode="floor")) * tx
         + min_u[point] + j % bwp)
    dkey = torch.clamp((d * depth_scale).to(torch.int32), 0,
                       (1 << dbits) - 1).to(torch.int64)
    order = torch.argsort(((t << dbits) | dkey[point]) * n + point)
    point, t = point[order], t[order]
    count = torch.bincount(t, minlength=num_tiles)
    start = torch.cumsum(count, 0) - count
    return Keys(point, t, start, count, int(point.shape[0]), tx, ty)


def _blocks(keys: Keys, tile: int):
    """Tiles in blocks of similar key counts: [(tiles (B,), keys (B, L),
    member (B, L))], with L the block's largest count."""
    npx = tile * tile
    counts = keys.count
    order = torch.argsort(counts, descending=True)
    sizes = counts[order].tolist()
    i, out = 0, []
    while i < len(sizes) and sizes[i] > 0:
        L = sizes[i]
        B = max(1, BLOCK_ELEMENTS // (npx * L))
        tiles = order[i:i + B]
        n = counts[tiles]
        tiles, n = tiles[n > 0], n[n > 0]
        col = torch.arange(L, device=counts.device)
        member = col[None, :] < n[:, None]
        idx = torch.where(member, keys.start[tiles][:, None] + col[None, :],
                          torch.zeros_like(member, dtype=torch.int64))
        out.append((tiles, keys.point[idx], member))
        i += B
    return out


def _block_state(at: Attrs, tiles, pts, member, keys: Keys, tile: int):
    """Dense (B, pixels, L) state of a block of tiles: (alpha before the
    skip, alpha after skip and clamp, the exclusive transmittance, the
    inclusive product, the hit and include masks)."""
    dev = pts.device
    i = torch.arange(tile * tile, device=dev)
    lx = (i % tile).to(torch.float32) + 0.5
    ly = torch.div(i, tile, rounding_mode="floor").to(torch.float32) + 0.5
    x0 = ((tiles % keys.tiles_x) * tile).to(torch.float32)
    y0 = (torch.div(tiles, keys.tiles_x, rounding_mode="floor")
          * tile).to(torch.float32)
    u = at.uv[:, 0][pts] - x0[:, None]          # tile-local centre (B, L)
    v = at.uv[:, 1][pts] - y0[:, None]
    ca, cb, cc = (at.conic[:, k][pts] for k in range(3))
    logro = torch.log(torch.clamp_min(at.ro[pts], 1e-37))
    dx = lx[None, :, None] - u[:, None, :]
    dy = ly[None, :, None] - v[:, None, :]
    power = (-0.5 * (ca[:, None, :] * dx * dx + cc[:, None, :] * dy * dy)
             - cb[:, None, :] * dx * dy + logro[:, None, :])
    alpha = torch.exp(power)
    hit = (alpha >= ALPHA_SKIP) & member[:, None, :]
    clamped = alpha - (alpha - torch.clamp_max(alpha, ALPHA_CLAMP)).detach()
    a = torch.where(hit, clamped, torch.zeros_like(alpha))
    p_incl = torch.cumprod(1.0 - a, dim=2)
    p_excl = torch.cat([torch.ones_like(p_incl[:, :, :1]),
                        p_incl[:, :, :-1]], 2)
    include = hit & (p_incl >= T_SATURATION)
    return a, p_excl, p_incl, hit, include


def _blend_block(at: Attrs, block, keys: Keys, tile: int):
    tiles, pts, member = block
    a, p_excl, _, _, include = _block_state(at, tiles, pts, member, keys,
                                            tile)
    w = torch.where(include, a * p_excl, torch.zeros_like(a))
    return w @ at.color[pts]                     # (B, pixels, 3)


def _tiles_image(tiles_rgb: torch.Tensor, keys: Keys, tile: int):
    """(num_tiles, pixels, 3) -> (H, W, 3)."""
    tx, ty = keys.tiles_x, keys.tiles_y
    return (tiles_rgb.reshape(ty, tx, tile, tile, 3).permute(0, 2, 1, 3, 4)
            .reshape(ty * tile, tx * tile, 3))


def blend(at: Attrs, keys: Keys, tile: int = 32,
          counts: Optional[dict] = None) -> torch.Tensor:
    """The (H, W, 3) float image of a frame, without a gradient. With
    ``counts`` (a dict) adds the frame's work: ``pairs`` the (pixel, key)
    pairs each pixel walks up to the key that stops it, ``included`` the
    blended pairs, ``live`` the keys blended into some pixel, ``keys`` the
    key total."""
    num_tiles = keys.tiles_x * keys.tiles_y
    out = torch.zeros((num_tiles, tile * tile, 3), dtype=torch.float32,
                      device=at.uv.device)
    with torch.no_grad():
        at0 = Attrs(*(x.detach() for x in at))
        for block in _blocks(keys, tile):
            tiles, pts, member = block
            a, p_excl, p_incl, hit, include = _block_state(
                at0, tiles, pts, member, keys, tile)
            w = torch.where(include, a * p_excl, torch.zeros_like(a))
            out[tiles] = w @ at0.color[pts]
            if counts is not None:
                got = work.block_pairs(hit, p_incl, member.sum(1))
                for k, val in got.items():
                    counts[k] = counts.get(k, 0) + val
    if counts is not None:
        counts["keys"] = counts.get("keys", 0) + keys.total
    return _tiles_image(out, keys, tile)


def blend_backward(at: Attrs, keys: Keys, d_image: torch.Tensor,
                   tile: int = 32) -> Attrs:
    """Cotangents of (uv, conic, ro, color) for the image cotangent
    ``d_image`` (H, W, 3), by autograd through each block of tiles in
    turn (depth and radius get none)."""
    tx, ty = keys.tiles_x, keys.tiles_y
    d_tiles = (d_image.reshape(ty, tile, tx, tile, 3).permute(0, 2, 1, 3, 4)
               .reshape(tx * ty, tile * tile, 3))
    leaves = Attrs(uv=at.uv.detach().requires_grad_(True), depth=at.depth,
                   conic=at.conic.detach().requires_grad_(True),
                   ro=at.ro.detach().requires_grad_(True),
                   color=at.color.detach().requires_grad_(True),
                   radius_xy=at.radius_xy)
    with torch.enable_grad():
        for block in _blocks(keys, tile):
            rgb = _blend_block(leaves, block, keys, tile)
            torch.autograd.backward(rgb, d_tiles[block[0]])

    def grad(x):
        return torch.zeros_like(x) if x.grad is None else x.grad
    return Attrs(uv=grad(leaves.uv), depth=None, conic=grad(leaves.conic),
                 ro=grad(leaves.ro), color=grad(leaves.color),
                 radius_xy=None)


def render(xyz, feats, view: View, near: float, far: float,
           depth_scale: float, sh_band: int = 3, tile: int = 32,
           counts: Optional[dict] = None) -> torch.Tensor:
    """The (H, W, 3) float image of (xyz, features) in ``view``, not
    clamped."""
    with torch.no_grad():
        at = attributes(xyz, feats, view, sh_band)
        keys = tile_keys(at, view, near, far, depth_scale, tile)
        return blend(at, keys, tile, counts)


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """An image as the renderer hands it out: clamped to [0, 1], scaled by
    255 and rounded."""
    return torch.round(torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8)
