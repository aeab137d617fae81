"""The work a frame or a train step needs, counted from shapes and from the
(pixel, key) pairs of the cell's own inputs: bytes and float32 operations,
lower bounds, frozen here so that a later change to the program cannot
change the yardstick.

Rules: every input byte is read once and every output byte written once;
a pixel counts the keys up to and including the one that stops it; the
sort counts as no operation. The kernel counts K1-K5 are the reckoning the
port's ``chip_smoke.py`` applies to its full-width frame; the attribute,
loss and Adam counts are the operations of the plain formulas, each
commented with the code it counts.
"""
from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM at 700 W (data sheet): HBM bytes/s, float32 operations/s
# outside the tensor cores, and NVLink 4 bytes/s a card in each direction
# (900 GB/s both ways)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
NVLINK_BYTES_PER_S = 450e9
# rows of the blend backward's per-key table that the segment sum reads
SEGMENT_ROWS = 12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time of a piece of work on the card: the larger of its
    bytes over the HBM rate and its operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


# --- the kernels (K1-K5) ---------------------------------------------------

def expand_keys(n: int, total: int) -> tuple:
    """K1 (``ops/expand.py``): reads offsets, depth key, base tile and
    height (4 x 4 B) and 10 attribute rows of every point; writes the fused
    key and 16 table rows of every key. Per key a binary search over the
    points (2 operations a step) and the tile cull (~45)."""
    return (4 * 4 * n + 10 * 4 * n + 17 * 4 * total,
            total * (2 * math.ceil(math.log2(max(n, 2))) + 45))


def tile_ranges(total: int, num_tiles: int) -> tuple:
    """K2 (``ops/histogram.py``): reads every sorted key, writes the
    num_tiles + 1 bounds; one comparison a key."""
    return 4 * total + 4 * (num_tiles + 1), total


def blend_forward(live: int, num_tiles: int, px: int, pairs: int,
                  included: int) -> tuple:
    """K3 (``csrc/blend.cu``): reads 9 table rows of every live key and the
    tile ranges, writes 8 floats a pixel; 16 operations a walked pair
    (quadratic, exp, test) and 11 more a blended one."""
    return (9 * 4 * live + 8 * num_tiles + 8 * 4 * px,
            16 * pairs + 11 * included)


def blend_backward(live: int, num_tiles: int, px: int, pairs: int,
                   included: int) -> tuple:
    """K4 (``csrc/blend_backward.cu``): reads 9 table rows of every live
    key, the ranges, the rgb cotangent and the forward's rgb (3 floats a
    pixel each); writes 11 rows of every live key and 2 floats a pixel.
    16 operations a walked pair, 45 more a blended one."""
    return (9 * 4 * live + 8 * num_tiles + 6 * 4 * px + 11 * 4 * live
            + 2 * 4 * px, 16 * pairs + 45 * included)


def segment_reduce(n: int, total: int, rows: int = SEGMENT_ROWS) -> tuple:
    """K5 (``csrc/segment_reduce.cu``): reads every row lane and the
    inverse permutation once, and the offsets and counts; writes one float
    a (row, point); one add a row lane."""
    return (4 * rows * total + 4 * total + 8 * n + 4 * rows * n,
            rows * total)


# --- the plain-torch stages ------------------------------------------------

# operations a point of ``ops/attributes.py::compute_point_attributes``
# (forward): the quaternion normalize (12: ``attributes.py``), the
# projection (33: ``projection.py::project_point``), the EWA covariance
# (105: ``project_cov2d_components``), conic, rescale and radius (37:
# ``conic_rescale_radius_components``), opacity (4), the per-axis radius
# (15), the SH basis (40: ``sh.py``), its band mask (16), the SH sums of
# three channels (93) and their sigmoids (12)
ATTRIBUTE_OPS = 12 + 33 + 105 + 37 + 4 + 15 + 40 + 16 + 93 + 12
# bytes a point: reads xyz (3) and features (56), writes uv (2), depth (1),
# conic (4), opacity (1), colour (3) and the radius (2), all f32
ATTRIBUTE_BYTES = 4 * (3 + 56 + 2 + 1 + 4 + 1 + 3 + 2)


def attributes(n: int, backward: bool = False) -> tuple:
    """The attribute stage over n points; ``backward``: its VJP, counted
    as the forward's operations (a VJP takes at least as many) and bytes
    (reads the 11 cotangent columns and writes the 59 of xyz and the
    features)."""
    if backward:
        return 4 * (11 + 59) * n, ATTRIBUTE_OPS * n
    return ATTRIBUTE_BYTES * n, ATTRIBUTE_OPS * n


# SSIM (``training/loss.py::ssim``): five separable 11-tap blurs of the
# valid region (2 x (11 multiplies + 10 adds) a blur an element), three
# image products, and ~12 operations of the SSIM map; the L1 takes 3
SSIM_OPS = 5 * 2 * 21 + 3 + 12
L1_OPS = 3


def loss(height: int, width: int, backward: bool = False) -> tuple:
    """L1 + SSIM of an (H, W, 3) prediction against its target: reads both
    images, writes the cotangent when ``backward``; the VJP counted as the
    forward's operations."""
    px = height * width * 3
    valid = max(height - 10, 0) * max(width - 10, 0) * 3
    ops = L1_OPS * px + SSIM_OPS * valid
    return (4 * 3 * px if backward else 4 * 2 * px), ops


# ``training/trainer.py::Adam.update`` an element: mu (3), nu (4), the two
# bias corrections (2 divisions), sqrt, + eps, the division, the learning
# rate and the add (4)
ADAM_OPS = 3 + 4 + 2 + 1 + 1 + 1 + 2


def adam(elements: int) -> tuple:
    """One Adam update: reads the gradient, mu, nu and the parameter,
    writes mu, nu and the parameter."""
    return 4 * 7 * elements, ADAM_OPS * elements


# --- frames and steps --------------------------------------------------------

def frame_parts(n: int, height: int, width: int, tile: int,
                counts: dict) -> dict:
    """{part: (bytes, operations)} of one rendered frame: attributes,
    K1-K3. ``counts``: the frame's ``keys`` (total), ``live``, ``pairs``
    and ``included`` (``block_pairs``)."""
    px = height * width
    tiles = (height // tile) * (width // tile)
    total = counts["keys"]
    return {
        "attributes": attributes(n),
        "expand_keys": expand_keys(n, total),
        "tile_ranges": tile_ranges(total, tiles),
        "blend_forward": blend_forward(counts["live"], tiles, px,
                                       counts["pairs"], counts["included"]),
    }


def step_parts(n: int, height: int, width: int, tile: int,
               counts: dict) -> dict:
    """{part: (bytes, operations)} of one train step: the frame, the loss
    and its VJP, K4, K5, the attribute VJP and the two Adams (features
    and positions)."""
    px = height * width
    tiles = (height // tile) * (width // tile)
    parts = frame_parts(n, height, width, tile, counts)
    lf, lb = loss(height, width), loss(height, width, backward=True)
    parts.update({
        "loss": (lf[0] + lb[0], lf[1] + lb[1]),
        "blend_backward": blend_backward(counts["live"], tiles, px,
                                         counts["pairs"],
                                         counts["included"]),
        "segment_reduce": segment_reduce(n, counts["keys"]),
        "attributes_vjp": attributes(n, backward=True),
        "adam": adam(n * (56 + 3)),
    })
    return parts


# f32 columns a point of the data-parallel step's SUM: the gradients of
# xyz (3) and of the features (56), the controller's accumulators (8:
# ``controller.init_state``'s six arrays) and the visibility statistics
# (6: visibility, affected pixels, gradient magnitude, overlap tiles and
# the 2-D position gradient); then 4 scalars (loss, L1, SSIM, PSNR)
DP_SUM_COLUMNS = 3 + 56 + 8 + 6
DP_SUM_SCALARS = 4


def dp_collective_bytes(n: int) -> int:
    """Bytes a data-parallel step reduces over the ranks
    (``parallel/data_parallel.py``): the packed f32 SUM and the f64 MAX of
    the nearest depth of every point and the key total. Over the NVLink
    rate of a card this is a least time under any all-reduce algorithm: a
    ring sends 2(n-1)/n of the buffer from each card, an in-switch
    reduction the whole buffer."""
    return 4 * (DP_SUM_COLUMNS * n + DP_SUM_SCALARS) + 8 * (n + 1)


def total_ops(parts: dict) -> float:
    return float(sum(ops for _, ops in parts.values()))


# --- the (pixel, key) pairs -------------------------------------------------

def block_pairs(hit: torch.Tensor, p_incl: torch.Tensor,
                n_keys: torch.Tensor) -> dict:
    """Work of a block of tiles, vectorised. ``hit`` (B, pixels, L): the
    key's alpha reaches 1/255 at the pixel; ``p_incl`` (B, pixels, L): the
    transmittance after the key (1 - alpha clamped, multiplied front to
    back); ``n_keys`` (B,): the tile's keys (columns past it are padding).

    Returns ``pairs`` (each pixel's keys up to and including the one that
    stops it, all of its tile's keys if none does), ``included`` (pairs
    blended) and ``live`` (keys blended into at least one pixel)."""
    stop = hit & (p_incl < 1e-4)
    include = hit & ~(p_incl < 1e-4)
    stopped = stop.any(2)
    first = stop.to(torch.uint8).argmax(2) + 1
    walked = torch.where(stopped, first,
                         n_keys[:, None].expand_as(first))
    return {"pairs": int(walked.sum()), "included": int(include.sum()),
            "live": int(include.any(1).sum())}
