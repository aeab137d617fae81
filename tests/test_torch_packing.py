"""The port's bf16 rounding and pair packing (``ops/packing.py``) against
the JAX package's, bit for bit, and ``pack_sort_colors`` rendering.

Edge values: quiet and signalling NaNs of both signs, +-inf, +-0, the
largest finite f32 (it rounds to inf), subnormals, ties that round to even
both ways, and 100,000 seeded bit patterns. The render gates are the
image gates (rgb atol 1e-4) against JAX's packed render, and its blend
table: r and g equal ``round_bf16`` of the unpacked render's rows exactly,
every other row unchanged.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import packing as jp  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import packing as tp  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.test_torch_rasterizer import JCFG, TCFG, _inputs  # noqa: E402

EDGES = np.asarray([
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFC00001, 0x7FBFFFFF, 0xFFFFFFFF,
    0x7F800000, 0xFF800000, 0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF,
    0x7F7F7FFF, 0x7F7F8000, 0x00000001, 0x80000001, 0x00008000, 0x00018000,
    0x0000FFFF, 0x007FFFFF, 0x00800000, 0x80008000, 0x80018000, 0x3F808000,
    0x3F818000, 0x3F808001, 0x3F80FFFF, 0xBF818000], np.uint32)


def _values():
    rnd = np.random.default_rng(0).integers(0, 2 ** 32, 100_000,
                                            dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGES, rnd]).view(np.float32)


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("fn", ["round_bf16", "pack_bf16_pair_rne",
                                "pack_bf16_pair_trunc", "unpack_bf16_pair"])
def test_bit_for_bit_against_jax(fn):
    v = _values()
    w = np.roll(v, 11)
    nargs = 2 if fn.startswith("pack") else 1
    targs = [torch.from_numpy(a) for a in (v, w)[:nargs]]
    jargs = [jnp.asarray(a) for a in (v, w)[:nargs]]
    got, want = getattr(tp, fn)(*targs), getattr(jp, fn)(*jargs)
    if fn == "unpack_bf16_pair":
        for g, x in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(x))
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_pack_unpack_round_trip():
    v = _values()
    w = np.roll(v, 5)
    a, b = tp.unpack_bf16_pair(tp.pack_bf16_pair_rne(torch.from_numpy(v),
                                                     torch.from_numpy(w)))
    for got, src in ((a, v), (b, w)):
        np.testing.assert_array_equal(
            _bits(got.numpy()), _bits(tp.round_bf16(torch.from_numpy(src))))
    # the rounding keeps its sign and leaves bf16 values alone
    r = tp.round_bf16(torch.from_numpy(v))
    np.testing.assert_array_equal(_bits(tp.round_bf16(r).numpy()),
                                  _bits(r.numpy()))
    assert (_bits(r.numpy()) & 0xFFFF).max() == 0


def test_packed_render_matches_jax():
    j, jcam, t, tcam = _inputs()
    jcfg = dataclasses.replace(JCFG, rgb_only=True, pack_sort_colors=True)
    tcfg = dataclasses.replace(TCFG, rgb_only=True, pack_sort_colors=True)
    want = np.asarray(jr.rasterize(*j, jcam, jcfg).rgb)
    got = tr.rasterize(*t, tcam, tcfg).rgb.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    plain = tr.rasterize(*t, tcam, dataclasses.replace(
        tcfg, pack_sort_colors=False)).rgb.numpy()
    assert 0 < np.abs(got - plain).max() <= 2.0 ** -8


def test_packed_table_rounds_r_and_g_only():
    _, _, t, tcam = _inputs()
    xyz, feats, invalid, q, tt = t
    raw, radius = tr.compute_raw_attrs(xyz, feats, q, tt, tcam)
    cfg = dataclasses.replace(TCFG, rgb_only=True)
    _, table, _ = tr.build_keys(raw, radius, invalid, tcam, cfg)
    _, packed, _ = tr.build_keys(raw, radius, invalid, tcam,
                                 dataclasses.replace(cfg,
                                                     pack_sort_colors=True))
    for row in range(16):
        want = tp.round_bf16(table[row]) if row in (6, 7) else table[row]
        np.testing.assert_array_equal(_bits(packed[row].numpy()),
                                      _bits(want.numpy()))
    assert not torch.equal(packed[6], table[6])
    # without rgb_only the option is ignored, as in the JAX package
    full = dataclasses.replace(TCFG, pack_sort_colors=True)
    assert torch.equal(tr.build_keys(raw, radius, invalid, tcam, full)[1],
                       tr.build_keys(raw, radius, invalid, tcam, TCFG)[1])
