"""The port's rasterizer and its dense oracle against the JAX package's
dense oracle ``render_reference``, at the JAX package's image gates: rgb
and alpha atol 1e-4, depth atol 5e-4, count exact."""
import dataclasses

import pytest

jax = pytest.importorskip("jax")

from taichi_3d_gaussian_splatting_tpu.ops import blend_reference as jref  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import blend_reference as tref  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.test_torch_rasterizer import (  # noqa: E402
    JCFG, TCFG, _assert_images_close, _inputs,
)


def test_rasterize_matches_jax_reference():
    j, jcam, t, tcam = _inputs(seed=21)
    want = jref.render_reference(*j, jcam, JCFG)
    got = tr.rasterize(*t, tcam, TCFG)
    _assert_images_close(got, want)
    assert float(got.count.max()) >= 3  # splats overlap


def test_reference_matches_jax_reference():
    j, jcam, t, tcam = _inputs(n=120, seed=5)
    cfg = dataclasses.replace(JCFG, tile_h=16)
    want = jref.render_reference(*j, jcam, cfg)
    got = tref.render_reference(*t, tcam, dataclasses.replace(TCFG, tile_h=16))
    _assert_images_close(got, want)
