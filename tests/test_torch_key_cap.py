"""The static key capacity on the CPU: ``fit_key_cap`` against the JAX
trainer's, the capped tiling stage against the JAX package's
``build_tile_keys_and_table(key_cap=...)`` (Pallas kernels in interpret
mode), and the capped train step against the JAX step at the same small
``key_cap``.

With the capacity above the key total the capped buffers hold the exact
path's keys, table and ranges, then padding; below it both packages drop
the surplus keys of the highest-index points, so every integer agrees
exactly and the gradients at the gradient gate (atol 5e-4, rtol 1e-3).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.models.scene import GaussianScene  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import tiling as jtl  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import controller as jc  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training.config import (  # noqa: E402
    TrainConfig as JTrainConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.convert import (  # noqa: E402
    train_state_from_jax,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import expand  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling as ttl  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint as ck  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (  # noqa: E402
    TrainConfig,
)
from tests.test_torch_tiling import _expand_inputs, _frame  # noqa: E402
from tests.test_torch_train_step import GATE, _pool  # noqa: E402
from tests.torch_port_scenes import Q_ID, T_ID, make_K  # noqa: E402

# the seeded 200-point frame of test_torch_tiling has 283 keys (273 live
# after the exact cull): one capacity above the total, two below it
CAP_ABOVE, CAPS_BELOW = 512, (256, 192)


@pytest.mark.parametrize("minimum, headroom", [
    (2 ** 15, 1.3),  # the trainer's defaults
    (512, 1.3),      # a small config key_cap: odd multiples such as 6144
    (1024, 1.0),
    (2 ** 15, 2.0),
])
def test_fit_key_cap_matches_jax(minimum, headroom):
    rng = np.random.default_rng(minimum)
    totals = [0, 1, 4700, 6144, 25_206, 471_633, 2 ** 20, 3 * 2 ** 21 + 1]
    totals += rng.integers(0, 5_000_000, 200).tolist()
    for total in totals:
        want = jtr.fit_key_cap(total, minimum=minimum, headroom=headroom)
        got = ttr.fit_key_cap(total, minimum=minimum, headroom=headroom)
        assert got == want, total
        assert got >= max(total * headroom, minimum)
    # the full-width frame's capacity, and an odd multiple of 512
    assert ttr.fit_key_cap(471_633) == 655_360
    assert ttr.fit_key_cap(4700, minimum=512) == 6144


def _port_keys(frame, cap, exact_tile_cull=True):
    """(capped keys, capped table, exact keys, exact table) of the port's
    tiling stage on a ``_frame``."""
    _, _, _, _, t_raw, t_radius, t_invalid = frame
    tcfg = tr.RasterizerConfig(tile_size=32, exact_tile_cull=exact_tile_cull)
    tcam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    keys, table, _ = tr.build_keys(t_raw, t_radius, t_invalid, tcam, tcfg,
                                   key_cap=cap)
    exact, exact_table, _ = tr.build_keys(t_raw, t_radius, t_invalid, tcam,
                                          tcfg)
    return keys, table, exact, exact_table


def _keys(cap, exact_tile_cull=True):
    """(JAX keys, JAX table, port capped keys, port capped table, port
    exact keys, port exact table) of the seeded 200-point frame."""
    frame = _frame((32, 32))
    jcam, raw, radius, invalid = frame[:4]
    jcfg = jr.RasterizerConfig(tile_size=32, key_cap=cap, interpret=True,
                               exact_tile_cull=exact_tile_cull)
    jkeys, jtable, _ = jr.build_keys(raw, radius, invalid, jcam, jcfg)
    return (jkeys, jtable) + _port_keys(frame, cap, exact_tile_cull)


@pytest.mark.parametrize("cap", (CAP_ABOVE,) + CAPS_BELOW)
@pytest.mark.parametrize("exact_tile_cull", [False, True])
def test_capped_keys_match_jax(cap, exact_tile_cull):
    jkeys, jtable, keys, table, exact, _ = _keys(cap, exact_tile_cull)
    total = int(jkeys.total)
    assert isinstance(keys.total, torch.Tensor) and keys.total.dim() == 0
    assert int(keys.total) == total == exact.total  # the true total
    assert (total > cap) == (cap in CAPS_BELOW)
    assert keys.fused.shape == keys.orig_slot.shape == (cap,)
    assert table.shape == (16, cap)
    for name in ("tile_start", "tile_end", "offsets"):
        np.testing.assert_array_equal(getattr(keys, name).numpy(),
                                      np.asarray(getattr(jkeys, name)),
                                      err_msg=name)
    # the same stable order over the whole buffer: live keys, culled keys,
    # then the padding (and past the cap, nothing)
    np.testing.assert_array_equal(keys.orig_slot.numpy(),
                                  np.asarray(jkeys.orig_slot))
    # the counts are JAX's, unclipped (num_overlap_tiles); the kept counts
    # are clipped to the keys below the cap (the segment sum's lengths:
    # JAX's segment sum reads no lane past the cap)
    off, cnt = np.asarray(jkeys.offsets), np.asarray(jkeys.counts)
    np.testing.assert_array_equal(keys.counts.numpy(), cnt)
    kept = np.minimum(off + cnt, cap) - np.minimum(off, cap)
    np.testing.assert_array_equal(keys.kept_counts.numpy(), kept)
    assert (keys.kept_counts.numpy() < cnt).any() == (total > cap)
    # tile by tile: the table rows of each tile's keys (row 5 is each
    # package's own f32 log, as in test_torch_tiling)
    live = int(keys.tile_end[-1])
    jt = np.asarray(jtable)[:10, :live]
    copied = [0, 1, 2, 3, 4, 6, 7, 8, 9]
    for t in range(len(keys.tile_start)):
        s, e = int(keys.tile_start[t]), int(keys.tile_end[t])
        np.testing.assert_array_equal(table[copied, s:e].numpy(),
                                      jt[copied, s:e], err_msg=f"tile {t}")
        np.testing.assert_allclose(table[5, s:e].numpy(), jt[5, s:e],
                                   rtol=2.5e-7, atol=0)
    sentinel = int(keys.fused.max())
    assert (keys.fused[live:] == sentinel).all()


@pytest.mark.parametrize("cap", [CAP_ABOVE, 283])
def test_capped_keys_above_total_are_the_exact_keys(cap):
    """A capacity at or above the total: the first ``total`` sorted slots
    are the exact path's keys, order and table, the ranges are its ranges,
    and the rest is sentinel padding owned by point 0."""
    keys, table, exact, exact_table = _port_keys(_frame((32, 32)), cap)
    total = exact.total
    assert total == 283
    np.testing.assert_array_equal(keys.fused[:total].numpy(),
                                  exact.fused.numpy())
    np.testing.assert_array_equal(keys.orig_slot[:total].numpy(),
                                  exact.orig_slot.numpy())
    np.testing.assert_array_equal(table[:, :total].numpy(),
                                  exact_table.numpy())
    for name in ("tile_start", "tile_end", "offsets", "counts",
                 "kept_counts"):
        np.testing.assert_array_equal(getattr(keys, name).numpy(),
                                      getattr(exact, name).numpy())
    sentinel = int(exact.fused.max())
    assert (keys.fused[total:] == sentinel).all()
    np.testing.assert_array_equal(keys.orig_slot[total:].numpy(),
                                  np.arange(total, cap))
    assert (table[10, total:] == 0).all()


@pytest.mark.parametrize("cap", [CAP_ABOVE, 256, 64])
def test_capped_slot_keys_decode_the_exact_slots(cap):
    """K1a's plain version in the capped mode: the slots below min(total,
    cap) are the exact mode's, the rest sentinel padding owned by point 0;
    the key total is read from a device scalar."""
    r, att, kw = _expand_inputs((32, 32), True)
    args = (r.offsets, r.counts, r.dkey, r.base, r.h, att)
    fused, owner = expand.slot_keys(*args, **kw)
    total = kw["total"]
    capped = dict(kw, total=cap)
    key_total = torch.tensor(total, dtype=torch.int64)
    fused_c, owner_c = expand.slot_keys(*args, **capped, key_total=key_total)
    live = min(total, cap)
    assert fused_c.shape == owner_c.shape == (cap,)
    np.testing.assert_array_equal(fused_c[:live].numpy(),
                                  fused[:live].numpy())
    np.testing.assert_array_equal(owner_c[:live].numpy(),
                                  owner[:live].numpy())
    assert (fused_c[live:] == kw["sentinel"]).all()
    assert (owner_c[live:] == 0).all()
    # the pre-sort table of the JAX contract in the capped mode
    fused_p, table_p = expand.expand_keys_plain(*args, **capped,
                                                key_total=key_total)
    np.testing.assert_array_equal(fused_p.numpy(), fused_c.numpy())
    _, table_x = expand.expand_keys_plain(*args, **kw)
    np.testing.assert_array_equal(table_p[:, :live].numpy(),
                                  table_x[:, :live].numpy())


def _states(cap):
    """The JAX step, the port's capped step and a shared start state at
    ``cap`` (test_torch_train_step's pool: 160 points, 8 padded slots)."""
    xyz, feats, invalid = _pool()
    n = len(xyz)
    jconfig = JTrainConfig(rasterisation_config=jr.RasterizerConfig(
        tile_size=32, key_cap=cap, interpret=True))
    scene = GaussianScene(xyz=jnp.asarray(xyz), features=jnp.asarray(feats),
                          invalid=jnp.asarray(invalid),
                          object_id=jnp.zeros((n,), jnp.int32))
    ftx, ptx = jtr.make_optimizers(jconfig)
    js = jtr.TrainState(scene=scene, feat_opt=ftx.init(scene.features),
                        pos_opt=ptx.init(scene.xyz), ctrl=jc.init_state(n))
    ts = train_state_from_jax(js.scene, js.feat_opt[0], js.pos_opt[0],
                              js.ctrl, device="cpu")
    config = TrainConfig(rasterisation_config=tr.RasterizerConfig(
        tile_size=32))
    return jtr.make_train_step(jconfig, 64, 64), js, config, ts


def _gt():
    return (np.random.default_rng(2).random((64, 64, 3)) * 255).astype(
        np.uint8)


@pytest.mark.parametrize("cap", [128])
def test_capped_step_matches_jax(cap):
    """One step with keys dropped (the pool's 215 keys over a capacity of
    128; the JAX blend needs a multiple of 128): the true key total, the
    loss and the gradients as JAX's."""
    jstep, js, config, ts = _states(cap)
    args = (_gt(), Q_ID, T_ID, make_K())
    js, jm, ja = jstep(js, *map(jnp.asarray, args), jnp.asarray(3, jnp.int32))
    tstep = ttr.make_train_step(config, 64, 64, device="cpu", key_cap=cap)
    ts, tm, ta = tstep(ts, *map(torch.from_numpy, args), 3)
    total = int(jm["num_keys"])
    assert total > cap and isinstance(tm["num_keys"], torch.Tensor)
    assert int(tm["num_keys"]) == total
    for k in ("loss", "l1", "ssim", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    for k in ("grad_features", "grad_xyz"):
        got, want = ta[k].numpy(), np.asarray(ja[k])
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, **GATE)
    np.testing.assert_allclose(ta["pred"].numpy(), np.asarray(ja["pred"]),
                               rtol=0, atol=1e-4)
    # the densification statistics while keys drop, at the gates of
    # test_torch_rasterizer_stats: num_overlap_tiles counts every key of a
    # point, kept or dropped, as JAX's does
    got, want = ta["stats"], ja["stats"]
    assert got._fields == want._fields
    np.testing.assert_array_equal(got.num_overlap_tiles.numpy(),
                                  np.asarray(want.num_overlap_tiles))
    assert int(got.num_overlap_tiles.sum()) == total
    np.testing.assert_array_equal(got.in_camera.numpy(),
                                  np.asarray(want.in_camera))
    np.testing.assert_allclose(got.grad_uv.numpy(), np.asarray(want.grad_uv),
                               **GATE)
    for f in ("magnitude_grad_viewspace", "num_affected_pixels"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=8e-3,
                                   atol=1e-12)
    np.testing.assert_allclose(
        got.magnitude_grad_viewspace_on_image.numpy(),
        np.asarray(want.magnitude_grad_viewspace_on_image), rtol=0, atol=1e-4)


def test_capped_step_above_total_is_the_exact_step():
    """With the capacity above the total the capped step and the exact
    step agree bit for bit: state, metrics and gradients."""
    _, _, config, ts = _states(4096)
    args = [torch.from_numpy(a) for a in (_gt(), Q_ID, T_ID, make_K())]
    exact = ttr.make_train_step(config, 64, 64, device="cpu")
    capped = ttr.make_train_step(config, 64, 64, device="cpu", key_cap=512)
    s1, m1, a1 = exact(ts, *args, 3)
    s2, m2, a2 = capped(ts, *args, 3)
    assert int(m2["num_keys"]) == m1["num_keys"] < 512
    for k in ("loss", "l1", "ssim", "psnr"):
        assert torch.equal(m1[k], m2[k]), k
    for k in ("grad_features", "grad_xyz", "pred"):
        assert torch.equal(a1[k], a2[k]), k
    for f in a1["stats"]._fields:
        assert torch.equal(getattr(a1["stats"], f),
                           getattr(a2["stats"], f)), f
    for a, b in zip(ck.state_leaves(s1), ck.state_leaves(s2)):
        assert torch.equal(a, b)


def test_capped_tiles_match_jax_build_tile_keys():
    """The keys-only entry point at a capacity below the total: the same
    ranges and order as JAX's ``build_tile_keys``."""
    _, raw, radius, _, t_raw, t_radius, _ = _frame((32, 32))
    vis = np.asarray(raw.depth) > 0.8
    jkeys = jtl.build_tile_keys(raw.uv, raw.depth, radius, jnp.asarray(vis),
                                64, 64, 32, 256, 100.0, interpret=True)
    keys, _ = ttl.build_tile_keys_and_table(
        t_raw.uv, t_raw.depth, t_radius, torch.from_numpy(vis), 64, 64, 32,
        100.0, key_cap=256)
    assert int(keys.total) == int(jkeys.total) > 256
    for name in ("tile_start", "tile_end", "offsets"):
        np.testing.assert_array_equal(getattr(keys, name).numpy(),
                                      np.asarray(getattr(jkeys, name)))
    np.testing.assert_array_equal(keys.orig_slot.numpy(),
                                  np.asarray(jkeys.orig_slot))
