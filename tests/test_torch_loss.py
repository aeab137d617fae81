"""The port's training loss against the JAX package's: L1 + SSIM with the
masked scale regularizer, SSIM and PSNR, their values and their gradients
with respect to the prediction and the features.

float32 with another blur (two depthwise convolutions where JAX takes
banded matmuls at HIGHEST precision): rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.training import loss as jl  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import loss as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _images(h=40, w=48, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.random((h, w, 3)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.1, (h, w, 3)), 0, 1).astype(
        np.float32)
    pred[:5, :7] = 0.5  # a flat patch, where the variance cancels
    target[:5, :7] = 0.5
    return pred, target


def _features(n=50, seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, 56)).astype(np.float32)
    invalid = np.zeros((n,), bool)
    invalid[:6] = True
    feats[:3, 4:7] = 100.0  # exp overflows on invalid rows: masked
    return feats, invalid


@pytest.mark.parametrize("reg", [False, True])
def test_compute_loss_and_gradients_match_jax(reg):
    pred, target = _images()
    feats, invalid = _features()
    jcfg = jl.LossConfig(enable_regularization=reg)
    tcfg = tl.LossConfig(enable_regularization=reg)

    def jloss(p, f):
        return jl.compute_loss(p, jnp.asarray(target), jcfg, features=f,
                               invalid_mask=jnp.asarray(invalid))

    (jv, (jl1, jssim)), jg = jax.value_and_grad(
        lambda p, f: (lambda r: (r[0], r[1:]))(jloss(p, f)),
        argnums=(0, 1), has_aux=True)(jnp.asarray(pred), jnp.asarray(feats))
    p = torch.from_numpy(pred).requires_grad_(True)
    f = torch.from_numpy(feats).requires_grad_(True)
    tv, tl1, tssim = tl.compute_loss(p, torch.from_numpy(target), tcfg,
                                     features=f,
                                     invalid_mask=torch.from_numpy(invalid))
    tg = torch.autograd.grad(tv, (p, f), allow_unused=True)
    for got, want in ((tv, jv), (tl1, jl1), (tssim, jssim)):
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), **TOL)
    if reg:
        assert np.isfinite(tg[1].numpy()).all()
        assert not tg[1].numpy()[invalid].any()
        np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]), **TOL)
    else:
        assert tg[1] is None and not np.asarray(jg[1]).any()


def test_ssim_psnr_and_unmasked_regularizer_match_jax():
    pred, target = _images(33, 35, seed=3)
    feats, _ = _features(seed=4)
    feats[:, 4:7] = np.clip(feats[:, 4:7], -3, 3)
    jp, jt_ = jnp.asarray(pred), jnp.asarray(target)
    tp, tt_ = torch.from_numpy(pred), torch.from_numpy(target)
    np.testing.assert_allclose(float(tl.ssim(tp, tt_)),
                               float(jl.ssim(jp, jt_)), **TOL)
    np.testing.assert_allclose(float(tl.ssim(tp, tp)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(tl.psnr(tp, tt_)),
                               float(jl.psnr(jp, jt_)), **TOL)
    cfg_t, cfg_j = tl.LossConfig(), jl.LossConfig()
    got = tl.compute_loss(tp, tt_, cfg_t, features=torch.from_numpy(feats))
    want = jl.compute_loss(jp, jt_, cfg_j, features=jnp.asarray(feats))
    np.testing.assert_allclose(float(got[0]), float(want[0]), **TOL)
    with pytest.raises(ValueError, match="11px"):
        tl.ssim(tp[:10], tt_[:10])
