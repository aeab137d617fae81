"""The port's scene-as-GMM Fourier analysis (``tools/ftgmm.py``) against
the JAX package's, as tests/test_ftgmm.py tests that one.

Gates: the mixture's parameters at rtol and atol 1e-6 (the same f32
formulas, a few roundings apart: values of order 1; the covariances at
rtol 1e-5, atol 1e-7); the log-probability
against JAX at rtol 1e-5 and against scipy's densities at rtol 1e-4
(test_ftgmm.py's); the sampled volume at rtol 1e-4 (exp of a
log-probability near -20 moves its last bits); both spectra against JAX at
atol 1e-5 (values of at most 1: an FFT over 17^3 bins and phases k.mu of
order 10, each rounded in f32 in another order); the DFT against the
closed form at low frequencies at test_ftgmm.py's atol 0.08.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.tools import ftgmm as jf  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.convert import (  # noqa: E402
    scene_from_jax_arrays,
)
from taichi_3d_gaussian_splatting_tpu_torch.tools import ftgmm as tf  # noqa: E402
from tests.test_ftgmm import make_scene  # noqa: E402


def _scenes(n=20, seed=0):
    j = make_scene(n, seed)
    t = scene_from_jax_arrays(np.asarray(j.xyz), np.asarray(j.features),
                              np.asarray(j.invalid), device="cpu")
    return j, t


def test_mixture_matches_jax():
    j, t = _scenes()
    jg, tg = jf.scene_to_gmm(j), tf.scene_to_gmm(t)
    assert tg.means.shape == (17, 3)  # 20 - 3 invalid
    for f in tg._fields:
        np.testing.assert_allclose(getattr(tg, f).numpy(),
                                   np.asarray(getattr(jg, f)), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tf.gmm_covariances(tg).numpy(),
                               np.asarray(jf.gmm_covariances(jg)),
                               rtol=1e-5, atol=1e-7)
    sub = tf.scene_to_gmm(t, max_components=5, seed=3)
    jsub = jf.scene_to_gmm(j, max_components=5, seed=3)
    np.testing.assert_array_equal(sub.means.numpy(), np.asarray(jsub.means))


@pytest.mark.parametrize("comp_chunk", [4096, 4])
def test_log_prob_matches_jax_and_scipy(comp_chunk):
    from scipy.stats import multivariate_normal

    j, t = _scenes()
    jg, tg = jf.scene_to_gmm(j), tf.scene_to_gmm(t)
    pts = np.random.default_rng(1).normal(0, 1, (10, 3)).astype(np.float32)
    got = tf.gmm_log_prob(tg, torch.from_numpy(pts),
                          comp_chunk=comp_chunk).numpy()
    want = np.asarray(jf.gmm_log_prob(jg, jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    covs = tf.gmm_covariances(tg).numpy()
    w = np.exp(tg.log_weights.numpy())
    expected = np.log(sum(
        w[i] * multivariate_normal.pdf(pts, tg.means.numpy()[i], covs[i])
        for i in range(len(w))))
    np.testing.assert_allclose(got, expected, rtol=1e-4)


def test_volume_and_spectra_match_jax():
    j, t = _scenes(n=8, seed=2)
    jg, tg = jf.scene_to_gmm(j), tf.scene_to_gmm(t)
    jv, jmin, jmax = jf.sample_volume(jg, grid_size=17)
    tv, tmin, tmax = tf.sample_volume(tg, grid_size=17)
    np.testing.assert_array_equal(tmin, jmin)
    np.testing.assert_array_equal(tmax, jmax)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-30)
    jm, jdft, jan = jf.compare_fft_vs_closed_form(jg, jv, jmin, jmax)
    tm, tdft, tan = tf.compare_fft_vs_closed_form(tg, tv, tmin, tmax)
    np.testing.assert_allclose(tdft, jdft, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tan, jan, rtol=0, atol=1e-5)
    for k in ("mag_err_mean", "mag_err_max"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-7)
    # the frequency and component chunks add up exactly
    k = torch.from_numpy(tf.fourier_coords(17, tmin, tmax))
    small = tf.gmm_fourier(tg, k, tmin, tmax, freq_chunk=100, comp_chunk=3)
    np.testing.assert_allclose(small.numpy(), tan, rtol=0, atol=1e-5)


def test_dft_matches_closed_form():
    """tests/test_ftgmm.py::test_dft_matches_closed_form on the port."""
    _, t = _scenes(n=8, seed=2)
    gmm = tf.scene_to_gmm(t)
    volume, bmin, bmax = tf.sample_volume(gmm, grid_size=33)
    metrics, dft, analytic = tf.compare_fft_vs_closed_form(gmm, volume, bmin,
                                                           bmax)
    assert abs(metrics["dc_dft"] - 1.0) < 1e-3
    assert abs(metrics["dc_analytic"]) > 0.5
    mid = 16
    sl = np.s_[mid - 3: mid + 4, mid - 3: mid + 4, mid - 3: mid + 4]
    np.testing.assert_allclose(np.abs(dft[sl]), np.abs(analytic[sl]),
                               atol=0.08)


def test_ft_grab_scene_matches_jax_and_writes_plots(tmp_path):
    j, t = _scenes(n=6, seed=3)
    want = jf.ft_grab_scene(j, grid_size=17, vis_dir=str(tmp_path / "j"))
    got = tf.ft_grab_scene(t, grid_size=17, vis_dir=str(tmp_path / "t"))
    assert (tmp_path / "t" / "grid_gt.png").exists()
    assert (tmp_path / "t" / "volume_fourier_spectrum.png").exists()
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.isfinite(abs(got[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6)
    assert tf.ft_grab_scene(t, grid_size=9, plot=False,
                            vis_dir=str(tmp_path / "none"))
    assert not (tmp_path / "none").exists()
