"""The port's optimizer, learning-rate schedule, densify accumulators and
config parsing against the JAX package's (optax, ``controller.accumulate``,
``config.from_dict``).

Adam fed the same gradients as optax moves the parameters the same way to
1e-6 over 10 steps (float32, the same formula); the schedule and the
config agree exactly; the accumulators to rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.training import config as jcfg  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import controller as jc  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import config as tcfg  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import controller as tc  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from tests.torch_port_scenes import host_scalar_adam  # noqa: E402


@pytest.mark.parametrize("which", [0, 1])  # features, positions
def test_adam_matches_optax(which):
    config = dict(feature_learning_rate=1e-2, position_learning_rate=1e-3,
                  position_learning_rate_decay_interval=3)
    jtx = jtr.make_optimizers(jcfg.TrainConfig(**config))[which]
    ttx = ttr.make_optimizers(tcfg.TrainConfig(**config))[which]
    rng = np.random.default_rng(which)
    p0 = rng.normal(size=(64, 3)).astype(np.float32)
    jp, js = jnp.asarray(p0), jtx.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0)
    ts = ttx.init(tp)
    for step in range(10):
        g = rng.normal(size=(64, 3)).astype(np.float32) * 10.0 ** (step % 3)
        g[0] = 0.0  # a parameter with no gradient yet
        u, js = jtx.update(jnp.asarray(g), js)
        jp = optax.apply_updates(jp, u)
        tp, ts = ttx.update(torch.from_numpy(g), ts, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-6)
    assert ts.count == int(js[0].count) == 10
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js[0].mu),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js[0].nu),
                               rtol=1e-6, atol=1e-12)


def test_position_lr_matches_optax_schedule():
    """The rate the step takes (``lr`` of its () int64 count) against
    optax's schedule, and equal to the f32 value of the Python double
    ``lr0 * rate ** (count // interval)``."""
    config = tcfg.TrainConfig()
    schedule = optax.exponential_decay(
        init_value=config.position_learning_rate, transition_steps=100,
        decay_rate=0.97, staircase=True)
    _, pos = ttr.make_optimizers(config)

    def lr(count):
        return pos.lr(torch.tensor(count, dtype=torch.int64))
    for count in (0, 99, 100, 250):
        np.testing.assert_allclose(float(lr(count)), float(schedule(count)),
                                   rtol=1e-6)
    assert lr(99) == lr(0) > lr(100) > lr(250)
    for n in range(400):
        count = n * 100 + n % 100
        assert lr(count).dtype == torch.float32
        assert float(lr(count)) == float(np.float32(
            config.position_learning_rate * 0.97 ** n)), count


@pytest.mark.parametrize("which", [0, 1])  # features, positions
def test_adam_update_equals_the_host_scalar_update(which):
    """Adam's update with its count on the device (bias corrections read
    from ``_bias_table``, the rate cast from f64) equals, bit for bit, the
    update with host floats over counts 1-400 and 17,300-17,340 (where
    0.999's correction reaches 1.0), with the position rate decaying every
    3 updates."""
    config = dict(feature_learning_rate=1e-2, position_learning_rate=1e-3,
                  position_learning_rate_decay_interval=3)
    tx = ttr.make_optimizers(tcfg.TrainConfig(**config))[which]
    rng = np.random.default_rng(which)
    param = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    for start in (0, 17299):
        state = tx.init(param)._replace(
            count=torch.tensor(start, dtype=torch.int64))
        for _ in range(400 if start == 0 else 41):
            grad = torch.from_numpy((rng.normal(size=(64, 3))
                                     * 10.0 ** rng.integers(-3, 3)).astype(
                                         np.float32))
            want, mu, nu = host_scalar_adam(tx, grad, state, param)
            param, state = tx.update(grad, state, param)
            assert torch.equal(param, want), int(state.count)
            assert torch.equal(state.mu, mu) and torch.equal(state.nu, nu)


def test_accumulate_matches_jax():
    rng = np.random.default_rng(3)
    n = 40
    in_camera = rng.random(n) > 0.3
    npix = rng.integers(0, 20, n).astype(np.float32)
    npix[:4] = 0.0  # x/0 and 0/0: zeroed by the non-finite guard
    mag = rng.random(n).astype(np.float32)
    mag[0] = 0.0
    gxyz = rng.normal(size=(n, 3)).astype(np.float32)
    js = jc.init_state(n)
    ts = tc.init_state(n, device="cpu")
    for _ in range(2):
        js = jc.accumulate(js, *map(jnp.asarray, (in_camera, npix, mag, gxyz)))
        ts = tc.accumulate(ts, *map(torch.from_numpy,
                                    (in_camera, npix, mag, gxyz)))
    assert ts._fields == js._fields
    for f in ts._fields:
        got = getattr(ts, f).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(getattr(js, f)),
                                   rtol=1e-6, atol=0)


def test_controller_config_matches_jax():
    got = dataclasses.asdict(tc.ControllerConfig())
    assert got == dataclasses.asdict(jc.ControllerConfig())


def test_config_from_dict_matches_jax():
    data = {
        "feature-learning-rate": "1e-4",  # YAML 1.1 reads this as a string
        "position_learning_rate": 2e-5, "num_iterations": "100",
        "train_slim": "no", "unknown_key": 1,
        "rasterisation-config": {"tile_size": 16, "tile_h": 8,
                                 "grad_color_factor": "3"},
        "adaptive_controller_config": {"num_iterations_densify": 50},
        "loss_function_config": {"lambda-value": 0.3,
                                 "enable_regularization": "false"},
        "gaussian_point_cloud_scene_config": {"max_num_points_ratio": 1.5},
    }
    want = jcfg.from_dict(data)
    got = tcfg.from_dict(data)
    fields = [f.name for f in dataclasses.fields(tcfg.TrainConfig)]
    assert fields == [f.name for f in dataclasses.fields(jcfg.TrainConfig)]
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(g):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name
        else:
            assert g == w, name
    assert got.feature_learning_rate == 1e-4 and not got.train_slim
    with pytest.raises(ValueError, match="num_iterations"):
        tcfg.from_dict({"num_iterations": "many"})


def test_load_config_reads_yaml(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text("feature_learning_rate: 1e-4\n"
                    "rasterisation_config:\n  tile_size: 16\n")
    got = tcfg.load_config(str(path))
    assert got.feature_learning_rate == 1e-4
    assert got.rasterisation_config.tile_size == 16
