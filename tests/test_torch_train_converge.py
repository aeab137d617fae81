"""The port's train step fits a synthetic image: tests/test_training.py's
convergence gate (60 steps at 32x32, the late loss under 0.7 of the early
one), on the port alone, on the CPU."""
import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.convert import (
    scene_from_jax_arrays,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    RasterizerConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from taichi_3d_gaussian_splatting_tpu_torch.training.loss import LossConfig
from tests.torch_port_scenes import (
    K32, Q_ID, T_ID, make_train_scene, synthetic_target,
)


def test_loss_decreases_fitting_synthetic_image():
    config = TrainConfig(
        rasterisation_config=RasterizerConfig(tile_size=32),
        loss_function_config=LossConfig(enable_regularization=False),
        feature_learning_rate=5e-2, position_learning_rate=1e-4)
    state = trainer.init_train_state(
        scene_from_jax_arrays(*make_train_scene(), device="cpu"), config)
    step = trainer.make_train_step(config, 32, 32, device="cpu")
    args = [torch.from_numpy(a) for a in (synthetic_target(), Q_ID, T_ID,
                                          K32)]
    losses = []
    for _ in range(60):
        state, metrics, _ = step(state, *args, 0)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    early, late = np.mean(losses[:5]), np.mean(losses[-5:])
    assert late < 0.7 * early, f"{early} -> {late}"
