"""YAML -> nested dataclass training config.

Port of ``taichi_3d_gaussian_splatting_tpu/training/config.py``: kebab-case
and snake_case keys both accepted, unknown keys tolerated, and YAML 1.1
scalars coerced to the field's type (``1e-5`` parses as a string there).
PyYAML is imported by ``load_config`` (for a file not named ``.json``) and
``save_template`` alone: nothing else here needs it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Type, TypeVar

from taichi_3d_gaussian_splatting_tpu_torch.models.scene import SceneConfig
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import RasterizerConfig
from taichi_3d_gaussian_splatting_tpu_torch.training.controller import (
    ControllerConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.loss import LossConfig

T = TypeVar("T")


def _from_dict(cls: Type[T], data: Any) -> T:
    if data is None:
        return cls()
    if not isinstance(data, dict):
        raise ValueError(f"expected a mapping for {cls.__name__}, got "
                         f"{type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        name = key.replace("-", "_")
        if name not in fields:
            continue  # tolerate unknown keys like the reference
        f = fields[name]
        if isinstance(f.type, str) and f.type in _NESTED:
            kwargs[name] = _from_dict(_NESTED[f.type], value)
        elif dataclasses.is_dataclass(f.type):
            kwargs[name] = _from_dict(f.type, value)
        else:
            kwargs[name] = _coerce_scalar(f.type, name, value)
    return cls(**kwargs)


def _coerce_scalar(ftype, name: str, value):
    """Coerce YAML scalars to the annotated field type (YAML 1.1 reads a
    dotless exponent like ``1e-5`` as a string)."""
    if value is None:
        return None
    t = str(ftype).replace("Optional[", "").rstrip("]")
    try:
        if t == "float":
            return float(value)
        if t == "int":
            return int(value)
        if t == "bool" and isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"config field {name!r} expects {t}, got {value!r}") from e
    return value


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig, field for field."""

    train_dataset_json_path: str = ""
    val_dataset_json_path: str = ""
    pointcloud_parquet_path: str = ""
    num_iterations: int = 300000
    val_interval: int = 1000
    feature_learning_rate: float = 1e-3
    position_learning_rate: float = 1e-5
    position_learning_rate_decay_rate: float = 0.97
    position_learning_rate_decay_interval: int = 100
    increase_color_max_sh_band_interval: int = 1000
    log_loss_interval: int = 10
    log_metrics_interval: int = 100
    print_metrics_to_console: bool = False
    log_image_interval: int = 1000
    enable_taichi_kernel_profiler: bool = False
    log_taichi_kernel_profile_interval: int = 1000
    log_validation_image: bool = True
    initial_downsample_factor: int = 4
    half_downsample_factor_interval: int = 250
    summary_writer_log_dir: str = "logs"
    output_model_dir: Optional[str] = None
    rasterisation_config: RasterizerConfig = field(default_factory=RasterizerConfig)
    adaptive_controller_config: ControllerConfig = field(default_factory=ControllerConfig)
    gaussian_point_cloud_scene_config: SceneConfig = field(default_factory=SceneConfig)
    loss_function_config: LossConfig = field(default_factory=LossConfig)
    train_slim: bool = True                # train steps blend rgb only
    seed: int = 0
    resume_from: Optional[str] = None
    save_full_checkpoint: bool = True
    num_data_threads: int = 4
    steps_per_dispatch: int = 1
    enable_jax_profiler: bool = False
    jax_profiler_start_iteration: int = 200
    jax_profiler_num_iterations: int = 20
    data_parallel_devices: int = 1
    tile_parallel_devices: int = 1
    multihost: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    pose_refinement: bool = False
    pose_learning_rate: float = 1e-4
    pose_refinement_warm_up: int = 500


_NESTED = {
    "RasterizerConfig": RasterizerConfig,
    "ControllerConfig": ControllerConfig,
    "SceneConfig": SceneConfig,
    "LossConfig": LossConfig,
}


def load_config(path: str) -> TrainConfig:
    """The config of a YAML file, or of a ``.json`` file (JSON is YAML too;
    it is read with the standard library, where PyYAML is missing)."""
    if str(path).endswith(".json"):
        import json

        with open(path) as f:
            data = json.load(f)
    else:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
    return _from_dict(TrainConfig, data)


def from_dict(data: dict) -> TrainConfig:
    return _from_dict(TrainConfig, data)


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


def save_template(path: str) -> None:
    """Write the default TrainConfig as YAML (``--gen_template_only``)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(_to_dict(TrainConfig()), f, sort_keys=False)
