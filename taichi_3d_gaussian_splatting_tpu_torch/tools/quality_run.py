"""Synthetic end-to-end quality gate: fit a procedurally generated scene.

The port's counterpart of ``scripts/quality_run.py``, flag for flag:

    python -m taichi_3d_gaussian_splatting_tpu_torch.tools.quality_run \\
        [--iterations 2001] [--views 48] [--hw 256] [--out DIR] \\
        [--pose_noise 0.0] [--long | --reference_regime] [--device cuda]

``--out`` defaults to ``quality_run`` under the temporary directory
(``TMPDIR``, else ``/tmp`` as in the JAX script).

It renders ground-truth views of a procedural Gaussian scene with the
port's ``rasterize`` on the device, writes them as a standard dataset (8-bit
PNGs, ``train.json``/``val.json`` split by ``i % 8``, and a
``point_cloud.parquet`` of noisy subsampled init points, mimicking COLMAP
output), then runs the full ``GaussianPointCloudTrainer`` on it (data
loader, windows of ``steps_per_dispatch`` steps, densification, alpha
resets, validation checkpoints) with the JAX script's config, value for
value, and prints the best val PSNR.

The dataset is the JAX script's: the same ``np.random.default_rng(0)``
draws in the same order (the GT scene, the pose noise, the init selection
and its noise), the same cameras, and PNGs written as
``(img * 255).astype(np.uint8)`` (truncation). The GT frames come from the
port's blend, so a pixel whose value lies on a 1/255 boundary may land one
level off the JAX script's.

A second call on the same ``--out`` keeps the dataset and resumes from
``logs/checkpoint_latest``. ``--device`` is ``cuda`` unless the caller asks
for ``cpu`` (the kernels' plain versions; for tests): with no card the run
fails, it never falls back to the CPU.

Besides the JAX script's lines it prints each validation's val PSNR (read
through the trainer's ``_scalar``), the window graphs captured and
replayed, the key-capacity refits, and the steps whose true key total
exceeded the capacity or whose loss was not finite. PIL, pandas and scipy
are imported where they are used.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch


def make_gt_scene(rng, n_clusters=40, pts_per_cluster=400, spread=2.0,
                  scale_range=(-4.2, -3.0), color_noise=0.3):
    """Blobby clustered scene with varied color/scale/opacity.

    ``scale_range``/``color_noise`` control intrinsic detail: small
    splats with strong per-point color variance make a target whose
    optimum genuinely needs hundreds of thousands of reconstruction
    splats (the reference-regime growth proof), where the default
    smooth-blob scene converges at ~100k."""
    centers = rng.uniform(-spread, spread, (n_clusters, 3))
    centers[:, 2] = rng.uniform(-spread / 2, spread / 2, n_clusters)
    xyz, feats = [], []
    for c in centers:
        k = pts_per_cluster
        p = c + rng.normal(0, 0.25, (k, 3))
        f = np.zeros((k, 56), np.float32)
        q = rng.normal(size=(k, 4))
        f[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
        f[:, 4:7] = rng.uniform(*scale_range, (k, 3))
        f[:, 7] = rng.uniform(0.0, 4.0, k)
        base = rng.uniform(-2.5, 2.5, 3)
        f[:, 8] = base[0] + rng.normal(0, color_noise, k)
        f[:, 24] = base[1] + rng.normal(0, color_noise, k)
        f[:, 40] = base[2] + rng.normal(0, color_noise, k)
        # mild view dependence on band 1
        f[:, 9:12] = rng.normal(0, 0.1, (k, 3))
        xyz.append(p)
        feats.append(f)
    return (np.concatenate(xyz).astype(np.float32),
            np.concatenate(feats).astype(np.float32))


def ring_cameras(n, radius=6.0, height=1.5, hw=256, fov_f=300.0, w=None):
    """Cameras on a ring looking at the origin (x right, y down, z fwd).

    ``hw`` is the image height; ``w`` the width (default square)."""
    cams = []
    if w is None:
        w = hw
    K = np.asarray([[fov_f, 0, w / 2], [0, fov_f, hw / 2], [0, 0, 1.0]],
                   np.float32)
    for i in range(n):
        th = 2 * np.pi * i / n
        pos = np.asarray([radius * np.cos(th), -height, radius * np.sin(th)])
        fwd = -pos / np.linalg.norm(pos)
        up_w = np.asarray([0.0, -1.0, 0.0])
        right = np.cross(up_w, fwd); right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)  # camera->world columns
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = pos
        cams.append((T, K))
    return cams


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX script's flags and presets, and ``--device``; ``width`` is
    set (896 under ``--reference_regime``, else ``--hw``)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iterations", type=int, default=2001)
    parser.add_argument("--views", type=int, default=48)
    parser.add_argument("--hw", type=int, default=256)
    parser.add_argument("--out", type=str, default=os.path.join(
        tempfile.gettempdir(), "quality_run"))
    parser.add_argument("--pose_noise", type=float, default=0.0,
                        help="perturb TRAIN poses by this magnitude "
                        "(radians rot / units trans) and enable pose "
                        "refinement; GT images keep the true poses, so "
                        "refinement must recover the perturbation")
    parser.add_argument("--long", action="store_true",
                        help="long-horizon preset: 512px views with "
                        "progressive downsample from 4x, SH band up to 3, "
                        "alpha resets every 3000 its, floater removal "
                        "after 2000, a capacity-stressed pool (default "
                        "iterations become 10000)")
    parser.add_argument("--reference_regime", action="store_true",
                        help="the reference's 30k Truck regime "
                        "(config/tat_truck_every_8_test.yaml + the "
                        "reference trainer's defaults): 30001 iterations "
                        "at 896x512, 128 views, ~65k init rows in a "
                        "~488k-capacity pool, densify every 100 after "
                        "1000, alpha reset every 4000, floater removal "
                        "from 2000, SH band ramp every 1000, val every "
                        "1000")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the kernels' plain "
                        "versions, for tests)")
    args = parser.parse_args(argv)
    args.width = None
    if args.reference_regime:
        if args.iterations == 2001:
            args.iterations = 30001
        if args.views == 48:
            args.views = 128  # 112 train / 16 val (reference every-8: ~219/32)
        args.hw = 512
        args.width = 896
    elif args.long:
        if args.iterations == 2001:
            args.iterations = 10000
        args.hw = 512
    if args.width is None:
        args.width = args.hw
    return args


def check_device(device: str) -> torch.device:
    """``device`` as a torch device; a CUDA device with no card fails."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quality_run: no CUDA card (torch.cuda.is_available()"
                         " is False); --device cpu runs the plain versions")
    return dev


def image_path(out: str, i: int) -> str:
    """The PNG of view ``i``, as train.json and val.json name it."""
    return f"{out}/imgs/{i:03d}.png"


@dataclass
class GTDataset:
    """The dataset in memory, as the files hold it."""

    images: list          # (H, W, 3) uint8 a view, as its PNG stores it
    train: list           # records of train.json
    val: list             # records of val.json
    init_points: np.ndarray
    init_rgb: np.ndarray  # (n, 1) in [0, 255]
    have_dataset: bool
    gt_points: int
    gt_keys: list         # each view's key total


def render_views(gt_xyz, gt_feats, cams, height: int, width: int,
                 key_cap: int, dev: torch.device):
    """Each camera's GT frame, clipped to [0, 1], as f32 numpy, and the
    frame's key total. The config is the JAX script's (tile 32,
    ``key_cap``); the port's render sizes its keys exactly and reads no
    capacity."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
        Camera, RasterizerConfig, rasterize,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
        se3_to_qt,
    )

    if not cams:
        return [], []
    rcfg = RasterizerConfig(tile_size=32, key_cap=key_cap)
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    camera = Camera(K=put(cams[0][1]), width=width, height=height)
    xyz, feats = put(gt_xyz), put(gt_feats)
    invalid = torch.zeros((xyz.shape[0],), dtype=torch.bool, device=dev)
    frames, keys = [], []
    with torch.no_grad():
        for T, _ in cams:
            q, t = se3_to_qt(put(T))
            out, num_keys = rasterize(xyz, feats, invalid, q, t, camera,
                                      rcfg, return_num_keys=True)
            frames.append(torch.clamp(out.rgb, 0, 1).cpu().numpy())
            keys.append(int(num_keys))
    return frames, keys


def make_dataset(args) -> GTDataset:
    """The GT scene, its views and the init points, from the JAX script's
    ``np.random.default_rng(0)`` draws in its order; no view is rendered
    when ``{out}/train.json`` exists (the init points are then empty: the
    parquet on disk is kept)."""
    dev = check_device(args.device)
    have_dataset = os.path.exists(f"{args.out}/train.json")
    rng = np.random.default_rng(0)
    if args.reference_regime:
        # detailed enough that the optimum wants several hundred thousand
        # splats at 896x512: 440k small splats (~1-2.5 px at the ring
        # cameras' depth) with strong per-point color texture
        gt_xyz, gt_feats = make_gt_scene(
            rng, n_clusters=2000, pts_per_cluster=220, spread=2.6,
            scale_range=(-4.8, -3.6), color_noise=0.5)
    else:
        gt_xyz, gt_feats = make_gt_scene(rng)
    n = gt_xyz.shape[0]
    print(f"GT scene: {n} gaussians", flush=True)

    cams = ring_cameras(args.views, hw=args.hw, w=args.width)
    if have_dataset:
        print("dataset exists, skipping GT render", flush=True)
        cams = []
    key_cap = 2 ** 21 if args.reference_regime else 2 ** 19
    frames, keys = render_views(gt_xyz, gt_feats, cams, args.hw, args.width,
                                key_cap, dev)
    # the JAX script's GT render keeps key_cap keys and drops the rest
    over = sum(k > key_cap for k in keys)
    if over:
        print(f"{over} GT views have more keys than the JAX script's key_cap"
              f" {key_cap} (most: {max(keys)})", flush=True)
    images, records = [], []
    for i, ((T, K), img) in enumerate(zip(cams, frames)):
        images.append((img * 255).astype(np.uint8))
        records.append({
            "image_path": image_path(args.out, i),
            "T_pointcloud_camera": T.tolist(),
            "camera_intrinsics": K.tolist(),
            "camera_height": args.hw, "camera_width": args.width,
            "camera_id": 0,
        })
    train = [r for i, r in enumerate(records) if i % 8 != 0]
    val = [r for i, r in enumerate(records) if i % 8 == 0]
    if not have_dataset and args.pose_noise > 0:
        # images stay rendered at the TRUE poses; the recorded train poses
        # get an se(3) perturbation in the refinement-delta convention
        # (T' = T * exp(noise)) for refinement to undo
        from scipy.spatial.transform import Rotation

        for r in train:
            T = np.asarray(r["T_pointcloud_camera"], np.float32)
            w = rng.normal(0, args.pose_noise, 3)
            T2 = T.copy()
            T2[:3, :3] = T[:3, :3] @ Rotation.from_rotvec(w).as_matrix()
            T2[:3, 3] += rng.normal(0, args.pose_noise, 3)
            r["T_pointcloud_camera"] = T2.tolist()

    # noisy subsampled init (mimic COLMAP sparse points)
    init_frac = 8
    sel = rng.choice(n, n // init_frac, replace=False)
    if have_dataset:
        sel = sel[:0]  # keep the existing parquet
    init_pts = gt_xyz[sel] + rng.normal(0, 0.05, (len(sel), 3))
    rgb = np.clip(1 / (1 + np.exp(-gt_feats[sel, 8:9])) * 255, 0, 255)
    return GTDataset(images, train, val, init_pts, rgb, have_dataset, n,
                     keys)


def point_frame(data: GTDataset):
    """The init points as the parquet's DataFrame (x, y, z, r, g, b; the
    three colour columns are the red channel's, as in the JAX script)."""
    import pandas as pd

    p, rgb = data.init_points, data.init_rgb
    return pd.DataFrame({"x": p[:, 0], "y": p[:, 1], "z": p[:, 2],
                         "r": rgb[:, 0], "g": rgb[:, 0], "b": rgb[:, 0]})


def write_images(out: str, data: GTDataset) -> None:
    from PIL import Image

    os.makedirs(f"{out}/imgs", exist_ok=True)
    for i, img in enumerate(data.images):
        Image.fromarray(img).save(image_path(out, i))


def write_dataset(out: str, data: GTDataset) -> None:
    """The PNGs, ``train.json``/``val.json`` and ``point_cloud.parquet``
    (nothing when the dataset existed)."""
    if data.have_dataset:
        return
    write_images(out, data)
    with open(f"{out}/train.json", "w") as f:
        json.dump(data.train, f)
    with open(f"{out}/val.json", "w") as f:
        json.dump(data.val, f)
    point_frame(data).to_parquet(f"{out}/point_cloud.parquet")


def config_dict(args) -> dict:
    """The JAX script's trainer config, value for value (``interpret``:
    True on the CPU, where the port runs the plain versions as the JAX
    package runs its kernels in interpret mode there)."""
    out = args.out
    resume_ck = f"{out}/logs/checkpoint_latest"
    interpret = torch.device(args.device).type == "cpu"
    cfg = {
        "train_dataset_json_path": f"{out}/train.json",
        "val_dataset_json_path": f"{out}/val.json",
        "pointcloud_parquet_path": f"{out}/point_cloud.parquet",
        "summary_writer_log_dir": f"{out}/logs",
        "num_iterations": args.iterations,
        "val_interval": max(args.iterations // 4, 250),
        "initial_downsample_factor": 2,
        "half_downsample_factor_interval": 250,
        "feature_learning_rate": 0.005,
        "position_learning_rate": 0.00005,
        "print_metrics_to_console": False,
        "log_metrics_interval": 100,
        "rasterisation_config": {
            "tile_size": 32, "key_cap": 2**19, "interpret": interpret,
        },
        "adaptive_controller_config": {
            "num_iterations_warm_up": 300,
            "num_iterations_densify": 100,
            "densification_view_space_position_gradients_threshold": 3e-6,
            "under_reconstructed_num_pixels_threshold": 32,
            "num_iterations_reset_alpha": 100000,  # off for short runs
            "reset_alpha_value": -1.9,
            "transparent_alpha_threshold": -2.0,
        },
        "gaussian_point_cloud_scene_config": {
            "max_num_points_ratio": 20.0,
            "initial_alpha": 0.0,
            "max_initial_covariance": 10.0,
            "initial_covariance_ratio": 0.5,
        },
        "loss_function_config": {"enable_regularization": False},
        "resume_from": resume_ck if os.path.exists(resume_ck) else None,
        "steps_per_dispatch": 10,
        "pose_refinement": args.pose_noise > 0,
        "pose_learning_rate": 1e-3,
        "pose_refinement_warm_up": 300,
    }
    if args.reference_regime:
        # config/tat_truck_every_8_test.yaml and the reference trainer's
        # defaults, value for value
        cfg.update({
            "initial_downsample_factor": 4,
            "half_downsample_factor_interval": 250,
            "increase_color_max_sh_band_interval": 1000,
            "val_interval": 1000,
            "feature_learning_rate": 0.005,
            "position_learning_rate": 0.00005,
            "position_learning_rate_decay_rate": 0.9947,
            "position_learning_rate_decay_interval": 100,
            "log_metrics_interval": 100,
        })
        cfg["rasterisation_config"].update({"key_cap": 2 ** 19})
        cfg["steps_per_dispatch"] = 20
        cfg["adaptive_controller_config"].update({
            "num_iterations_warm_up": 1000,
            "num_iterations_densify": 100,
            # the reference's 3e-6 is tuned to Truck's photo gradients;
            # this synthetic GT converges to ~10x smaller residuals, so the
            # same selection rule needs a proportionally lower threshold
            "densification_view_space_position_gradients_threshold": 5e-7,
            "gaussian_split_factor_phi": 1.6,
            "num_iterations_reset_alpha": 4000,
            "reset_alpha_value": -1.9,
            "transparent_alpha_threshold": -2.0,
            "iteration_start_remove_floater": 2000,
            # the reference's absolute pixel counts at ~980x546, scaled to
            # the 896x512 frame area
            "floater_num_pixels_threshold": 343_000,
            "floater_near_camrea_num_pixels_threshold": 257_000,
            "under_reconstructed_num_pixels_threshold": 32,
            "under_reconstructed_move_factor": 10.0,
        })
        cfg["gaussian_point_cloud_scene_config"].update({
            # ~65k init rows (55k COLMAP-like + 10k sky sphere) x 7.5 =
            # ~488k capacity >= the published 428,687-point checkpoint
            "max_num_points_ratio": 7.5,
            "add_sphere": True,
            "initial_alpha": 0.05,
        })
    elif args.long:
        # the 30k-style schedule with every trainer cadence live
        cfg.update({
            "initial_downsample_factor": 4,
            "half_downsample_factor_interval": 500,
            "increase_color_max_sh_band_interval": 1000,
            "val_interval": 1000,
        })
        cfg["adaptive_controller_config"].update({
            "num_iterations_warm_up": 500,
            "num_iterations_reset_alpha": 3000,
            "reset_alpha_value": 0.1,
            "transparent_alpha_threshold": -0.5,
            "iteration_start_remove_floater": 2000,
            "floater_num_pixels_threshold": 10000,
            "floater_near_camrea_num_pixels_threshold": 10000,
        })
        cfg["gaussian_point_cloud_scene_config"].update({
            "max_num_points_ratio": 6.0,
            "add_sphere": True,
        })
    return cfg


class Watch:
    """What the gate reads off a trainer while it trains, through wrappers
    on its methods: each validation's val PSNR and the valid points logged
    at that iteration (``_scalar``), the windows called, captured and
    replayed, and the steps whose true key total exceeded the capacity they
    ran at or whose loss was not finite (``_get_step``, counted on the
    device and read once at the end), and the key-capacity refits
    (``_maybe_rebucket_key_cap``)."""

    def __init__(self, trainer):
        self.val_psnr = {}
        self.points = {}
        self.val_points = {}
        self.val_seconds = {}
        self.windows = self.captures = self.replays = self.steps = 0
        self.refits = []
        self.graphs_held = set()
        self.t0 = time.time()
        dev = trainer.device
        self._drops = torch.zeros((), dtype=torch.int64, device=dev)
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        scalar, get_step = trainer._scalar, trainer._get_step
        rebucket = trainer._maybe_rebucket_key_cap

        def watched_scalar(tag, value, iteration):
            if tag == "train/num_valid_points":
                self.points[iteration] = int(value)
            elif tag == "val/psnr":
                self.val_psnr[iteration] = float(value)
                self.val_points[iteration] = self.points.get(iteration)
                self.val_seconds[iteration] = time.time() - self.t0
                print(f"val PSNR @ {iteration}: {float(value):.3f} "
                      f"({self.val_points[iteration]} valid points, "
                      f"{self.val_seconds[iteration]:.1f} s)", flush=True)
            return scalar(tag, value, iteration)

        def watched_get_step(h, w, scan_steps=0):
            fn = get_step(h, w, scan_steps)

            def call(*a):
                cap = trainer._key_cap if trainer._capped else None
                captures = getattr(fn, "captures", 0)
                out = fn(*a)
                metrics = out[1]
                if scan_steps:
                    self.windows += 1
                    self.captures += fn.captures - captures
                    self.replays += fn.mode == "graph"
                    self.graphs_held.add(sum(
                        len(getattr(f, "graphs", {}))
                        for f in trainer._step_cache.values()))
                if cap is not None:
                    self._drops += (metrics["num_keys"] > cap).sum()
                self._nonfinite += (~torch.isfinite(metrics["loss"])).sum()
                self.steps += max(scan_steps, 1)
                return out
            return call

        def watched_rebucket(num_keys):
            before = trainer._key_cap
            grew = rebucket(num_keys)
            if trainer._key_cap != before:
                self.refits.append((before, trainer._key_cap, num_keys))
            return grew

        trainer._scalar = watched_scalar
        trainer._get_step = watched_get_step
        trainer._maybe_rebucket_key_cap = watched_rebucket

    def counts(self) -> dict:
        return {"steps_past_key_cap": int(self._drops),
                "nonfinite_losses": int(self._nonfinite)}


def train(trainer, iterations: int) -> dict:
    """Run ``trainer.train()`` under a ``Watch``; the run's record."""
    watch = Watch(trainer)
    t0 = time.time()
    state = trainer.train()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    dt = time.time() - t0
    return {"iterations": iterations, "seconds": dt,
            "it_per_s": iterations / dt,
            "steps_run": watch.steps,
            "final_valid_points": int(state.scene.num_valid()),
            "best_val_psnr": trainer.best_psnr_score,
            "val_psnr": watch.val_psnr, "val_points": watch.val_points,
            "val_seconds": watch.val_seconds,
            "windows": watch.windows, "captures": watch.captures,
            "replays": watch.replays, "refits": watch.refits,
            "graphs_held": sorted(watch.graphs_held),
            **watch.counts(), "state": state}


def print_record(rec: dict) -> None:
    """The run's lines; the last three are the JAX script's."""
    print(f"windows: {rec['windows']} called, {rec['captures']} graphs "
          f"captured, {rec['replays']} replays, graphs held after a window "
          f"{rec['graphs_held']}; key_cap refits (before, after, live keys):"
          f" {rec['refits']}")
    print(f"steps run: {rec['steps_run']}; steps with keys past key_cap: "
          f"{rec['steps_past_key_cap']}; non-finite losses: "
          f"{rec['nonfinite_losses']}")
    print(f"trained {rec['iterations']} iters in {rec['seconds']:.0f}s "
          f"({rec['it_per_s']:.1f} it/s)")
    print(f"final num_valid_points: {rec['final_valid_points']}")
    print(f"best val PSNR: {rec['best_val_psnr']:.3f}")


def main(argv=None, trainer_class=None) -> dict:
    """The gate: dataset, config, training; returns the run's record.
    ``trainer_class`` defaults to ``GaussianPointCloudTrainer``."""
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        from_dict,
    )

    args = parse_args(argv)
    data = make_dataset(args)
    write_dataset(args.out, data)
    if not data.have_dataset:
        print(f"dataset: {len(data.train)} train / {len(data.val)} val "
              f"views, {len(data.init_points)} init points", flush=True)
    if trainer_class is None:
        from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
            GaussianPointCloudTrainer as trainer_class,
        )
    trainer = trainer_class(from_dict(config_dict(args)), device=args.device)
    rec = train(trainer, args.iterations)
    print_record(rec)
    return rec


if __name__ == "__main__":
    main()
