"""Headless batch renderer: scene file + pose list -> PNG frames.

Port of ``taichi_3d_gaussian_splatting_tpu/apps/render.py``. Poses come
from a .pt file (torch.save'd N x 4 x 4 SE(3), camera->world) or from a
dataset .json, whose last item gives the image size and intrinsics;
``--gt_prefix`` also writes the dataset's ground-truth frames. Scenes are
.parquet files or graphdeco .ply files (the latter need no pandas).
``--portrait_mode`` flips the default landscape preset (.pt poses).

As the JAX renderer, the renderer first fits a static key capacity: it
reads the key total of every ``max(1, N // 8)``-th pose (one host sync
each, before any frame) and takes ``fit_key_cap(worst, headroom=1.15)``.
A frame is then ``rasterize(..., rgb_only=True, key_cap=...)``, with no
host sync; on a card it is one CUDA graph replay (``FrameGraph``, the
counterpart of the JAX renderer's one ``jax.jit``), captured at the first
frame. A pose whose keys pass the capacity loses the surplus keys, as in
JAX; such frames are counted on the device and reported once, after the
last frame. The band render (``--tile_parallel``) sizes its keys exactly.

``--data_parallel`` spreads the poses over the ranks of a process group
(rank r renders poses r, r + world, ...; each rank writes its own frames)
and ``--tile_parallel`` splits every frame into bands of 32-px tile rows,
one a rank (the height is padded up to a multiple of 32 * ranks and the
frame cropped back; rank 0 writes it). The group is ``torchrun``'s when
it launched the command; otherwise one local rank is spawned a visible
card. With one rank either flag is the plain loop.

    python -m taichi_3d_gaussian_splatting_tpu_torch.apps.render \\
        --parquet_path scene.ply --poses poses.pt --output_prefix frames
    python -m taichi_3d_gaussian_splatting_tpu_torch.apps.render \\
        --parquet_path scene.ply --poses val.json --output_prefix frames \\
        --gt_prefix gt
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
from taichi_3d_gaussian_splatting_tpu_torch.models.scene import (
    SceneConfig,
    merge_scenes,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import stages
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    Camera,
    RasterizerConfig,
    key_total,
    pin_f32_matmul,
    rasterize,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    quaternion_to_rotation_matrix,
    se3_to_qt,
)
from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh
from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
    capture_graph,
    fit_key_cap,
)

TILE = 32


@dataclass
class RendererConfig:
    """Image size and intrinsics of the renderer (the size is cropped down
    to whole tiles, top-left anchored, so K is unchanged)."""

    parquet_paths: List[str] = field(default_factory=list)
    image_height: int = 544
    image_width: int = 976
    camera_intrinsics: Optional[np.ndarray] = None
    rgb_only: bool = True
    data_parallel: bool = False
    tile_parallel: bool = False

    def __post_init__(self):
        if self.camera_intrinsics is None:
            self.camera_intrinsics = np.asarray(
                [[581.743, 0.0, 490.0], [0.0, 581.743, 273.0], [0.0, 0.0, 1.0]],
                np.float32,
            )

    def set_portrait_mode(self):
        self.image_height = 976
        self.image_width = 544
        self.camera_intrinsics = np.asarray(
            [[1163.486, 0.0, 273.0], [0.0, 1163.486, 490.0], [0.0, 0.0, 1.0]],
            np.float32,
        )


def load_scene(path: str, device) -> scene_lib.GaussianScene:
    """A .ply or .parquet scene file, unpadded."""
    config = SceneConfig(max_num_points_ratio=None)
    if str(path).endswith(".ply"):
        return scene_lib.from_ply(path, config, device=device)
    return scene_lib.from_parquet(path, config, device=device)


class FrameGraph:
    """``fn(*inputs)``, a frame of fixed shapes whose inputs and outputs
    are tensors (or a tuple of them), as one ``torch.cuda.CUDAGraph``.

    The inputs are copied into static buffers, and ``fn`` on them is
    captured by ``trainer.capture_graph`` (one eager warm-up under the
    sync-debug mode "error", then the capture; no host sync may be left
    in ``fn``). A call (``gs.replay``) copies its inputs into the buffers,
    replays, and returns clones of the outputs, which the next replay does
    not overwrite; ``stages`` is the capture's record, a unit a frame. In a
    process group the graph is tracked for
    ``multihost.shutdown`` to release, as a training window is."""

    def __init__(self, fn, inputs: tuple, dev: torch.device):
        self.inputs = tuple(x.detach().clone() for x in inputs)
        self.graph, self.out, self.capture_s, self.stages = capture_graph(
            lambda: fn(*self.inputs), dev)
        if mh.dist.is_initialized():
            mh.track_window(self)

    def __call__(self, *inputs):
        with stages.stage("gs.replay"):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            stages.replay(self.graph, self.stages)
            if isinstance(self.out, tuple):
                return tuple(x.clone() for x in self.out)
            return self.out.clone()

    def release(self) -> None:
        """Free the graph and its static buffers; a second call does
        nothing. The graph cannot replay afterwards."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.inputs = self.out = None
        mh.untrack_window(self)


class GaussianPointRenderer:
    """Renders every pose of a pose list with one scene, on one device or
    (``data_parallel`` / ``tile_parallel``) on the ranks of the process
    group, each on its own device (``multihost.rank_device``).

    ``key_cap`` is the fitted key capacity (``_fit_cap``); ``graph`` the
    one ``FrameGraph`` of ``render`` on a card, captured at the first
    frame with the ``rcfg`` and ``key_cap`` of that moment (``captures``
    counts captures); ``over_cap`` is the () int64 device count of frames
    whose keys passed the capacity."""

    def __init__(self, config: RendererConfig, poses: np.ndarray,
                 device="cuda"):
        self.config = config
        self.device = mh.rank_device(device)
        self.height = config.image_height - config.image_height % TILE
        self.width = config.image_width - config.image_width % TILE
        pin_f32_matmul()
        scenes = [load_scene(p, self.device) for p in config.parquet_paths]
        self.scene = merge_scenes(scenes) if len(scenes) > 1 else scenes[0]
        self.poses = torch.as_tensor(np.asarray(poses, np.float32),
                                     device=self.device)  # (N, 4, 4)
        self.camera = Camera(
            K=torch.as_tensor(np.asarray(config.camera_intrinsics, np.float32),
                              device=self.device),
            width=self.width, height=self.height)
        self.rcfg = RasterizerConfig(
            near_plane=0.8, far_plane=1000.0, depth_to_sort_key_scale=100.0,
            tile_size=TILE, rgb_only=config.rgb_only)
        self.key_cap = self._fit_cap()
        self.over_cap = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graph, self.captures = None, 0

    def _fit_cap(self) -> int:
        """The JAX renderer's ``_fit_cap``: the worst key total over every
        ``max(1, N // 8)``-th pose (each read to the host, before any
        frame), with 15% headroom, in ``fit_key_cap``'s buckets.
        ``candidate_mode`` and ``cand_scale`` steer the TPU kernels only:
        nothing of them is fitted here."""
        s = self.scene
        qs, ts = se3_to_qt(self.poses)
        stride = max(1, self.poses.shape[0] // 8)
        worst = max((key_total(s.xyz, s.features, s.invalid, qs[i], ts[i],
                               self.camera, self.rcfg,
                               point_object_id=s.object_id)
                     for i in range(0, self.poses.shape[0], stride)),
                    default=0)
        return fit_key_cap(worst, headroom=1.15)

    def render_capped(self, q: torch.Tensor, t: torch.Tensor):
        """The frame at the fitted capacity, with no host sync: ((H, W, 3)
        float image in [0, 1], () int64 1 if the pose's keys passed the
        capacity, else 0)."""
        s = self.scene
        out, total = rasterize(s.xyz, s.features, s.invalid, q, t,
                               self.camera, self.rcfg, sh_max_band=3,
                               point_object_id=s.object_id,
                               return_num_keys=True, key_cap=self.key_cap)
        return (torch.clamp(out.rgb, 0.0, 1.0),
                (total > self.key_cap).to(torch.int64))

    def render(self, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) float image in [0, 1] of the camera pose (q xyzw, t):
        ``render_capped`` as one graph replay on a card, eagerly
        elsewhere; a frame past the capacity adds one to ``over_cap``."""
        if self.device.type != "cuda":
            rgb, over = self.render_capped(q, t)
        else:
            if self.graph is None:
                self.graph = FrameGraph(self.render_capped, (q, t),
                                        self.device)
                self.captures += 1
            rgb, over = self.graph(q, t)
        self.over_cap += over
        return rgb

    def report_over_cap(self) -> int:
        """The frames so far whose keys passed the capacity (one host
        read), printed to stderr if there are any."""
        n = int(self.over_cap)
        if n:
            print(f"render: {n} frame(s) passed the key capacity "
                  f"{self.key_cap}; their surplus keys were dropped",
                  file=sys.stderr)
        return n

    @staticmethod
    def _to_frame(rgb: torch.Tensor) -> np.ndarray:
        with stages.stage("gs.to_frame"):
            return torch.round(rgb * 255).to(torch.uint8).cpu().numpy()

    def frames(self):
        """Yield (index, (H, W, 3) uint8 numpy frame) for every pose this
        rank owns: all of them on one rank; with ``data_parallel`` every
        world-th; with ``tile_parallel``, or with neither flag on several
        ranks, all of them on rank 0 and none elsewhere."""
        qs, ts = se3_to_qt(self.poses)
        world = mh.world_size()
        if self.config.data_parallel and world > 1:
            yield from self._frames_sharded(qs, ts, world)
        elif self.config.tile_parallel and world > 1:
            yield from self._frames_band_sharded(qs, ts, world)
        elif mh.is_main():
            yield from self._frames_plain(qs, ts)
        self.report_over_cap()

    def _frames_plain(self, qs, ts):
        for i in range(self.poses.shape[0]):
            yield i, self._to_frame(self.render(qs[i], ts[i]))

    def _frames_sharded(self, qs, ts, world: int):
        """Poses spread over the ranks: rank r renders poses r, r + world,
        ... (the JAX renderer's pose-sharded mesh order)."""
        for i in range(mh.rank(), self.poses.shape[0], world):
            yield i, self._to_frame(self.render(qs[i], ts[i]))

    def _frames_band_sharded(self, qs, ts, world: int):
        """Each frame's tile rows split over the ranks (large single
        images; ``parallel/tile_parallel.py``, which renders up to the next
        multiple of 32 x ranks rows and crops back, so frames keep the
        requested size), gathered on every rank and yielded on rank 0.
        The bands size their keys exactly, eagerly."""
        from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (  # noqa: E501
            rasterize_band_sharded,
        )

        # at most one 32-px tile row a band: a short image takes fewer
        # ranks (or the plain loop for a single band)
        n_bands = min(world, self.height // TILE)
        group = None
        if n_bands < world:
            # every rank takes part in forming the subgroup
            group = mh.dist.new_group(list(range(max(n_bands, 1))))
        if n_bands < 2:
            if mh.is_main():
                yield from self._frames_plain(qs, ts)
            return
        if mh.rank() >= n_bands:
            return
        s = self.scene
        for i in range(self.poses.shape[0]):
            out = rasterize_band_sharded(
                s.xyz, s.features, s.invalid, qs[i], ts[i], self.camera,
                self.rcfg, group=group, sh_max_band=3,
                point_object_id=s.object_id)
            if mh.is_main():
                yield i, self._to_frame(torch.clamp(out.rgb, 0.0, 1.0))

    def run(self, output_prefix: Path):
        from PIL import Image

        for i, frame in self.frames():
            Image.fromarray(frame, "RGB").save(
                Path(output_prefix) / f"frame_{i:03}.png")


def load_poses_pt(path: str) -> np.ndarray:
    """Load an (N, 4, 4) pose tensor saved with torch.save."""
    return torch.load(path, map_location="cpu",
                      weights_only=True).numpy().astype(np.float32)


def poses_from_dataset(json_path: str, gt_prefix: Optional[Path] = None):
    """(N, 4, 4) poses and the last item's CameraInfo (its intrinsics
    rescaled to the decoded image) of a dataset .json. Only the last item
    is decoded, unless ``gt_prefix`` is given: then every item is, and its
    frame is written there as ``frame_{idx:03}.png``."""
    from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import (
        ImagePoseDataset,
    )

    ds = ImagePoseDataset(json_path, tile_size=TILE)
    cameras = np.zeros((len(ds), 4, 4), np.float32)
    info = None
    for idx in range(len(ds)):
        if gt_prefix is None and idx < len(ds) - 1:
            # the pose straight from the record: decoding every frame
            # would add minutes of I/O on a long dataset
            cameras[idx] = np.asarray(
                ds.records[idx]["T_pointcloud_camera"], np.float32
            ).reshape(4, 4)
            continue
        item = ds[idx]
        cameras[idx, :3, :3] = quaternion_to_rotation_matrix(
            torch.from_numpy(item.q_pointcloud_camera)).numpy()
        cameras[idx, :3, 3] = item.t_pointcloud_camera
        cameras[idx, 3, 3] = 1.0
        if gt_prefix is not None:
            from PIL import Image

            Image.fromarray(
                np.round(item.image * 255).astype(np.uint8), "RGB"
            ).save(Path(gt_prefix) / f"frame_{idx:03}.png")
        info = item.camera_info
    return cameras, info


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--parquet_path", type=str, required=True, nargs="+",
                        help="scene files (.parquet or graphdeco .ply)")
    parser.add_argument("--poses", type=str, required=True,
                        help=".pt (torch.save'd N x 4 x 4 camera->world) or "
                        "dataset .json")
    parser.add_argument("--output_prefix", type=str, required=True)
    parser.add_argument("--gt_prefix", type=str, default="",
                        help="with .json poses, also write the dataset's "
                        "frames here")
    parser.add_argument("--portrait_mode", action="store_true", default=False)
    parser.add_argument("--data_parallel", action="store_true", default=False,
                        help="spread the poses over the ranks")
    parser.add_argument("--tile_parallel", action="store_true", default=False,
                        help="split each frame into bands, one a rank")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions "
                        "of the kernels")
    args = parser.parse_args(argv)

    if not args.poses.endswith((".pt", ".json")):
        raise ValueError(f"Unrecognized poses file format: {args.poses}, "
                         "must be .pt or .json")
    output_prefix = Path(args.output_prefix)
    os.makedirs(output_prefix, exist_ok=True)
    gt_prefix = None
    if args.gt_prefix:
        gt_prefix = Path(args.gt_prefix)
        os.makedirs(gt_prefix, exist_ok=True)
    config = RendererConfig(parquet_paths=list(args.parquet_path),
                            data_parallel=args.data_parallel,
                            tile_parallel=args.tile_parallel)
    if args.poses.endswith(".pt"):
        poses = load_poses_pt(args.poses)
        if args.portrait_mode:
            config.set_portrait_mode()
    else:
        poses, info = poses_from_dataset(args.poses, gt_prefix)
        config.image_width = info.camera_width
        config.image_height = info.camera_height
        config.camera_intrinsics = info.camera_intrinsics
    if ((args.data_parallel or args.tile_parallel)
            and not mh.dist.is_initialized()):
        if mh.launched_by_torchrun():
            mh.initialize(device=args.device)
        elif (torch.device(args.device).type == "cuda"
              and torch.cuda.device_count() > 1):
            mh.run_local_ranks(render_rank, torch.cuda.device_count(),
                               args=(config, poses, output_prefix,
                                     args.device), device=args.device)
            return
    render_rank(config, poses, output_prefix, args.device)
    mh.shutdown()


def render_rank(config: RendererConfig, poses: np.ndarray,
                output_prefix: Path, device) -> None:
    """Render and write this rank's frames (the whole list on one rank)."""
    GaussianPointRenderer(config, poses, device=device).run(output_prefix)


if __name__ == "__main__":
    main()
