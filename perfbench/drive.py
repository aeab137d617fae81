"""The traffic kinds, driven through the program's own entry points.

``TrainDriver`` (traffic ``"kind": "train"``): ``make_train_step`` with
``scan_steps`` k = ``steps_per_call``, the windowed step at a fitted key
capacity (``fit_key_cap`` of the worst view's key total), one CUDA graph
replay a call on a card. Its k uint8 images are staged once in set-up by
``GaussianPointCloudTrainer._window_tensors`` and stay on the card: the
window measures the device-bound step, not the host staging that
``train()`` adds before every window (PERF.md says why no cell holds
that yet).

``RenderDriver`` (``"kind": "render"``): ``GaussianPointRenderer.render``
at the capacity it fits (one graph replay a frame on a card) over the
seeded pose path, cycled, each frame rounded to uint8 and copied to the
host by the renderer's ``_to_frame``.

Each driver: ``setup`` (inputs from the seed, the program's set-up, the
first steps or frames; ``phases`` its seconds by part, ``reference_s`` the
part the plain reference took to make inputs, which ``setup_s`` leaves
out), ``window`` (the measured loop), ``stage_frames`` (eager frames for
the stage metrics), ``check`` (frees the program's state, then the plain
reference: the numbers that decide ``correct``), ``work_parts`` (the work
of a step or frame, counted from the cell's inputs) and ``reads_as`` (the
kind the per-layer readers take it for: ``"train"`` or ``"render"``). A
driver of a cell on several ranks (``ranks.py``) also takes ``calls`` in
``window`` and gives ``state_leaves``.

A traffic kind that is not in ``DRIVERS`` is the class ``Driver`` of
``drivers/<kind>.py`` (``driver_class``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import time
import types
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import inputs, work
from perfbench.reference import splat
from perfbench.reference import step as ref_step

LEAVES = {  # name -> (parameter, feature columns); None: every column
    "xyz": ("xyz", None),
    "rotation": ("features", list(range(0, 4))),
    "scale": ("features", list(range(4, 7))),
    "opacity": ("features", [7]),
    "color_dc": ("features", [8, 24, 40]),
    "color_sh": ("features", [c for c in range(8, 56)
                              if c not in (8, 24, 40)]),
}
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: its change is not compared
NOUGHT_GRADIENT = 1e-3


@dataclass
class Window:
    attempted: int
    failed: int
    wall_s: float
    latencies_ms: list = field(default_factory=list)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _phase(phases: dict, name: str):
    """Adds the seconds of the body to ``phases[name]``."""
    t = time.perf_counter()
    try:
        yield
    finally:
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t


def _view(pose: np.ndarray, K: np.ndarray, views: dict, dev) -> splat.View:
    return splat.View(torch.as_tensor(pose, device=dev),
                      torch.as_tensor(K, device=dev), views["width"],
                      views["height"])


def leaf_norms(xyz: torch.Tensor, feats: torch.Tensor) -> dict:
    """{leaf: float64 norm} of a pair of per-point tensors."""
    out = {}
    for name, (which, cols) in LEAVES.items():
        t = xyz if which == "xyz" else feats[:, cols]
        out[name] = float(torch.linalg.vector_norm(t.double()))
    return out


def norm_gap(got: dict, want: dict, leaves=None) -> float:
    """The worst leaf's |norm(got) - norm(want)| over the larger of
    norm(want) and the median leaf's norm(want)."""
    leaves = list(want) if leaves is None else leaves
    med = float(np.median([want[k] for k in want]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in leaves)


def moved_leaves(grads: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    med = float(np.median(list(grads.values())))
    return [k for k, v in grads.items() if v >= NOUGHT_GRADIENT * med]


class TrainDriver:
    reads_as = "train"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.k = int(cell.traffic["steps_per_call"])
        if self.k < 2:
            raise ValueError("steps_per_call: a window of 2 steps or more")
        self.band = int(cell.traffic["sh_band"])
        self.reference_s = 0.0
        self.phases = {}  # seconds of set-up by part
        v = cell.views
        self.h, self.w = v["height"], v["width"]
        self.K = inputs.intrinsics(self.w, self.h, v["focal_px"])
        self.poses = inputs.poses(self.k, seed)  # a view a step of a window

    # -- inputs ---------------------------------------------------------------

    def scene(self):
        return inputs.truck_scene(self.cell.config["points"],
                                  inputs.sub_seeds(self.seed, 2)[0], self.dev)

    def ref_cfg(self) -> dict:
        tr = self.cell.config["train"]
        cfg = {k: v for k, v in tr.items() if not isinstance(v, dict)}
        cfg.update(tr["rasterisation_config"])
        cfg.update(tr["loss_function_config"])
        return cfg

    def targets(self) -> np.ndarray:
        """(views, H, W, 3) uint8: the reference's render of a second
        seeded scene at the views, quantized to 8 bits."""
        cfg = self.ref_cfg()
        xyz, feats = inputs.truck_scene(self.cell.config["points"],
                                        inputs.sub_seeds(self.seed, 2)[1],
                                        self.dev)
        out = []
        with splat.precision("f32"):
            for pose in self.poses:
                rgb = splat.render(xyz, feats, _view(pose, self.K,
                                                     self.cell.views,
                                                     self.dev),
                                   cfg["near_plane"], cfg["far_plane"],
                                   cfg["depth_to_sort_key_scale"],
                                   self.band, cfg["tile_size"])
                out.append(splat.to_uint8(rgb).cpu().numpy())
        return np.stack(out)

    # -- the program ------------------------------------------------------------

    def setup(self):
        from taichi_3d_gaussian_splatting_tpu_torch.data.camera import (
            CameraInfo,
        )
        from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import (
            DatasetItem,
        )
        from taichi_3d_gaussian_splatting_tpu_torch.models.scene import (
            GaussianScene,
        )
        from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer
        from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
        from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
            from_dict,
        )

        dev, ph = self.dev, self.phases
        with _phase(ph, "targets (reference)"):
            self.u8 = self.targets()
            _free(dev)
        self.reference_s = ph["targets (reference)"]
        if dev.type == "cuda":  # the peak is the program's, not the inputs'
            torch.cuda.reset_peak_memory_stats(dev)
        self.items = [
            DatasetItem(image=self.u8[i].astype(np.float32) / 255.0,
                        q_pointcloud_camera=inputs.quaternion_xyzw(p[:3, :3]),
                        t_pointcloud_camera=p[:3, 3].copy(),
                        camera_info=CameraInfo(self.K.copy(), self.h, self.w,
                                               0),
                        index=i)
            for i, p in enumerate(self.poses)]
        self.config = from_dict(self.cell.config["train"])
        with _phase(ph, "scene and state"):
            xyz, feats = self.scene()
            n = xyz.shape[0]
            scene = GaussianScene(
                xyz=xyz, features=feats,
                invalid=torch.zeros(n, dtype=torch.bool, device=dev),
                object_id=torch.zeros(n, dtype=torch.int32, device=dev))
            state = trainer.init_train_state(scene, self.config)
            _sync(dev)
        with _phase(ph, "capacity fit"):
            rcfg = trainer.train_rasterizer_config(self.config)
            camera = rasterizer.Camera(torch.as_tensor(self.K, device=dev),
                                       self.w, self.h)
            worst = 0
            for it in self.items:
                q = torch.as_tensor(it.q_pointcloud_camera, device=dev)
                t = torch.as_tensor(it.t_pointcloud_camera, device=dev)
                worst = max(worst, rasterizer.key_total(
                    xyz, feats, scene.invalid, q, t, camera, rcfg,
                    sh_max_band=self.band))
            self.key_cap = trainer.fit_key_cap(worst)
        self.run = trainer.make_train_step(
            self.config, self.h, self.w, scan_steps=self.k, device=dev,
            key_cap=self.key_cap)
        with _phase(ph, "staging"):
            feeder = types.SimpleNamespace(device=dev)
            self.inputs = trainer.GaussianPointCloudTrainer._window_tensors(
                feeder, self.items)
        with _phase(ph, "first call (warm-up, capture)"):
            # the window's first call: warm-up, capture and a replay of the
            # first k steps from the seed's state
            state, m, aux = self.run(state, *self.inputs, self.band)
            self.first = {
                "loss": m["loss"].double().cpu().numpy(),
                "grad": leaf_norms(aux["grad_xyz"], aux["grad_features"]),
                "xyz": state.scene.xyz.clone(),
                "features": state.scene.features.clone()}
            self.state = state
            _sync(dev)

    def window(self, seconds: float, calls=None) -> Window:
        """Window calls until ``seconds`` have passed, or ``calls`` of
        them."""
        dev, band = self.dev, self.band
        losses, n = [], 0
        state = self.state
        t0 = time.perf_counter()
        while True:
            with record_function("bench.window"):
                state, m, _ = self.run(state, *self.inputs, band)
            n += self.k
            losses.append(m["loss"].reshape(-1))
            if (n >= calls * self.k if calls is not None
                    else time.perf_counter() - t0 >= seconds):
                break
        _sync(dev)
        wall = time.perf_counter() - t0
        self.state = state
        bad = int((~torch.isfinite(torch.cat(losses))).sum())
        return Window(attempted=n, failed=bad, wall_s=wall)

    def stage_frames(self):
        return None

    # -- the reference -----------------------------------------------------------

    def check(self) -> dict:
        """Frees the program's state, then follows the first window's k
        steps with the plain reference and compares: ``loss_gap`` (the
        first step's relative loss gap; later steps carry round-off that
        Adam's first updates and depth-key order flips amplify, see
        PERF.md), ``grad_gap`` (worst leaf's gradient norm gap of the last
        step, as the optimizer took it) and ``change_gap`` (worst leaf's
        gap of the norm of the parameters' change over the steps)."""
        first = self.first
        self.state = self.run = self.inputs = self.first = None
        _free(self.dev)
        return self.reference_numbers(first, "f32")

    def reference_steps(self, precision: str) -> dict:
        """The reference's readings of the first window's k steps from the
        seed's state, in the shape of the program's (``first``):
        each step's loss, the compared gradient's leaf norms, and the
        parameters after the steps."""
        dev, cfg = self.dev, self.ref_cfg()
        xyz0, feats0 = self.scene()
        state = ref_step.init_state(xyz0, feats0)
        losses = []
        with splat.precision(precision):
            for i in range(self.k):
                out = ref_step.train_step(
                    state, self.target(i), _view(self.poses[i], self.K,
                                                 self.cell.views, dev), cfg,
                    self.band)
                losses.append(out.loss)
                state = out.state
            grad = leaf_norms(out.d_xyz, out.d_feats)
        return {"loss": np.asarray(losses), "grad": grad, "xyz": state.xyz,
                "features": state.feats}

    def reference_numbers(self, first: dict, precision: str) -> dict:
        want = self.reference_steps(precision)
        xyz0, feats0 = self.scene()
        gaps = np.abs(first["loss"] - want["loss"]) / np.abs(want["loss"])
        change_ref = leaf_norms(want["xyz"] - xyz0, want["features"] - feats0)
        change_got = leaf_norms(first["xyz"] - xyz0,
                                first["features"] - feats0)
        self.detail = {
            "loss_gaps": gaps.tolist(),
            "grad_gaps": {k: norm_gap(first["grad"], want["grad"], [k])
                          for k in LEAVES},
            "change_gaps": {k: norm_gap(change_got, change_ref, [k])
                            for k in LEAVES},
            "grad_ref": want["grad"], "change_ref": change_ref}
        return {"loss_gap": float(gaps[0]),
                "grad_gap": norm_gap(first["grad"], want["grad"]),
                "change_gap": norm_gap(change_got, change_ref,
                                       moved_leaves(want["grad"]))}

    def target(self, i: int) -> torch.Tensor:
        """The f32 target of view i as the window's feed makes it: the
        uint8 image scaled by 1/255 on the device."""
        return torch.from_numpy(self.u8[i]).to(self.dev).to(
            torch.float32) * (1.0 / 255.0)

    def work_counts(self) -> dict:
        """The mean work of a view's frame at the seed's state (pairs,
        included, live keys, key total)."""
        cfg = self.ref_cfg()
        xyz, feats = self.scene()
        total = {}
        with splat.precision("f32"):
            for pose in self.poses:
                splat.render(xyz, feats, _view(pose, self.K, self.cell.views,
                                               self.dev),
                             cfg["near_plane"], cfg["far_plane"],
                             cfg["depth_to_sort_key_scale"], self.band,
                             cfg["tile_size"], counts=total)
        return {k: v / len(self.poses) for k, v in total.items()}

    def work_parts(self) -> dict:
        """``work.step_parts`` of one step at the cell's mean view."""
        v = self.cell.views
        return work.step_parts(
            self.cell.config["points"], v["height"], v["width"],
            self.cell.config["train"]["rasterisation_config"]["tile_size"],
            self.work_counts())


class RenderDriver:
    reads_as = "render"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        v = cell.views
        self.h, self.w = v["height"], v["width"]
        self.K = inputs.intrinsics(self.w, self.h, v["focal_px"])
        self.n_poses = int(cell.traffic["poses"])
        self.poses = inputs.poses(self.n_poses, seed)
        self.rc = cell.config["render"]
        self.reference_s = 0.0
        self.phases = {}  # seconds of set-up by part

    def scene(self):
        return inputs.truck_scene(self.cell.config["points"],
                                  inputs.sub_seeds(self.seed, 2)[0], self.dev)

    def setup(self):
        from taichi_3d_gaussian_splatting_tpu_torch.apps import render as app
        from taichi_3d_gaussian_splatting_tpu_torch.models.scene import (
            GaussianScene,
        )
        from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
            se3_to_qt,
        )

        dev, ph = self.dev, self.phases
        with _phase(ph, "scene"):
            xyz, feats = self.scene()
            _sync(dev)
        n = xyz.shape[0]
        scene = GaussianScene(
            xyz=xyz, features=feats,
            invalid=torch.zeros(n, dtype=torch.bool, device=dev),
            object_id=torch.zeros(n, dtype=torch.int32, device=dev))

        class InMemoryRenderer(app.GaussianPointRenderer):
            """The renderer over a scene held in memory (its loader is
            handed the scene instead of reading a file)."""

            def __init__(self, config, poses, device):
                load = app.load_scene
                app.load_scene = lambda path, device: scene
                try:
                    super().__init__(config, poses, device=device)
                finally:
                    app.load_scene = load

        config = app.RendererConfig(parquet_paths=["<memory>"],
                                    image_height=self.h, image_width=self.w,
                                    camera_intrinsics=self.K.copy())
        with _phase(ph, "renderer (capacity fit)"):
            self.renderer = InMemoryRenderer(config, self.poses, dev)
        self.qs, self.ts = se3_to_qt(self.renderer.poses)
        r = self.renderer
        with _phase(ph, "first frames (warm-up, capture)"):
            for i in range(self.n_poses):  # the capture and every pose
                r._to_frame(r.render(self.qs[i], self.ts[i]))
            r.over_cap.zero_()
            _sync(dev)

    def window(self, seconds: float) -> Window:
        """Frames over the pose path until ``seconds`` have passed; each
        frame's latency is host time from handing its pose to the renderer
        to holding its uint8 array."""
        r, dev = self.renderer, self.dev
        self.last, lat, n = {}, [], 0
        clock = time.perf_counter
        t0 = clock()
        while True:
            i = n % self.n_poses
            t = clock()
            with record_function("bench.frame"):
                frame = r._to_frame(r.render(self.qs[i], self.ts[i]))
            done = clock()
            lat.append((done - t) * 1e3)
            self.last[i] = frame
            n += 1
            if done - t0 >= seconds:
                break
        _sync(dev)
        wall = clock() - t0
        return Window(attempted=n, failed=int(r.over_cap), wall_s=wall,
                      latencies_ms=lat)

    def stage_frames(self):
        """One eager frame a pose at the fitted capacity, in a profiler
        session: device ms a frame by the program's ``gs.*`` stage."""
        from perfbench import trace

        r = self.renderer
        r.render_capped(self.qs[0], self.ts[0])
        with trace.profiled() as held:
            for i in range(self.n_poses):
                r.render_capped(self.qs[i], self.ts[i])
        return trace.stage_ms(held.prof, self.n_poses)

    def check(self) -> dict:
        """Frees the renderer, then renders each pose's last frame of the
        window with the plain reference: ``frame_gap`` is the worst
        frame's mean |program - reference| in 8-bit levels."""
        last = self.last
        if self.renderer.graph is not None:
            self.renderer.graph.release()
        self.renderer = None
        _free(self.dev)
        return {"frame_gap": self.frame_gap(last, "f32")}

    def reference_frame(self, xyz, feats, i: int, counts=None):
        rc = self.rc
        rgb = splat.render(xyz, feats, _view(self.poses[i], self.K,
                                             self.cell.views, self.dev),
                           rc["near_plane"], rc["far_plane"],
                           rc["depth_to_sort_key_scale"], rc["sh_band"],
                           rc["tile_size"], counts)
        return splat.to_uint8(rgb).cpu().numpy()

    def frame_gap(self, frames: dict, precision: str) -> float:
        xyz, feats = self.scene()
        worst = 0.0
        with splat.precision(precision):
            for i, got in frames.items():
                want = self.reference_frame(xyz, feats, i)
                gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
                worst = max(worst, float(gap.mean()))
        return worst

    def work_counts(self) -> dict:
        xyz, feats = self.scene()
        total = {}
        with splat.precision("f32"):
            for i in range(self.n_poses):
                self.reference_frame(xyz, feats, i, total)
        return {k: v / self.n_poses for k, v in total.items()}

    def work_parts(self) -> dict:
        """``work.frame_parts`` of one frame at the cell's mean pose."""
        v = self.cell.views
        return work.frame_parts(self.cell.config["points"], v["height"],
                                v["width"], self.rc["tile_size"],
                                self.work_counts())


DRIVERS = {"train": TrainDriver, "render": RenderDriver}
DRIVER_FILES = Path(__file__).resolve().parent / "drivers"


def driver_class(kind: str):
    """The cell driver of the traffic ``kind``: ``DRIVERS[kind]``, else the
    class ``Driver`` of ``drivers/<kind>.py``."""
    if kind in DRIVERS:
        return DRIVERS[kind]
    path = DRIVER_FILES / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"no driver for the traffic kind {kind!r}: not in "
                         f"drive.DRIVERS and no {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_driver_" + kind.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver
