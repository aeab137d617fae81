"""Traffic ``"kind": "train-dp"``: the port's data-parallel windows, one
process a rank (``ranks.py`` starts them), each rank on a card of its own
in the port's process group (``parallel/multihost.py``).

Every rank builds ``parallel/data_parallel.py::make_dp_train_step`` with
``scan_steps`` k = ``steps_per_call`` at one key capacity
(``fit_key_cap`` of the largest key total of the poses, the same on every
rank) and ``views_per_rank`` v rows of the global batch: at step s, rank
r takes the views (s * ranks + r) * v + j, j < v, of ``inputs.poses(k *
ranks * v, seed)``. Its targets are staged once as f32, as the trainer's
data-parallel dispatch stages them (``_window_tensors(uint8=False)``),
and stay on the card; they are rank 0's render, broadcast to the other
ranks, so that every rank trains on the images the check reads. The
state starts from the seed's scene, rank 0's copy broadcast to every
rank (``multihost.broadcast_tree``, as ``train()`` does). In a process
group of NCCL a window is one CUDA graph with its collectives; over gloo
and on the CPU its steps run in a loop.

``check`` (rank 0, after the window): the plain reference follows the
first window's k steps from the seed's state, each step's gradient the
mean of its batch's views' (``reference/step.py::mean_step``). Besides
the one-card window's numbers (``loss_gap``: the first step's relative
gap of the batch's mean loss; the later steps' are in ``detail``):
``image_gap``, the mean |difference| in 8-bit levels of the last step's
image of rank 0's view (the program's ``pred``, clamped to [0, 1]) from
the reference's render at the reference's state before that step.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from perfbench import drive, inputs, work
from perfbench.reference import splat
from perfbench.reference import step as ref_step


def tensor_leaves(tree) -> list:
    """The tensors of a state (NamedTuples, tuples, lists, dicts), in a
    fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


class Driver(drive.TrainDriver):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.ranks = int(cell.traffic["ranks"])
        self.v = int(cell.traffic["views_per_rank"])
        self.poses = inputs.poses(self.k * self.ranks * self.v, seed)

    def step_views(self, s: int) -> list:
        """The views of step s's global batch, in rank order."""
        b = self.ranks * self.v
        return list(range(s * b, (s + 1) * b))

    def rank_views(self, rank: int) -> list:
        """The views rank ``rank`` trains on, step by step."""
        return [(s * self.ranks + rank) * self.v + j
                for s in range(self.k) for j in range(self.v)]

    def setup(self):
        import torch.distributed as dist

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
        from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
            multihost as mh,
        )
        from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (  # noqa: E501
            make_dp_train_step,
        )
        from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
        from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
            from_dict,
        )

        dev, ph = self.dev, self.phases
        rank = mh.rank()
        if mh.world_size() != self.ranks:
            raise ValueError(f"the traffic asks for {self.ranks} ranks, the "
                             f"process group has {mh.world_size()}")
        mine = self.rank_views(rank)
        shape = (len(self.poses), self.h, self.w, 3)
        with drive._phase(ph, "targets (reference)"):
            if rank == 0:
                u8 = torch.from_numpy(self.targets()).to(dev)
            drive._free(dev)
        self.reference_s = ph["targets (reference)"]
        with drive._phase(ph, "targets to the ranks"):
            # rank 0's render, the one the check reads, is every rank's
            if rank != 0:
                u8 = torch.empty(shape, dtype=torch.uint8, device=dev)
            if dist.is_initialized():
                dist.broadcast(u8, 0)
            u8 = u8.cpu().numpy()
            self.u8 = {i: u8[i] for i in range(shape[0])}
        if dev.type == "cuda":  # the peak is the program's, not the inputs'
            torch.cuda.reset_peak_memory_stats(dev)
        items = [
            DatasetItem(image=self.u8[i].astype(np.float32) / 255.0,
                        q_pointcloud_camera=inputs.quaternion_xyzw(
                            self.poses[i][:3, :3]),
                        t_pointcloud_camera=self.poses[i][:3, 3].copy(),
                        camera_info=CameraInfo(self.K.copy(), self.h, self.w,
                                               0),
                        index=i)
            for i in mine]
        self.config = from_dict(self.cell.config["train"])
        with drive._phase(ph, "scene and state"):
            xyz, feats = self.scene()
            n = xyz.shape[0]
            scene = GaussianScene(
                xyz=xyz, features=feats,
                invalid=torch.zeros(n, dtype=torch.bool, device=dev),
                object_id=torch.zeros(n, dtype=torch.int32, device=dev))
            state = mh.broadcast_tree(trainer.init_train_state(scene,
                                                               self.config))
            drive._sync(dev)
        with drive._phase(ph, "capacity fit"):
            rcfg = trainer.train_rasterizer_config(self.config)
            camera = rasterizer.Camera(torch.as_tensor(self.K, device=dev),
                                       self.w, self.h)
            s = state.scene
            worst = max(rasterizer.key_total(
                s.xyz, s.features, s.invalid,
                torch.as_tensor(it.q_pointcloud_camera, device=dev),
                torch.as_tensor(it.t_pointcloud_camera, device=dev), camera,
                rcfg, sh_max_band=self.band) for it in items)
            worst = torch.tensor([worst], dtype=torch.int64, device=dev)
            if dist.is_initialized():
                dist.all_reduce(worst, op=dist.ReduceOp.MAX)
            self.key_cap = trainer.fit_key_cap(int(worst))
        self.run = make_dp_train_step(
            self.config, self.h, self.w, device=dev, scan_steps=self.k,
            key_cap=self.key_cap)
        with drive._phase(ph, "staging"):
            feeder = types.SimpleNamespace(device=dev)
            rows = trainer.GaussianPointCloudTrainer._window_tensors(
                feeder, items, uint8=False)
            self.inputs = tuple(x.reshape(self.k, self.v, *x.shape[1:])
                                for x in rows)
        with drive._phase(ph, "first call (warm-up, capture)"):
            state, m, fs = self.run(state, *self.inputs, self.band)
            self.first = {
                "loss": m["loss"].double().cpu().numpy(),
                "grad": drive.leaf_norms(fs["grad_xyz"],
                                         fs["grad_features"]),
                "xyz": state.scene.xyz.clone(),
                "features": state.scene.features.clone(),
                "pred": fs["pred"].clone()}
            self.state = state
            drive._sync(dev)

    def state_leaves(self) -> list:
        """Every tensor of the program's state after the window."""
        return tensor_leaves(self.state)

    def target(self, i: int) -> torch.Tensor:
        """The f32 target of view i as the data-parallel feed stages it:
        the uint8 image over 255, divided on the host as the staged items
        are. (A card divides a tensor by a scalar as a product with its
        reciprocal, an ulp off in about half the values, which moves the
        loss by 3-7e-6 of itself.)"""
        return torch.from_numpy(
            self.u8[i].astype(np.float32) / 255.0).to(self.dev)

    def reference_steps(self, precision: str) -> dict:
        """The reference's readings of the first window's k data-parallel
        steps from the seed's state: each step's mean loss, the leaf norms
        of the last step's mean gradient, the parameters after the
        steps."""
        dev, cfg = self.dev, self.ref_cfg()
        xyz0, feats0 = self.scene()
        state = ref_step.init_state(xyz0, feats0)
        losses = []
        with splat.precision(precision):
            for s in range(self.k):
                views = self.step_views(s)
                if s == self.k - 1:  # the image the program's last step shows
                    self.ref_pred = torch.clamp(splat.render(
                        state.xyz, state.feats, drive._view(
                            self.poses[views[0]], self.K, self.cell.views,
                            dev), cfg["near_plane"], cfg["far_plane"],
                        cfg["depth_to_sort_key_scale"], self.band,
                        cfg["tile_size"]), 0.0, 1.0)
                out = ref_step.mean_step(
                    state, [self.target(i) for i in views],
                    [drive._view(self.poses[i], self.K, self.cell.views, dev)
                     for i in views], cfg, self.band)
                losses.append(out.loss)
                state = out.state
            grad = drive.leaf_norms(out.d_xyz, out.d_feats)
        return {"loss": np.asarray(losses), "grad": grad, "xyz": state.xyz,
                "features": state.feats, "pred": self.ref_pred}

    def reference_numbers(self, first: dict, precision: str) -> dict:
        numbers = super().reference_numbers(first, precision)
        numbers["image_gap"] = 255.0 * float(
            (first["pred"] - self.ref_pred).abs().mean())
        self.ref_pred = None
        return numbers

    def work_parts(self) -> dict:
        """One view's ``work.step_parts`` (a rank's share of a step) and
        the bytes the step reduces over the ranks (``collectives``)."""
        parts = super().work_parts()
        parts["collectives"] = (
            work.dp_collective_bytes(self.cell.config["points"]), 0)
        return parts
