"""Traffic ``"kind": "train-orbit"``: the one-card window of
``drive.TrainDriver`` (``make_train_step(..., scan_steps=k, key_cap=)``,
one CUDA graph replay a call, k uint8 views staged once and resident) on
an unbounded 360-degree scene: ``orbit.scene`` (a dense central object, a
ground disk, a background shell at 20-200 m) seen by the k level cameras
of ``orbit.poses``, evenly spaced on an inward orbit around the object.

The targets are the plain reference's render of a second seeded scene of
the same layout, in 8 bits. ``check`` is ``drive.TrainDriver``'s, and
adds ``image_median_gap``: the last step's image (the program's
``pred``, clamped to [0, 1]) against the reference's render of the same
view at the reference's state before that step, as the median over the
image's values of the |difference| in 8-bit levels. A render in TF32
moves the projected means and conics, and with them most values of the
image: this is the number the one step lower precision fails by, where
it hardly moves the loss and the norms. The median leaves out what both
orders of a tie give: the layout's dense object puts many splats in each
10-cm depth-key bucket, and a splat within an ulp of a bucket's edge
takes another place in the blend when the program's and the reference's
depths round apart, moving a few values by up to several levels
(``detail["image"]`` keeps the mean, the 99th percentile and the shares
of values over one and ten levels).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import drive, inputs, orbit
from perfbench.reference import splat
from perfbench.reference import step as ref_step


class Driver(drive.TrainDriver):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.poses = orbit.poses(self.k, seed)
        self.ref_pred = None

    def scene(self):
        return orbit.scene(self.cell.config["points"],
                           inputs.sub_seeds(self.seed, 2)[0], self.dev)

    def targets(self) -> np.ndarray:
        """(views, H, W, 3) uint8: the reference's render of a second
        seeded scene of the layout at the views, quantized to 8 bits."""
        cfg = self.ref_cfg()
        xyz, feats = orbit.scene(self.cell.config["points"],
                                 inputs.sub_seeds(self.seed, 2)[1], self.dev)
        out = []
        with splat.precision("f32"):
            for pose in self.poses:
                out.append(splat.to_uint8(self.render(xyz, feats, pose,
                                                      cfg)).cpu().numpy())
        return np.stack(out)

    def render(self, xyz, feats, pose, cfg) -> torch.Tensor:
        return splat.render(xyz, feats, drive._view(
            pose, self.K, self.cell.views, self.dev), cfg["near_plane"],
            cfg["far_plane"], cfg["depth_to_sort_key_scale"], self.band,
            cfg["tile_size"])

    def setup(self):
        """``drive.TrainDriver.setup``, keeping the first window's last
        image (its ``aux["pred"]``) beside its other readings."""
        from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

        make, kept = trainer.make_train_step, {}

        def make_keeping_pred(*a, **kw):
            run = make(*a, **kw)

            def first_call(*args):
                state, m, aux = run(*args)
                kept["pred"] = aux["pred"].clone()
                return state, m, aux
            kept["run"] = run
            return first_call
        trainer.make_train_step = make_keeping_pred
        try:
            super().setup()
        finally:
            trainer.make_train_step = make
        self.run = kept["run"]  # the timed calls go to the window itself
        self.first["pred"] = kept["pred"]

    def reference_steps(self, precision: str) -> dict:
        """``drive.TrainDriver.reference_steps``, with ``pred``: the
        reference's render of the last step's view at its state before
        that step, clamped to [0, 1]."""
        dev, cfg = self.dev, self.ref_cfg()
        xyz0, feats0 = self.scene()
        state = ref_step.init_state(xyz0, feats0)
        losses = []
        with splat.precision(precision):
            for i in range(self.k):
                if i == self.k - 1:
                    self.ref_pred = torch.clamp(self.render(
                        state.xyz, state.feats, self.poses[i], cfg), 0.0,
                        1.0)
                out = ref_step.train_step(
                    state, self.target(i), drive._view(
                        self.poses[i], self.K, self.cell.views, dev), cfg,
                    self.band)
                losses.append(out.loss)
                state = out.state
            grad = drive.leaf_norms(out.d_xyz, out.d_feats)
        return {"loss": np.asarray(losses), "grad": grad, "xyz": state.xyz,
                "features": state.feats, "pred": self.ref_pred}

    def reference_numbers(self, first: dict, precision: str) -> dict:
        numbers = super().reference_numbers(first, precision)
        self.detail["image"] = image_readings(first["pred"], self.ref_pred)
        numbers["image_median_gap"] = self.detail["image"]["median"]
        self.ref_pred = None
        return numbers


def image_readings(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Two images' |difference| in 8-bit levels, value by value: its
    median (``image_median_gap``), mean and 99th percentile, and the
    shares of values over one and over ten levels."""
    d = (255.0 * (got - want).abs()).reshape(-1).double()
    n = d.numel()
    return {"median": float(d.kthvalue(max(1, (n + 1) // 2)).values),
            "mean": float(d.mean()),
            "p99": float(d.kthvalue(max(1, int(0.99 * n))).values),
            "over_1": float((d > 1.0).double().mean()),
            "over_10": float((d > 10.0).double().mean())}
