"""Data-parallel training: the cameras of a batch spread over ranks.

Port of ``taichi_3d_gaussian_splatting_tpu/parallel/data_parallel.py``.
The JAX step runs one camera per device of a mesh inside ``shard_map``;
here each rank of the process group (``parallel/multihost.py``) runs its
own rows of the global batch through the single-device step's body
(``training.trainer.camera_pass``: the five kernels K1-K5), and:

- parameter gradients are summed over the rank's rows, all-reduced (SUM)
  and divided by the global batch size (the JAX ``pmean``);
- densification statistics are summed (``psum``): each camera adds its
  own, pre-average gradients to the controller's accumulators, as B
  sequential frames would;
- under ``pose_refinement`` every camera's pose row gets its own,
  un-averaged gradient; rows merge with one sum, and a duplicate index in
  one batch gives one combined update (the mean of its rows' gradients);
- Adam runs replicated, so parameters never need re-broadcasting: every
  rank applies the same reduced gradients to the same state, and the
  ranks' states stay bit-identical.

All of a step's reductions go out in three collectives: one SUM of a
packed f32 buffer, one MAX of a packed f64 buffer (the key total and the
nearest visible depth), and, under pose refinement, a second SUM. Without
a process group the step is a group of one and the rows are the whole
batch (``mh_smoke.single_process_reference`` runs it so).

Windows (``scan_steps``, the JAX step's ``lax.scan`` inside ``shard_map``):
k capped steps a call, each with its collectives, through the
single-device step's window machinery (``training.trainer.make_window``):
one CUDA graph a window with no process group or in an NCCL group of any
size, the steps in a loop over gloo and on the CPU. The capped step reads
no host value (the key total, the pose rows and their masked scatter stay
on the device).
"""
from __future__ import annotations

from typing import Optional

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    Camera,
    GradStats,
)
from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh
from taichi_3d_gaussian_splatting_tpu_torch.training import controller as ctrl
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from taichi_3d_gaussian_splatting_tpu_torch.training.loss import (
    psnr as psnr_fn,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
    POSE_B1,
    POSE_B2,
    POSE_EPS,
    TrainState,
    apply_grads,
    camera_pass,
    grad_factor_vector,
    make_optimizers,
    make_window,
    train_rasterizer_config,
)


def make_dp_train_step(config: TrainConfig, height: int, width: int,
                       device="cuda", scan_steps: int = 0,
                       key_cap: Optional[int] = None):
    """The data-parallel step for one (height, width) image size:
    ``step(state, images, qs, ts, Ks, sh_band, img_idx=None) -> (new_state,
    metrics, frame_stats)``. ``images`` (B_local, H, W, 3) uint8 or f32,
    ``qs`` (B_local, 4), ``ts`` (B_local, 3), ``Ks`` (B_local, 3, 3) are
    this rank's rows of the global batch (rank order: rank r holds rows
    [r * B_local, (r + 1) * B_local)); every rank passes the same B_local.
    Under ``pose_refinement``, ``img_idx`` holds each row's view index
    (host ints or a (B_local,) int64 device tensor; None: all -1). A row's
    pose is gathered on the device and its update masked, so a -1 row
    renders the pose as given through a zero delta, computes its pose
    cotangent and moves no row, as the JAX step does.

    With identical cameras on every row the step equals the single-device
    step; ``frame_stats`` follow the JAX step's: visibility-weighted means
    over the batch's cameras for the selection statistics, the MIN depth
    over visible cameras, and the display arrays (``pred``, ``depth_img``,
    ``count_img``, ``point_uv``, ``imggrad``) of global batch row 0 on rank
    0, the rank that logs (other ranks hold their own first row's).
    ``step.collectives`` lists the collectives of the last eager call (or
    of the capture: a graph replay runs no Python).

    ``key_cap``: None sizes each row's key buffers to its frame's exact
    total; an int is the static key capacity (``ops/tiling.py``), and the
    step then reads no host value: ``metrics["num_keys"]``, the largest
    true total over the batch's cameras, stays a device scalar.

    ``scan_steps`` k > 0 returns the JAX package's window instead:
    ``windowed(state, images (k, B_local, H, W, 3), qs (k, B_local, 4), ts
    (k, B_local, 3), Ks (k, B_local, 3, 3), sh_band, img_idxs (k, B_local)
    | None) -> (state, metrics stacked (k,), frame_stats of the last
    step)``: k capped steps (``key_cap``, else
    ``rasterisation_config.key_cap``), with their collectives, as
    ``training.trainer.make_train_step``'s window runs them. With no
    process group or in an NCCL group a window is one CUDA graph on a
    card, released by ``multihost.shutdown`` before the group goes; over
    gloo and on the CPU its steps run eagerly in order
    (``windowed.mode``)."""
    if scan_steps > 0 and key_cap is None:
        key_cap = config.rasterisation_config.key_cap
    rcfg = train_rasterizer_config(config)
    lcfg = config.loss_function_config
    optimizers = make_optimizers(config)
    dev = torch.device(device)
    gf = torch.from_numpy(grad_factor_vector(rcfg)).to(dev)
    pose_refine = config.pose_refinement

    def step(state: TrainState, images, qs, ts, Ks, sh_band, img_idx=None):
        scene = state.scene
        n = scene.capacity
        b_local = images.shape[0]
        batch = b_local * mh.world_size()
        log = []
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) * (1.0 / 255.0)

        d_xyz = d_features = num_keys = None
        contrib = ctrl.init_state(n, device=dev)
        vis_sum = torch.zeros(n, dtype=torch.float32, device=dev)
        npix_sum = torch.zeros_like(vis_sum)
        mag_sum = torch.zeros_like(vis_sum)
        tiles_sum = torch.zeros_like(vis_sum)
        guv_sum = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        depth_min = torch.full((n,), float("inf"), dtype=torch.float32,
                               device=dev)
        scalars = torch.zeros(4, dtype=torch.float32, device=dev)
        if pose_refine:
            pose_idx = (torch.full((b_local,), -1, dtype=torch.int64,
                                   device=dev) if img_idx is None
                        else torch.as_tensor(img_idx, dtype=torch.int64,
                                             device=dev).reshape(b_local))
            rows_i = torch.clamp_min(pose_idx, 0)
            d_rows = []
        first = None
        for r in range(b_local):
            camera = Camera(K=Ks[r], width=width, height=height)
            delta = None
            if pose_refine:
                row = state.pose_deltas.index_select(0, rows_i[r:r + 1])[0]
                delta = torch.where(pose_idx[r] >= 0, row,
                                    torch.zeros_like(row))
                delta.requires_grad_(True)
            cp = camera_pass(scene, images[r], qs[r], ts[r], camera, rcfg,
                             lcfg, gf, sh_band, delta, key_cap=key_cap)
            with torch.no_grad():
                st = cp.stats
                # per-CAMERA accumulator contribution (pre-average
                # gradients: each camera of the batch is one frame)
                contrib = ctrl.accumulate(
                    contrib, st.in_camera, st.num_affected_pixels,
                    st.magnitude_grad_viewspace, cp.d_xyz)
                if d_xyz is None:
                    d_xyz, d_features = cp.d_xyz, cp.d_features
                else:
                    d_xyz = d_xyz + cp.d_xyz
                    d_features = d_features + cp.d_features
                vis = st.in_camera.to(torch.float32)
                vis_sum = vis_sum + vis
                npix_sum = npix_sum + vis * st.num_affected_pixels
                mag_sum = mag_sum + vis * st.magnitude_grad_viewspace
                tiles_sum = tiles_sum + vis * st.num_overlap_tiles.to(
                    torch.float32)
                guv_sum = guv_sum + vis[:, None] * st.grad_uv
                depth_min = torch.minimum(depth_min, torch.where(
                    st.in_camera, cp.ctx.raw.depth,
                    torch.full_like(depth_min, float("inf"))))
                scalars = scalars + torch.stack([
                    cp.loss, cp.l1, cp.ssim, psnr_fn(cp.pred, images[r])])
                # the true total: a device scalar on the capped path, a
                # host int (already synced) on the exact one
                total = torch.as_tensor(cp.ctx.keys.total, device=dev)
                num_keys = (total if num_keys is None
                            else torch.maximum(num_keys, total))
                if pose_refine:
                    d_rows.append(cp.d_delta)
                if first is None:
                    first = cp
                del cp

        with torch.no_grad():
            # ---- collectives: one SUM, one MAX (and the pose SUM) ------
            sums = [d_xyz, d_features, *contrib, vis_sum, npix_sum,
                    mag_sum, tiles_sum, guv_sum, scalars]
            sums = mh.all_reduce_packed(sums, "sum", log=log)
            (d_xyz, d_features), contrib = sums[:2], sums[2:8]
            vis_c, npix_c, mag_c, tiles_c, guv_c, scalars = sums[8:]
            # the key total rides in the f64 MAX buffer (exact below 2^53)
            neg_depth, keys_t = mh.all_reduce_packed(
                [-depth_min, num_keys.to(torch.float64).reshape(1)], "max",
                dtype=torch.float64, log=log)
            depth_min = (-neg_depth).to(torch.float32)

            d_xyz = d_xyz / batch
            d_features = d_features / batch
            ctrl_state = ctrl.ControllerState(
                *(cur + c for cur, c in zip(state.ctrl, contrib)))

            pose = None
            if pose_refine:
                # each row's own (un-averaged) cotangent scattered to its
                # view's row; a -1 row adds nothing (masked, not branched).
                # One row an add, in batch order: rows that share a view
                # sum in a fixed order (one index_add_ of all rows would
                # add them with atomics, in no fixed order, on a card)
                on = pose_idx >= 0
                n_img = state.pose_deltas.shape[0]
                g_rows = torch.zeros((n_img, 6), dtype=torch.float32,
                                     device=dev)
                touch = torch.zeros((n_img,), dtype=torch.float32,
                                    device=dev)
                for r, d in enumerate(d_rows):
                    at = rows_i[r:r + 1]
                    g_rows.index_add_(0, at, torch.where(
                        on[r], d, torch.zeros_like(d))[None])
                    touch.index_add_(0, at, on[r:r + 1].to(torch.float32))
                g_rows, touch = mh.all_reduce_packed(
                    [g_rows, touch], "sum", log=log)
                # an image index can land on several rows of one batch (a
                # small dataset's epoch boundary mid-batch): the one Adam
                # step of that row sees the mean of its rows' gradients
                g_rows = g_rows / torch.clamp_min(touch, 1.0)[:, None]
                touched = touch > 0
                po = state.pose_opt
                mu2 = POSE_B1 * po["mu"] + (1.0 - POSE_B1) * g_rows
                nu2 = POSE_B2 * po["nu"] + (1.0 - POSE_B2) * g_rows * g_rows
                cnt2 = po["count"] + 1.0
                mu_hat = mu2 / (1.0 - torch.pow(POSE_B1, cnt2))[:, None]
                nu_hat = nu2 / (1.0 - torch.pow(POSE_B2, cnt2))[:, None]
                move = -config.pose_learning_rate * mu_hat / (
                    torch.sqrt(nu_hat) + POSE_EPS)
                tcol = touched[:, None]
                pose_opt = {
                    "mu": torch.where(tcol, mu2, po["mu"]),
                    "nu": torch.where(tcol, nu2, po["nu"]),
                    "count": torch.where(touched, cnt2, po["count"]),
                }
                pose = (torch.where(tcol, state.pose_deltas + move,
                                    state.pose_deltas), pose_opt)

            mean = scalars / batch
            metrics = {"loss": mean[0], "l1": mean[1], "ssim": mean[2],
                       "psnr": mean[3],
                       "num_keys": keys_t[0].to(torch.int64)}
            # selection statistics: the visibility-weighted MEAN over the
            # batch's cameras (identical cameras give the single-camera
            # frame's stats); depth: the MIN over visible cameras
            safe = torch.clamp_min(vis_c, 1.0)
            frame_stats = {
                "in_camera": vis_c > 0,
                "num_affected_pixels": npix_c / safe,
                "magnitude_grad_viewspace": mag_c / safe,
                "grad_uv": guv_c / safe[:, None],
                "num_overlap_tiles": torch.round(tiles_c / safe).to(
                    torch.int32),
                "point_depth": depth_min,
                "point_uv": first.ctx.raw.uv,
                "pred": first.pred,
                "depth_img": first.out.depth,
                "count_img": first.out.count,
                "imggrad": first.stats.magnitude_grad_viewspace_on_image,
                "grad_features": d_features,
                "grad_xyz": d_xyz,
            }
        step.collectives = log
        new_state = apply_grads(state, optimizers, d_xyz, d_features,
                                ctrl_state, pose)
        return new_state, metrics, frame_stats

    step.collectives = []
    if scan_steps <= 0:
        return step
    return make_window(step, scan_steps, dev, pose_refine)


def frame_stats_aux(frame_stats: dict) -> dict:
    """The trainer's aux dict (the single-device step's keys) from a
    data-parallel step's ``frame_stats``."""
    fs = frame_stats
    return {
        "pred": fs["pred"], "depth": fs["depth_img"],
        "count": fs["count_img"], "point_uv": fs["point_uv"],
        "point_depth": fs["point_depth"],
        "grad_features": fs["grad_features"], "grad_xyz": fs["grad_xyz"],
        "stats": GradStats(
            grad_uv=fs["grad_uv"],
            magnitude_grad_viewspace=fs["magnitude_grad_viewspace"],
            num_affected_pixels=fs["num_affected_pixels"],
            num_overlap_tiles=fs["num_overlap_tiles"],
            in_camera=fs["in_camera"],
            magnitude_grad_viewspace_on_image=fs["imggrad"]),
    }


def shard_batch(*arrays, local_count: int = 1, device="cuda"):
    """This rank's rows of global (B, ...) batches, as tensors on
    ``device``: rows [offset, offset + local_count) of each leading axis
    (the JAX ``shard_batch``: the rows a mesh position holds; each rank
    loads only its own)."""
    start = mh.local_batch_offset(local_count)
    return tuple(torch.as_tensor(a[start:start + local_count]).to(device)
                 for a in arrays)
