"""Training: one step, windows of steps, the densify and eval steps, and
the training loop.

Port of ``taichi_3d_gaussian_splatting_tpu/training/trainer.py``; the
multi-device steps the loop drives are in ``parallel/``.

``make_train_step``: the step runs forward
(``rasterize_fwd_ctx``: attributes, tile keys, the blend kernel), the L1 +
SSIM loss, the backward (``rasterize_bwd``: the blend_backward kernel, the
segment_reduce kernel reading its sorted rows through the inverse key
permutation, the attributes' VJP: the kernel on a card, autograd on the
CPU and with pose refinement), the grad factors, one Adam on
the features and one on the positions (staircase-decayed learning rate;
both one launch of ``csrc/adam.cu`` on a card, ``adam_update``), and
``controller.accumulate``. It returns a new state and leaves its input as
it was. With ``pose_refinement`` the step also refines the camera pose of
the view it trains on: the pose is composed with that view's se(3) delta
(``TrainState.pose_deltas``), the rasterizer returns the pose cotangent,
and one exact Adam step moves that delta's row alone (its own count and
bias correction), as the JAX step does.

The key capacity. The single step sizes its key buffers to each frame's
exact total, which costs one host sync a step. With ``key_cap`` (the JAX
package's static capacity, ``RasterizerConfig.key_cap``) the buffers are
(key_cap,), the key total stays on the device and the step has no host
sync; keys past the capacity are dropped, as the JAX package drops them
(``ops/tiling.py``). ``fit_key_cap`` gives the capacity a key total
needs.

Windows. ``make_train_step(..., scan_steps=k)`` runs k capped steps a
call, the JAX package's ``lax.scan`` window (``make_window``, which the
data-parallel window shares). On a card the k steps are one
``torch.cuda.CUDAGraph``, captured after one eager warm-up and replayed
each call, so the state lives in the graph's static buffers between
windows, in an NCCL process group of any size too; on the CPU and over
gloo they run in a loop (``window_mode``).

Adam is optax's: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected,
the update added as ``p - lr * mu_hat / (sqrt(nu_hat) + eps)``. Its update
count, the learning rate's staircase and the pose row are device tensors,
so no host value of the step is baked into a captured graph. On a card
the kernel runs the formula as one pass over both leaves, rounded as the
plain formula (``Adam.update_plain``, the CPU path) rounds it there.

``GaussianPointCloudTrainer`` drives the steps: progressive downsample,
SH-band schedule, densify/prune after warm-up, alpha reset, validation
with scene exports and a full checkpoint, resume, and metrics to
TensorBoard (tensorboardX, when importable) and to the console as the
``key=value;`` lines a SageMaker-style scraper reads. With
``steps_per_dispatch`` k > 1 it runs windows of up to k capped steps between
the iterations that need host work (``_window_size``), on one device or on
the data-parallel ranks, starting from
``rasterisation_config.key_cap`` and refitting it every 100 iterations from
the live key total (``_maybe_rebucket_key_cap``). Validation keeps the
exact sizing: its frames are the JAX trainer's after its eval refit (which
re-renders a frame whose keys overflow), with no key dropped.
``candidate_mode`` and ``cand_scale`` only choose how the TPU builds the
same keys; they are accepted and have no effect here.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import (
    ImagePoseDataset,
    PrefetchLoader,
    downsample_item,
)
from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
from taichi_3d_gaussian_splatting_tpu_torch.models.scene import GaussianScene
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    Camera,
    RasterizerConfig,
    rasterize,
    rasterize_bwd,
    rasterize_fwd_ctx,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build, stages
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    apply_pose_delta,
    quaternion_to_rotation_matrix,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import controller as ctrl
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from taichi_3d_gaussian_splatting_tpu_torch.training.loss import (
    compute_loss,
    host_constant,
    psnr as psnr_fn,
    ssim as ssim_fn,
)


def grad_factor_vector(cfg: RasterizerConfig) -> np.ndarray:
    """Per-column feature-gradient scaling."""
    f = np.ones((56,), np.float32)
    f[0:4] = cfg.grad_q_factor
    f[4:7] = cfg.grad_s_factor
    f[7] = cfg.grad_alpha_factor
    f[8:] = cfg.grad_high_order_color_factor
    f[[8, 24, 40]] = cfg.grad_color_factor
    return f


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor  # () int64 on the device: updates applied so far
                         # (optax's count)


class TrainState(NamedTuple):
    """``pose_deltas`` ((num_train_images, 6) se(3): omega xyz, dt xyz) and
    ``pose_opt`` (``init_pose_opt``) are set only under
    ``config.pose_refinement``."""

    scene: GaussianScene
    feat_opt: AdamState
    pos_opt: AdamState
    ctrl: ctrl.ControllerState
    pose_deltas: Optional[torch.Tensor] = None
    pose_opt: Optional[dict] = None


def init_pose_opt(num_images: int, device="cuda") -> dict:
    """Per-row sparse-Adam state of the pose deltas: ``mu``, ``nu`` (each
    (num_images, 6)) and each row's update ``count`` ((num_images,) f32)."""
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=device)
    return {"mu": zeros(num_images, 6), "nu": zeros(num_images, 6),
            "count": zeros(num_images)}


# (b, device) -> Adam's bias corrections on that device (``_bias_table``)
_BIAS_TABLES: dict = {}


def _bias_table(b: float, device) -> torch.Tensor:
    """(C,) f32 ``1 - b**c`` for the counts c = 0 .. C - 1, where C - 1 is
    the first count at which it rounds to 1.0 (and it stays there: 165 for
    0.9, 17,321 for 0.999), copied to ``device`` once. Computed on the
    host with numpy's f32 scalar power, so a step on a card takes the
    same value as on the CPU (the card's own f32 power may differ by an
    ulp) and a captured graph reads it by the device count."""
    key = (float(b), str(device))
    table = _BIAS_TABLES.get(key)
    if table is None:
        one, bf = np.float32(1.0), np.float32(b)
        rows = [np.float32(0.0)]
        while rows[-1] != one:
            rows.append(one - bf ** np.float32(len(rows)))
        table = _BIAS_TABLES[key] = host_constant(
            np.asarray(rows, np.float32), device)
    return table


def _over(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``x / d`` for a () tensor ``d``, rounded as PyTorch rounds a division
    by a host scalar: a card multiplies by d's f32 reciprocal, the CPU
    divides. So the update equals, bit for bit, the one that takes its
    bias corrections as host floats (a step with a host count)."""
    return x * torch.reciprocal(d) if x.is_cuda else x / d


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam whose learning rate is ``lr0 * decay_rate ** (count //
    decay_interval)`` for the count of updates before this one
    (optax.exponential_decay with staircase=True), or ``lr0`` with no
    ``decay_interval``."""

    lr0: float
    decay_rate: float = 1.0
    decay_interval: int = 0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def lr(self, count):
        """The learning rate after ``count`` updates (an int or a () int64
        tensor, the step's device count): computed in f64, as a Python
        double computes it, and cast to f32; ``lr0`` with no
        ``decay_interval``."""
        if not self.decay_interval:
            return self.lr0
        steps = torch.div(torch.as_tensor(count), self.decay_interval,
                          rounding_mode="floor")
        return (self.lr0 * torch.pow(self.decay_rate,
                                     steps.to(torch.float64))).to(
                                         torch.float32)

    @staticmethod
    def bias_correction(b: float, count: torch.Tensor) -> torch.Tensor:
        """``1 - b**count`` in f32, as optax computes it (``_bias_table``),
        for a () int64 count on any device."""
        table = _bias_table(b, count.device)
        return table.index_select(
            0, torch.clamp_max(count, table.shape[0] - 1).reshape(1))[0]

    def init(self, param: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros_like(param), torch.zeros_like(param),
                         torch.zeros((), dtype=torch.int64,
                                     device=param.device))

    def update(self, grad: torch.Tensor, state: AdamState,
               param: torch.Tensor):
        """Returns (new param, new state): :func:`adam_update` of this one
        leaf (the kernel on a card, :meth:`update_plain` on the CPU)."""
        return adam_update(((self, grad, state, param),))[0]

    def update_plain(self, grad: torch.Tensor, state: AdamState,
                     param: torch.Tensor):
        """The plain formula of :meth:`update`: (new param, new state)."""
        count = state.count + 1
        mu = (1.0 - self.b1) * grad + self.b1 * state.mu
        nu = (1.0 - self.b2) * (grad * grad) + self.b2 * state.nu
        bc1 = self.bias_correction(self.b1, count)
        bc2 = self.bias_correction(self.b2, count)
        u = _over(mu, bc1) / (torch.sqrt(_over(nu, bc2)) + self.eps)
        new_param = param + (-self.lr(state.count)) * u
        return new_param, AdamState(mu, nu, count)



class _AdamLeaf(ctypes.Structure):
    """``AdamLeaf`` of ``csrc/adam.cu``: one leaf's streams, count, bias
    tables and rate, and the formula's f32 constants."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "grad", "param", "mu", "nu", "param_out", "mu_out", "nu_out",
        "count", "count_out", "bias1", "bias2", "lr")]
        + [(name, ctypes.c_longlong) for name in ("n", "vec4", "units")]
        + [("len1", ctypes.c_int), ("len2", ctypes.c_int)]
        + [(name, ctypes.c_float) for name in (
            "c1", "b1", "c2", "b2", "eps", "neg_lr")])


def _check_adam_leaf(grad, state: AdamState, param) -> None:
    """Raise on a leaf the kernel does not take: every stream f32,
    contiguous and of the parameter's shape and device; the count a ()
    int64 tensor there."""
    cuda_build.require(param, "param", torch.float32, param.dim())
    for name, t in (("grad", grad), ("mu", state.mu), ("nu", state.nu)):
        cuda_build.require(t, name, torch.float32, param.dim())
        if t.shape != param.shape or t.device != param.device:
            raise ValueError(f"{name}: need {tuple(param.shape)} on "
                             f"{param.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    count = state.count
    if (not isinstance(count, torch.Tensor) or count.dtype != torch.int64
            or count.dim() != 0 or count.device != param.device):
        raise ValueError(f"count: need a () int64 tensor on {param.device}")


def _adam_leaf(tx: Adam, grad, state: AdamState, param, outs) -> _AdamLeaf:
    """The kernel's description of one leaf, writing into ``outs`` (new
    param, mu, nu, count). Its f32 constants are the casts of the Python
    doubles :meth:`Adam.update_plain` multiplies by, as PyTorch casts a
    Python scalar for an f32 tensor; the rate is ``neg_lr`` where it is a
    host float, else read from its () device tensor."""
    lr = tx.lr(state.count)
    streams = (grad, param, state.mu, state.nu) + tuple(outs[:3])
    n = param.numel()
    vec4 = n // 4 if all(t.data_ptr() % 16 == 0 for t in streams) else 0
    bias1 = _bias_table(tx.b1, param.device)
    bias2 = _bias_table(tx.b2, param.device)
    f = np.float32
    leaf = _AdamLeaf(
        *(t.data_ptr() for t in streams), state.count.data_ptr(),
        outs[3].data_ptr(), bias1.data_ptr(), bias2.data_ptr(),
        lr.data_ptr() if isinstance(lr, torch.Tensor) else None,
        n, vec4, vec4 + (n - 4 * vec4), bias1.shape[0], bias2.shape[0],
        *(float(f(d)) for d in (1.0 - tx.b1, tx.b1, 1.0 - tx.b2, tx.b2,
                                tx.eps, -tx.lr0)))
    leaf.rate = lr  # read by pointer: alive until the launch is queued
    return leaf


def adam_update_plain(leaves) -> list:
    """Plain version of :func:`adam_update` (same contract)."""
    return [tx.update_plain(grad, state, param)
            for tx, grad, state, param in leaves]


def adam_update(leaves) -> list:
    """Adam's update of one or two leaves ``(adam, grad, state, param)``:
    [(new param, new state)] in their order, new tensors; the inputs are
    left as they were. The leaves are checked on either device. On a card
    one launch of ``adam_update_kernel`` (``csrc/adam.cu``) for all of
    them, equal to :meth:`Adam.update_plain` bit for bit, with no host
    sync; CPU tensors go to :func:`adam_update_plain`."""
    leaves = tuple(leaves)
    if not 1 <= len(leaves) <= 2:
        raise ValueError(f"adam_update takes 1 or 2 leaves, got {len(leaves)}")
    dev = leaves[0][3].device
    for _, grad, state, param in leaves:
        _check_adam_leaf(grad, state, param)
        if param.device != dev:
            raise ValueError("adam_update: leaves lie on different devices")
    if dev.type == "cpu":
        return adam_update_plain(leaves)
    out, descs = [], []
    for tx, grad, state, param in leaves:
        outs = [torch.empty_like(param) for _ in range(3)] + [
            torch.empty_like(state.count)]
        descs.append(_adam_leaf(tx, grad, state, param, outs))
        out.append((outs[0], AdamState(outs[1], outs[2], outs[3])))
    launch = cuda_build.bind("adam", "adam_update_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    array = (_AdamLeaf * len(descs))(*descs)
    err = launch(ctypes.addressof(array), len(descs),
                 cuda_build.stream_of(leaves[0][3]))
    adam_update.launches += 1
    cuda_build.check(err, "adam_update")
    return out


adam_update.launches = 0


def make_optimizers(config: TrainConfig):
    """(feature Adam, position Adam); the position learning rate decays by
    ``position_learning_rate_decay_rate`` every ``..._decay_interval``
    updates (optax.exponential_decay with staircase=True)."""
    return (Adam(config.feature_learning_rate),
            Adam(config.position_learning_rate,
                 config.position_learning_rate_decay_rate,
                 config.position_learning_rate_decay_interval))


def init_train_state(scene: GaussianScene, config: TrainConfig,
                     num_train_images: int = 0) -> TrainState:
    """A fresh state; under ``config.pose_refinement`` with zero pose deltas
    for ``num_train_images`` views."""
    feature_tx, position_tx = make_optimizers(config)
    dev = scene.xyz.device
    pose_deltas = pose_opt = None
    if config.pose_refinement:
        pose_deltas = torch.zeros((num_train_images, 6), dtype=torch.float32,
                                  device=dev)
        pose_opt = init_pose_opt(num_train_images, device=dev)
    return TrainState(
        scene=scene, feat_opt=feature_tx.init(scene.features),
        pos_opt=position_tx.init(scene.xyz),
        ctrl=ctrl.init_state(scene.capacity, device=dev),
        pose_deltas=pose_deltas, pose_opt=pose_opt)


# Adam of the pose deltas (the JAX step's constants)
POSE_B1, POSE_B2, POSE_EPS = 0.9, 0.999, 1e-8


def _pose_adam_row(state: TrainState, idx: torch.Tensor,
                   d_delta: torch.Tensor, lr: float):
    """One exact Adam step on row ``idx`` (a () int64 device index) of the
    pose deltas alone, with that row's own count and bias correction:
    (pose_deltas, pose_opt), new tensors. (A full-matrix Adam would decay
    every other view's momentum on each step.) Index -1 moves no row: the
    update is masked, as the JAX step's ``on = img_idx >= 0``, not
    branched on the host, so a captured graph holds both cases."""
    po = state.pose_opt
    on = idx >= 0
    row = torch.clamp_min(idx, 0).reshape(1)
    mu0, nu0, count0, delta0 = (
        t.index_select(0, row)[0]
        for t in (po["mu"], po["nu"], po["count"], state.pose_deltas))
    mu = POSE_B1 * mu0 + (1.0 - POSE_B1) * d_delta
    nu = POSE_B2 * nu0 + (1.0 - POSE_B2) * d_delta * d_delta
    count = count0 + 1.0
    mu_hat = mu / (1.0 - torch.pow(POSE_B1, count))
    nu_hat = nu / (1.0 - torch.pow(POSE_B2, count))
    move = -lr * mu_hat / (torch.sqrt(nu_hat) + POSE_EPS)

    def put(t, old, new):
        return t.index_copy(0, row, torch.where(on, new, old)[None])
    return put(state.pose_deltas, delta0, delta0 + move), {
        "mu": put(po["mu"], mu0, mu), "nu": put(po["nu"], nu0, nu),
        "count": put(po["count"], count0, count)}


class CameraPass(NamedTuple):
    """One camera's forward, loss and backward (``camera_pass``): the
    gradients already carry the grad factors and the regularizer, and are
    zero on invalid slots. ``d_delta``, ``d_q``, ``d_t`` are set when the
    pass refined the pose."""

    loss: torch.Tensor
    l1: torch.Tensor
    ssim: torch.Tensor
    pred: torch.Tensor
    out: object           # RasterizeOutput
    ctx: object           # RenderContext
    stats: object         # GradStats
    d_xyz: torch.Tensor
    d_features: torch.Tensor
    d_delta: Optional[torch.Tensor] = None
    d_q: Optional[torch.Tensor] = None
    d_t: Optional[torch.Tensor] = None


def camera_pass(scene: GaussianScene, image_gt, q, t, camera: Camera,
                rcfg: RasterizerConfig, lcfg, gf: torch.Tensor, sh_band,
                delta: Optional[torch.Tensor] = None,
                band=None, key_cap: Optional[int] = None) -> CameraPass:
    """Forward (``rasterize_fwd_ctx``), the L1 + SSIM loss and the backward
    (``rasterize_bwd``) of one camera, the single-device step's body and
    each data-parallel row's. ``image_gt`` is f32. With ``delta`` (an se(3)
    row) the pose is composed with it first (``apply_pose_delta``), and
    when ``delta`` requires grad its cotangent is returned. With ``band``
    (``parallel.tile_parallel.BandSplit``, no ``delta``) this rank renders
    and backpropagates its band of the image, the loss sees the full image,
    and the gradients and statistics are the full image's on every rank;
    ``ctx`` is the band's. ``key_cap`` selects the capped key buffers
    (``ops/tiling.py``)."""
    dev = scene.xyz.device
    invalid, cam_pass, cfg_pass = scene.invalid, camera, rcfg
    if band is not None:
        invalid, cam_pass, cfg_pass = band.invalid, band.camera, band.cfg
    xyz_in, feats_in = scene.xyz, scene.features
    refine = delta is not None and delta.requires_grad
    if delta is not None:
        with torch.set_grad_enabled(refine):
            q_used, t_used = apply_pose_delta(q, t, delta)
        # the pose cotangent sums over pool slots, so an invalid
        # (zero-padded) slot's NaN Jacobian would poison it: invalid
        # slots get inert inputs (identity quaternion, a point 1 m in
        # front of the camera). No key reaches them, so their values
        # never show.
        with torch.no_grad():
            inval = scene.invalid[:, None]
            # R(q) e_z + t, from the pose alone (no host tensor, so no
            # copy that would wait for the device)
            front = quaternion_to_rotation_matrix(q_used)[:, 2] + t_used
            safe_row = torch.zeros(56, dtype=torch.float32, device=dev)
            safe_row[3] = 1.0
            xyz_in = torch.where(inval, front[None, :], xyz_in)
            feats_in = torch.where(inval, safe_row[None, :], feats_in)
        q, t = q_used.detach(), t_used.detach()
    out, ctx, attrs_vjp = rasterize_fwd_ctx(
        xyz_in, feats_in, invalid, q, t, cam_pass, cfg_pass,
        sh_max_band=sh_band, point_object_id=scene.object_id,
        with_pose_grads=refine, key_cap=key_cap)
    if band is not None:
        out = band.gather(out)
    with stages.stage("gs.loss"):
        pred = torch.clamp(out.rgb, 0.0, 1.0)
        p = pred.detach().requires_grad_(True)
        f = scene.features.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, l1, ssim_v = compute_loss(p, image_gt, lcfg, features=f,
                                            invalid_mask=scene.invalid)
            d_pred, d_feat_reg = torch.autograd.grad(loss, (p, f),
                                                     allow_unused=True)
        if d_feat_reg is None:  # no regularizer
            d_feat_reg = torch.zeros_like(scene.features)
        with torch.no_grad():
            # the clamp's backward: zero where it was active, and at the
            # bounds (empty pixels sit at exactly 0)
            pass_mask = (out.rgb > 0.0) & (out.rgb < 1.0)
            d_rgb = torch.where(pass_mask, d_pred, torch.zeros_like(d_pred))
            if band is not None:
                d_rgb = band.rows(d_rgb)
    grads, stats = rasterize_bwd(ctx, attrs_vjp, d_rgb, cam_pass, cfg_pass)
    if band is not None:
        grads, stats = band.reduce(grads, stats, ctx.keys.total)
    d_xyz, d_features = grads[0], grads[1]
    d_delta = d_q = d_t = None
    if refine:
        d_q, d_t = grads[2], grads[3]
        (d_delta,) = torch.autograd.grad((q_used, t_used), delta, (d_q, d_t))
    with torch.no_grad(), stages.stage("gs.update"):
        # the grad factors: the first part of the update
        d_features = d_features * gf[None, :] + d_feat_reg
        # never move invalid slots
        valid = ~scene.invalid[:, None]
        d_xyz = torch.where(valid, d_xyz, torch.zeros_like(d_xyz))
        d_features = torch.where(valid, d_features,
                                 torch.zeros_like(d_features))
    return CameraPass(loss.detach(), l1.detach(), ssim_v.detach(), pred, out,
                      ctx, stats, d_xyz, d_features, d_delta, d_q, d_t)


def apply_grads(state: TrainState, optimizers, d_xyz: torch.Tensor,
                d_features: torch.Tensor, ctrl_state: ctrl.ControllerState,
                pose: Optional[tuple] = None) -> TrainState:
    """The next state of every train step: both Adam updates
    (``make_optimizers``) from the step's gradients, the controller's
    accumulators ``ctrl_state``, and ``pose`` ((pose_deltas, pose_opt)),
    else the state's own."""
    feature_tx, position_tx = optimizers
    scene = state.scene
    with torch.no_grad():
        (features, feat_opt), (xyz, pos_opt) = adam_update((
            (feature_tx, d_features, state.feat_opt, scene.features),
            (position_tx, d_xyz, state.pos_opt, scene.xyz)))
    pose_deltas, pose_opt = pose or (state.pose_deltas, state.pose_opt)
    return TrainState(
        scene=scene._replace(features=features, xyz=xyz), feat_opt=feat_opt,
        pos_opt=pos_opt, ctrl=ctrl_state, pose_deltas=pose_deltas,
        pose_opt=pose_opt)


# the JAX trainer's refusal of windows of band steps
TP_WINDOWS_REFUSAL = ("tile_parallel training runs one dispatch per step "
                      "(steps_per_dispatch must be 1)")


def train_rasterizer_config(config: TrainConfig) -> RasterizerConfig:
    """The rasterizer config of the train steps: ``train_slim`` blends rgb
    only (gradients and densify stats are unchanged)."""
    rcfg = config.rasterisation_config
    if config.train_slim and not rcfg.rgb_only:
        rcfg = dataclasses.replace(rcfg, slim=True)
    return rcfg


def make_train_step(config: TrainConfig, height: int, width: int,
                    scan_steps: int = 0, device="cuda",
                    split_bands: bool = False,
                    key_cap: Optional[int] = None):
    """The step for one (height, width) image size, on ``device``:
    ``step(state, image_gt, q, t, K, sh_band, img_idx=-1) -> (new_state,
    metrics, aux)``, with the (H, W, 3) ground truth in uint8 or f32 and the
    camera pose (q, t) in the world frame. Under ``pose_refinement``,
    ``img_idx`` (a host int or a () int64 device index) is the view's row
    of ``state.pose_deltas``: the row is gathered on the device and its
    update masked, so -1 (``pose_refinement_warm_up``) renders the pose as
    given through a zero delta, computes the pose cotangent and moves no
    row, as the JAX step does. ``split_bands`` makes the
    band-parallel step (``parallel.tile_parallel.make_tp_train_step``,
    which refuses pose refinement); ``step.collectives`` lists its last
    call's collectives.

    ``key_cap``: None sizes the key buffers to each frame's exact total;
    an int is the static key capacity (``ops/tiling.py``): no host sync,
    ``metrics["num_keys"]`` the true total as a device scalar.

    ``scan_steps`` k > 0 returns the JAX package's window instead:
    ``windowed(state, images, qs, ts, Ks, sh_band, img_idxs=None) ->
    (state, metrics, aux)`` runs k capped steps (``key_cap``, else
    ``rasterisation_config.key_cap``) on images (k, H, W, 3), qs (k, 4), ts
    (k, 3), Ks (k, 3, 3) and, under pose refinement, img_idxs (k,) (host
    ints or a device tensor; None: all -1). ``metrics`` are stacked (k,),
    ``aux`` is the last step's. On a card (``window_mode``) the k steps
    are one CUDA graph (``_CapturedWindow``) for the (sh_band, pool
    capacity, image dtype, pose rows) of the call; a call with another of
    these releases the graph and captures a new one (``windowed.captures``
    counts them). The returned state and aux are the graph's static
    buffers, which the next call of the window overwrites (a state
    returned by it may be passed back as it is; any other state, or any
    leaf of it, is copied in). On the CPU the steps run in a loop and the
    input state is left as it was."""
    if scan_steps > 0 and split_bands:
        raise ValueError(TP_WINDOWS_REFUSAL)
    if scan_steps > 0 and key_cap is None:
        key_cap = config.rasterisation_config.key_cap
    pose_refine = config.pose_refinement
    rcfg = train_rasterizer_config(config)
    lcfg = config.loss_function_config
    optimizers = make_optimizers(config)
    dev = torch.device(device)
    gf = torch.from_numpy(grad_factor_vector(rcfg)).to(dev)
    if split_bands:
        # imported here: tile_parallel imports this module
        from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
            multihost as mh,
            tile_parallel as tp,
        )
        band_h, cfg_band = tp.band_layout(height, rcfg, mh.world_size())

    def step(state: TrainState, image_gt, q, t, K, sh_band, img_idx=-1):
        scene = state.scene
        if scene.xyz.device.type != dev.type:
            raise ValueError(f"the step was made for {dev}, the state lies "
                             f"on {scene.xyz.device}")
        if image_gt.dtype == torch.uint8:
            image_gt = image_gt.to(torch.float32) * (1.0 / 255.0)
        camera = Camera(K=K, width=width, height=height)
        delta = pose_idx = None
        if pose_refine:
            pose_idx = (img_idx.reshape(())
                        if isinstance(img_idx, torch.Tensor)
                        else torch.full((), img_idx, dtype=torch.int64,
                                        device=dev))
            row = state.pose_deltas.index_select(
                0, torch.clamp_min(pose_idx, 0).reshape(1))[0]
            delta = torch.where(pose_idx >= 0, row, torch.zeros_like(row))
            delta.requires_grad_(True)
        band = None
        if split_bands:
            band = tp.BandSplit(scene, q, t, K, width, height, band_h,
                                cfg_band, rcfg)
        cp = camera_pass(scene, image_gt, q, t, camera, rcfg, lcfg, gf,
                         sh_band, delta, band, key_cap)
        with stages.stage("gs.update"):
            pose, pose_aux = None, {}
            if pose_refine:
                with torch.no_grad():
                    pose = _pose_adam_row(state, pose_idx, cp.d_delta,
                                          config.pose_learning_rate)
                pose_aux = {"grad_q": cp.d_q, "grad_t": cp.d_t,
                            "grad_pose": cp.d_delta}
            with torch.no_grad():
                ctrl_state = ctrl.accumulate(
                    state.ctrl, cp.stats.in_camera,
                    cp.stats.num_affected_pixels,
                    cp.stats.magnitude_grad_viewspace, cp.d_xyz)
                metrics = {
                    "loss": cp.loss, "l1": cp.l1, "ssim": cp.ssim,
                    "psnr": psnr_fn(cp.pred, image_gt),
                    "num_keys": (cp.ctx.keys.total if band is None
                                 else band.num_keys),
                }
            new_state = apply_grads(state, optimizers, cp.d_xyz,
                                    cp.d_features, ctrl_state, pose)
        aux = {
            "pred": cp.pred, "depth": cp.out.depth, "count": cp.out.count,
            "stats": cp.stats, "point_depth": cp.ctx.raw.depth,
            "point_uv": cp.ctx.raw.uv if band is None else band.uv,
            "grad_features": cp.d_features, "grad_xyz": cp.d_xyz, **pose_aux,
        }
        if band is not None:
            aux["band_keys"] = cp.ctx.keys.total
            step.collectives = band.log
        return new_state, metrics, aux

    step.collectives = []
    if scan_steps <= 0:
        return step
    return make_window(step, scan_steps, dev, pose_refine, counters=True)


def _tree_map(fn, *trees):
    """fn over the tensors of states (NamedTuples and dicts, the first
    tree's structure); None stays None."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, tuple):  # a NamedTuple
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    return fn(*trees)


def _copy_in(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a state leaf into its static buffer, unless it is that buffer
    (a state the window returned comes back as it is)."""
    if src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


def window_mode(dev: torch.device) -> str:
    """How a window of steps runs on ``dev``, decided here alone: "graph"
    (the k steps one ``torch.cuda.CUDAGraph``) on a card with no process
    group or in an NCCL group of any size; "eager" (the steps in a loop) on
    the CPU and over gloo, which copies CUDA buffers through the host,
    where no graph can follow. It reads only what every rank shares (the
    device type and the backend): a capture on one rank against a loop on
    another would deadlock."""
    import torch.distributed as dist

    if dev.type != "cuda":
        return "eager"
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return "eager"
    return "graph"


def capture_graph(run, dev: torch.device, collectives: bool = False,
                  counters: bool = False):
    """``run()`` (a callable of no arguments reading and writing only
    buffers it keeps at fixed addresses) as one ``torch.cuda.CUDAGraph``:
    (graph, what the captured ``run()`` returned, capture seconds, the
    capture's ``ops.stages.Record``: the device marks of its ``gs.*``
    stages, which ``stages.replay`` reads under a profiler).

    One eager ``run()`` comes first: it builds the kernels and runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so any host sync left in
    it raises here rather than breaking the capture. Then ``run()`` is
    captured once. A failed capture raises; there is no eager fallback.

    In a process group the capture is "thread_local": the group's
    watchdog thread queries the events of earlier collectives, which the
    default "global" mode forbids to every thread while a capture runs.
    With ``collectives`` (``run`` holds some) the communicator is warmed by
    one eager collective first, so every rank must capture together.
    With ``counters`` the capture records ``stages.count``'s counters
    (the one-card train window's tile counters)."""
    import torch.distributed as dist

    capture_mode = "global"
    if dist.is_initialized():
        if collectives:
            from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
                multihost as mh,
            )

            mh.warm_communicator(dev)
        capture_mode = "thread_local"
    torch.cuda.synchronize(dev)
    mode = torch.cuda.get_sync_debug_mode()
    with stages.capturing(counters) as record:
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()  # counts the stage marks of the capture
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        record.allocate(dev)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode=capture_mode):
            out = run()
    return graph, out, time.perf_counter() - t0, record


class _CapturedWindow:
    """A window of k steps as one ``torch.cuda.CUDAGraph``, for one
    (sh_band, pool capacity, image dtype, pose rows).

    It keeps static buffers for the window's inputs and for the state,
    and captures the steps on them (``capture_graph``: one eager warm-up
    under the sync-debug mode "error", then the capture), ending with
    copies of the new state into the static state (``gs.state_copy``), so
    each replay moves that state on by k steps in place. ``stages`` is the
    capture's record, a unit a step.

    In an NCCL process group (``window_mode``) the steps' collectives are
    captured with them. Such a window is tracked
    (``multihost.track_window``): ``multihost.shutdown`` releases it
    before the group goes. ``release`` frees the graph and its pool at
    once, wherever it is called."""

    def __init__(self, run, state: TrainState, inputs: tuple, sh_band,
                 counters: bool = False):
        import torch.distributed as dist

        dev = state.scene.xyz.device
        self.inputs = tuple(None if x is None else x.detach().clone()
                            for x in inputs)
        self.state = _tree_map(lambda x: x.detach().clone(), state)

        def steps():
            # the warm-up moves the static state on too: every call copies
            # the caller's state in before its replay
            new_state, metrics, aux = run(self.state, *self.inputs, sh_band)
            with stages.stage("gs.state_copy"):
                _tree_map(_copy_in, self.state, new_state)
            return metrics, aux

        (self.graph, (self.metrics, self.aux), self.capture_s,
         self.stages) = capture_graph(steps, dev, collectives=True,
                                      counters=counters)
        if dist.is_initialized():
            from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
                multihost as mh,
            )

            mh.track_window(self)

    def __call__(self, state: TrainState, inputs: tuple):
        with stages.stage("gs.replay"):
            for dst, src in zip(self.inputs, inputs):
                if dst is not None:
                    dst.copy_(src)
            _tree_map(_copy_in, self.state, state)
            stages.replay(self.graph, self.stages)
            # the metrics outlive the next replay (the trainer keeps losses)
            return (self.state,
                    {k: v.clone() for k, v in self.metrics.items()}, self.aux)

    def release(self) -> None:
        """Reset the graph and drop the static inputs, state, metrics and
        aux, so that the graph's private pool goes back to the allocator
        once no caller holds a returned tensor; a second call does
        nothing. The window cannot replay afterwards."""
        from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
            multihost as mh,
        )

        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.inputs = self.state = self.metrics = self.aux = None
        mh.untrack_window(self)


class _Window:
    """``make_window``'s window: ``window(state, images, qs, ts, Ks,
    sh_band, img_idxs=None)``. ``mode`` ("graph" or "eager", settable) is
    ``window_mode``'s; ``graphs`` holds the one ``_CapturedWindow`` of the
    last call's (sh_band, capacity, dtype, pose rows), ``captures`` counts
    them; a call after the graph was released captures it anew. Nothing in
    it refers back to the window, so a window dropped from a cache frees
    its graph at once, without the cyclic collector."""

    def __init__(self, step, k: int, dev: torch.device, pose_refine: bool,
                 counters: bool = False):
        self.step, self.k, self.dev = step, k, dev
        self.pose_refine = pose_refine
        self.counters = counters
        self.mode = window_mode(dev)
        self.graphs = {}
        self.captures = 0

    def run(self, state, images, qs, ts, Ks, idxs, sh_band):
        rows = []
        aux = None
        for i in range(self.k):
            stages.set_unit(i)
            extra = () if idxs is None else (idxs[i],)
            state, m, aux = self.step(state, images[i], qs[i], ts[i], Ks[i],
                                      sh_band, *extra)
            rows.append(m)
        return state, {name: torch.stack([m[name] for m in rows])
                       for name in rows[0]}, aux

    def __call__(self, state: TrainState, images, qs, ts, Ks, sh_band,
                 img_idxs=None):
        if images.shape[0] != self.k:
            raise ValueError(f"a window of {self.k} steps got "
                             f"{images.shape[0]} images")
        idxs = None
        if self.pose_refine:
            rows = images.shape[:-3]  # (k,) or (k, B_local)
            idxs = (torch.full(rows, -1, dtype=torch.int64, device=self.dev)
                    if img_idxs is None else torch.as_tensor(
                        img_idxs, dtype=torch.int64, device=self.dev).reshape(
                            rows))
        inputs = (images, qs, ts, Ks, idxs)
        if self.mode == "eager":
            return self.run(state, *inputs, sh_band)
        key = (int(sh_band), state.scene.capacity, images.dtype,
               None if idxs is None else state.pose_deltas.shape[0])
        graph = self.graphs.get(key)
        if graph is None or graph.graph is None:  # none yet, or released
            # one graph at a time: its pool, state and inputs go before
            # the next is captured (the trainer's SH band only grows); the
            # key is the same on every rank, so the ranks release together
            for old in self.graphs.values():
                old.release()
            self.graphs = {}
            graph = self.graphs[key] = _CapturedWindow(
                self.run, state, inputs, sh_band, counters=self.counters)
            self.captures += 1
        return graph(state, inputs)


def make_window(step, k: int, dev: torch.device, pose_refine: bool,
                counters: bool = False):
    """The window of k steps of ``step`` (a capped step: the single-device
    one of ``make_train_step`` or the data-parallel one of
    ``parallel.data_parallel.make_dp_train_step``):
    ``windowed(state, images, qs, ts, Ks, sh_band, img_idxs=None)``, each
    input stacked (k, ...) over the step's own, the pose indices (k,) or
    (k, B_local). ``windowed.mode`` is ``window_mode(dev)``. ``counters``:
    its graph records the tile counters (``stages.count``), as the
    single-device window's does."""
    return _Window(step, k, dev, pose_refine, counters)


def make_densify_step(config: TrainConfig):
    """(find, apply, alpha_reset): the selection of a densify round, its
    mutation (which also resets the controller's accumulators) and the
    alpha reset."""
    ccfg = config.adaptive_controller_config

    def find(scene, ctrl_state, stats, point_depth, remove_floaters: bool):
        return ctrl.find_densify(
            scene, ctrl_state, stats.in_camera, stats.num_affected_pixels,
            stats.magnitude_grad_viewspace, point_depth, remove_floaters,
            ccfg)

    def apply(scene, info, generator: torch.Generator):
        new_scene = ctrl.apply_densify(scene, info, generator, ccfg)
        return new_scene, ctrl.init_state(scene.capacity,
                                          device=scene.xyz.device)

    def alpha_reset(scene):
        return ctrl.reset_alpha(scene, ccfg)

    return find, apply, alpha_reset


def make_eval_step(config: TrainConfig, height: int, width: int):
    """``eval_step(scene, image_gt, q, t, K, sh_band) -> (metrics, pred,
    depth, count)``: one full-output render (no slim), its loss without the
    regularizer, PSNR, the SSIM score and the frame's key total."""
    rcfg = config.rasterisation_config

    @torch.no_grad()
    def eval_step(scene: GaussianScene, image_gt, q, t, K, sh_band):
        if image_gt.dtype == torch.uint8:
            image_gt = image_gt.to(torch.float32) * (1.0 / 255.0)
        camera = Camera(K=K, width=width, height=height)
        out, num_keys = rasterize(
            scene.xyz, scene.features, scene.invalid, q, t, camera, rcfg,
            sh_max_band=sh_band, point_object_id=scene.object_id,
            return_num_keys=True)
        pred = torch.clamp(out.rgb, 0.0, 1.0)
        loss, l1, ssim_v = compute_loss(pred, image_gt,
                                        config.loss_function_config)
        return {
            "loss": loss, "l1": l1, "ssim": ssim_v,
            "psnr": psnr_fn(pred, image_gt),
            "ssim_score": ssim_fn(pred, image_gt),
            "num_keys": num_keys,
        }, pred, out.depth, out.count

    return eval_step


def _np(x) -> np.ndarray:
    """A host numpy copy of a tensor (or an array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _refuse_combinations(config: TrainConfig) -> None:
    """Raise ValueError, with the JAX trainer's messages, for the
    combinations it refuses."""
    if config.tile_parallel_devices > 1:
        if (config.data_parallel_devices > 1 or config.multihost
                or config.pose_refinement):
            raise ValueError(
                "tile_parallel_devices composes with neither "
                "data_parallel/multihost (pick one scaling axis) nor "
                "pose_refinement")
        if config.steps_per_dispatch > 1:
            raise ValueError(TP_WINDOWS_REFUSAL)


def fit_key_cap(total_keys: int, minimum: int = 2 ** 15,
                headroom: float = 1.3) -> int:
    """The smallest capacity (m/8) 2^k (m in 8..15) at least
    ``total_keys * headroom`` (and ``minimum``): eighth-octave buckets, so
    a capacity overshoots its need by at most 12.5% and a doubling of the
    scene changes it at most eight times (each change captures new
    graphs). The JAX trainer's ``fit_key_cap``."""
    need = max(int(total_keys * headroom) + 1, minimum)
    base = minimum
    while base * 2 <= need:
        base *= 2
    step = base // 8
    return ((need + step - 1) // step) * step


def _join_parallel_group(config: TrainConfig, device) -> Optional[str]:
    """Join the process group a multi-device config runs in. Returns
    "dp" (data-parallel: ``data_parallel_devices`` > 1 or ``multihost``),
    "tp" (``tile_parallel_devices`` > 1) or None (one device).

    ``multihost`` joins the group its coordinator fields (or ``torchrun``'s
    environment) describe. ``data_parallel_devices`` /
    ``tile_parallel_devices`` N run one rank per device: ``apps/train.py``
    spawns the N local ranks, or ``torchrun`` starts them."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    if config.multihost:
        mh.initialize(config.coordinator_address, config.num_processes,
                      config.process_id, device=device)
        return "dp"
    n = max(config.data_parallel_devices, config.tile_parallel_devices)
    if n <= 1:
        return None
    if not mh.dist.is_initialized():
        if not mh.launched_by_torchrun():
            raise RuntimeError(
                f"{n} devices run one rank each: start the run with "
                "apps/train.py, which spawns the ranks, or with torchrun")
        mh.initialize(device=device)
    if mh.world_size() != n:
        raise RuntimeError(f"the config asks for {n} devices, the process "
                           f"group has {mh.world_size()} ranks")
    return "tp" if config.tile_parallel_devices > 1 else "dp"


class GaussianPointCloudTrainer:
    """The training loop (``device="cuda"`` by default; the tests pass
    ``"cpu"``, which runs the kernels' plain versions).

    On one device, or on N ranks of a process group: data-parallel
    (``data_parallel_devices`` N or ``multihost``; each rank trains its
    own cameras of every step's batch, ``parallel/data_parallel.py``) or
    band-parallel (``tile_parallel_devices`` N; each rank renders a band
    of every frame, ``parallel/tile_parallel.py``). Rank r drives
    ``cuda:{local_rank % device_count}``; the state stays replicated; the
    main rank alone writes scenes, checkpoints, TensorBoard and the
    console.

    Data loading and scene I/O go through ``_load_datasets``,
    ``_load_scene`` and ``_save_scene``, so a caller can substitute its own
    (e.g. in-memory views, or .ply files where pandas is missing)."""

    def __init__(self, config: TrainConfig, device="cuda"):
        from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
            multihost as mh,
        )

        _refuse_combinations(config)
        self.config = config
        self.parallel = _join_parallel_group(config, device)
        self.world = mh.world_size() if self.parallel else 1
        self.rank = mh.rank() if self.parallel else 0
        self.is_main = self.rank == 0
        self.device = mh.rank_device(device)
        os.makedirs(config.summary_writer_log_dir, exist_ok=True)
        self.output_model_dir = (config.output_model_dir
                                 or config.summary_writer_log_dir)
        os.makedirs(self.output_model_dir, exist_ok=True)
        self.writer = None
        if self.is_main:  # one writer and checkpoint owner per job
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(
                    log_dir=config.summary_writer_log_dir)
            except Exception:  # no tensorboardX: the console only
                self.writer = None
        self.train_dataset, self.val_dataset = self._load_datasets()
        self._mh_hw = None
        if config.multihost:
            # every rank must run the same shapes every step: resolution is
            # decided from metadata, identically everywhere
            self._mh_hw = mh.check_uniform_resolution(
                self.train_dataset.records,
                config.rasterisation_config.tile_size)
        self.scene = self._load_scene()
        self.best_psnr_score = 0.0
        # the windows' static key capacity (steps_per_dispatch > 1 only; the
        # single steps of steps_per_dispatch 1 size their keys exactly),
        # refit every 100 iterations from the live key total
        self._capped = config.steps_per_dispatch > 1
        self._key_cap = config.rasterisation_config.key_cap
        self._step_cache = {}
        self._eval_cache = {}
        self.densify_find, self.densify_apply, self.alpha_reset = (
            make_densify_step(config))
        # the densify draws; its state is checkpointed, so a resume goes on
        # with the stream instead of replaying it
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self._profiler = None

    # -- data and scene I/O ---------------------------------------------------

    def _load_datasets(self):
        """(train, val) datasets of ``ImagePoseDataset`` items."""
        config = self.config
        tile = config.rasterisation_config.tile_size
        return (ImagePoseDataset(config.train_dataset_json_path,
                                 tile_size=tile),
                ImagePoseDataset(config.val_dataset_json_path,
                                 tile_size=tile))

    def _load_scene(self) -> GaussianScene:
        config = self.config
        return scene_lib.from_parquet(
            config.pointcloud_parquet_path,
            config=config.gaussian_point_cloud_scene_config,
            seed=config.seed, device=self.device)

    def _save_scene(self, scene: GaussianScene, path: str) -> None:
        scene_lib.to_parquet(scene, path)

    # -- step caches (one per image size, key capacity and window) -----------

    def _get_step(self, h: int, w: int, scan_steps: int = 0):
        """The step (``scan_steps`` 0) or the window of ``scan_steps`` steps
        for one image size, single-device or data-parallel; capped at
        ``_key_cap`` under ``steps_per_dispatch`` > 1 (cached by (h, w,
        key_cap, scan_steps)), else sized exactly (cached by (h, w)). The
        JAX trainer's data-parallel steps are capped too."""
        key_cap = self._key_cap if self._capped else None
        key = (h, w) if key_cap is None else (h, w, key_cap, scan_steps)
        if key not in self._step_cache:
            kw = dict(scan_steps=scan_steps, key_cap=key_cap)
            if self.parallel == "tp":
                from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (  # noqa: E501
                    make_tp_train_step,
                )

                # the single-device step's signature: the plain loop
                # branch drives it; it runs no windows and no capacity
                make, kw = make_tp_train_step, {}
            elif self.parallel == "dp":
                from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (  # noqa: E501
                    make_dp_train_step,
                )

                make = make_dp_train_step
            else:
                make = make_train_step
            self._step_cache[key] = make(self.config, h, w,
                                         device=self.device, **kw)
        return self._step_cache[key]

    # -- windows of steps (steps_per_dispatch) --------------------------------

    def _boundary_after(self, k: int) -> bool:
        """True if host work runs right after iteration k (densify, alpha
        reset, ftgmm, image log, validation, the key-capacity refit), so k
        may only end a window."""
        config = self.config
        ccfg = config.adaptive_controller_config
        warm = k >= ccfg.num_iterations_warm_up
        if warm and k % ccfg.num_iterations_densify == 0:
            return True
        if warm and k % ccfg.num_iterations_reset_alpha == 0:
            return True
        if k and k % 1234 == 0:  # ftgmm
            return True
        if config.log_image_interval and k % config.log_image_interval == 0:
            return True
        if (k % config.val_interval == 0 and k != 0) or k in (5000, 7000):
            return True
        # the refit runs at window ends only, so %100 must end one
        return k % 100 == 0

    def _boundary_before(self, k: int) -> bool:
        """True if host work precedes iteration k (a downsample or SH-band
        change: a window trains at one size and one band), so k may only
        start a window."""
        config = self.config
        if k % config.half_downsample_factor_interval == 0 and k > 0:
            return True
        return k % config.increase_color_max_sh_band_interval == 0 and k > 0

    def _window_size(self, iteration: int) -> int:
        """Steps of the window starting at ``iteration``:
        ``steps_per_dispatch`` when no boundary falls inside it, else 1."""
        spd = max(self.config.steps_per_dispatch, 1)
        if spd == 1 or iteration + spd > self.config.num_iterations:
            return 1
        for d in range(spd - 1):
            if (self._boundary_after(iteration + d)
                    or self._boundary_before(iteration + d + 1)):
                return 1
        return spd

    def _window_tensors(self, items, uint8: bool = True):
        """(images (k, H, W, 3), qs, ts, Ks) of a window's items on the
        trainer's device. The single-device window stages its images as
        uint8, as the JAX trainer does: rint(image * 255) inverts the 8-bit
        decode (after a downsample it requantizes). The data-parallel
        dispatches stage f32 (``uint8`` False), as the JAX trainer's
        do."""
        images = np.stack([it.image for it in items])
        images = (np.rint(images * 255.0).astype(np.uint8) if uint8
                  else images.astype(np.float32))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return (put(images),
                put(np.stack([it.q_pointcloud_camera for it in items]
                             ).astype(np.float32)),
                put(np.stack([it.t_pointcloud_camera for it in items]
                             ).astype(np.float32)),
                put(np.stack([it.camera_info.camera_intrinsics
                              for it in items]).astype(np.float32)))

    def _maybe_rebucket_key_cap(self, num_keys: int) -> bool:
        """Grow the key capacity at once when the live total needs more
        (``fit_key_cap``), halve it once the need falls to a quarter of it
        (hysteresis); the steps of an old capacity leave the cache. Returns
        True when it grew: the frame overflowed the old capacity."""
        if num_keys <= 0:
            return False
        want = fit_key_cap(
            num_keys,
            minimum=min(2 ** 15, self.config.rasterisation_config.key_cap))
        grow = want > self._key_cap
        shrink = want * 4 <= self._key_cap
        if grow or shrink:
            self._key_cap = want if grow else self._key_cap // 2
            self._step_cache = {k: v for k, v in self._step_cache.items()
                                if k[2] == self._key_cap}
            print(f"key_cap -> {self._key_cap} (live keys {num_keys})")
        return grow

    def _get_eval(self, h: int, w: int):
        key = (h, w)
        if key not in self._eval_cache:
            self._eval_cache[key] = make_eval_step(self.config, h, w)
        return self._eval_cache[key]

    def _item_tensors(self, item):
        """(image, q, t, K) of a dataset item on the trainer's device."""
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.float32)).to(self.device)
        return (put(item.image), put(item.q_pointcloud_camera),
                put(item.t_pointcloud_camera),
                put(item.camera_info.camera_intrinsics))

    def _eval_frame(self, state: TrainState, item, sh_band: int):
        """One validation render: (metrics, pred, depth, count)."""
        h = item.camera_info.camera_height
        w = item.camera_info.camera_width
        return self._get_eval(h, w)(state.scene, *self._item_tensors(item),
                                    sh_band)

    # -- logging ----------------------------------------------------------------

    def _scalar(self, tag: str, value, iteration: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), iteration)

    def _console(self, **kv):
        if self.config.print_metrics_to_console and self.is_main:
            for k, v in kv.items():
                print(f"{k}={v};")

    # -- main loop ---------------------------------------------------------------

    def _dp_rows(self, window: int) -> tuple:
        """(global camera indices, steps) of the next data-parallel
        dispatch: ``world * window`` indices from the shared-seed stream,
        step-major (the JAX trainer's ``next_global(per_step * window)``).
        Outside ``multihost``, a dispatch whose cameras map to mixed
        resolutions becomes one step on the newest camera's resolution: its
        last ``world`` cameras of that size, and more drawn while fewer (the
        JAX trainer's fallback and refetch; here decided from metadata,
        identically on every rank, before any pixel is read)."""
        world = self.world
        gidx = self._sampler.next_global(world * window)
        if self._mh_hw is not None:
            return gidx, window
        sizes = [self._record_hw[i] for i in gidx]
        if len(set(sizes)) == 1:
            return gidx, window
        target = sizes[-1]
        keep = [i for i, s in zip(gidx, sizes) if s == target][-world:]
        fetched = 0
        while len(keep) < world:
            (i,) = self._sampler.next_global(1)
            if self._record_hw[i] == target:
                keep.append(i)
            fetched += 1
            if fetched > 10 * max(len(self.train_dataset), 1):
                raise RuntimeError(
                    "could not assemble a uniform-resolution data-parallel "
                    f"batch of {world} at {target[0]}x{target[1]}")
        return keep, 1

    def _dp_items(self, window: int, next_window: int) -> tuple:
        """(this rank's items, steps) of the next data-parallel dispatch of
        ``window`` steps (``_dp_rows``): one item a step, in step order.
        The decode of the next dispatch, of ``next_window`` steps (0: none
        follows), is submitted while this one trains (the stream is
        deterministic, so a peek gives what the next draw returns; a
        mismatch, as after a fallback, is loaded synchronously)."""
        from taichi_3d_gaussian_splatting_tpu_torch.parallel.multihost import (  # noqa: E501
            GlobalShuffleSampler,
        )

        gidx, window = self._dp_rows(window)
        pre, self._prefetch = self._prefetch, None
        if pre is not None and pre[0] == gidx:
            items = [f.result() for f in pre[1]]
        else:
            items = self._loader.load(GlobalShuffleSampler.local_slice(
                gidx, self.world, 1, self.rank))
        if next_window:
            nxt = self._sampler.peek_global(self.world * next_window)
            self._prefetch = (nxt, self._loader.submit(
                GlobalShuffleSampler.local_slice(nxt, self.world, 1,
                                                 self.rank)))
        return items, window

    def train(self) -> TrainState:
        from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
            multihost as mh,
        )

        config = self.config
        tile = config.rasterisation_config.tile_size
        data_iter = None
        if self.parallel == "dp":
            # every rank draws the same global index stream and decodes
            # only its own rows
            self._sampler = mh.GlobalShuffleSampler(len(self.train_dataset),
                                                    seed=config.seed)
            self._loader = mh.ThreadedIndexLoader(
                self.train_dataset, num_threads=config.num_data_threads,
                expected_hw=self._mh_hw)
            self._record_hw = [mh.expected_resolution(r, tile)
                               for r in self.train_dataset.records]
            self._prefetch = None
        else:
            data_iter = iter(PrefetchLoader(
                self.train_dataset, shuffle=True,
                num_threads=config.num_data_threads, seed=config.seed))
        state = init_train_state(self.scene, config,
                                 len(self.train_dataset))

        start_iteration = 0
        if config.resume_from:
            # imported here: the checkpoint module imports this one
            from taichi_3d_gaussian_splatting_tpu_torch.training.checkpoint import (  # noqa: E501
                load_checkpoint,
            )

            state, meta = load_checkpoint(config.resume_from, state)
            start_iteration = int(meta["iteration"]) + 1
            self.best_psnr_score = float(meta.get("best_psnr", 0.0))
            self._key_cap = int(meta.get("key_cap", self._key_cap))
            # the live stream, not the seed: re-seeding would replay the
            # densify draws of iterations 0..k
            self.generator.set_state(
                torch.tensor(meta["rng_state"], dtype=torch.uint8))
            print(f"resumed from {config.resume_from} at iteration "
                  f"{start_iteration}")
        if self.parallel:
            # identical by construction (shared seed or checkpoint);
            # rank 0's copy makes it so bit for bit
            state = mh.broadcast_tree(state)

        ccfg = config.adaptive_controller_config
        downsample_factor = config.initial_downsample_factor
        for _ in range(start_iteration
                       // config.half_downsample_factor_interval):
            if downsample_factor > 1:
                downsample_factor //= 2
        recent_losses = collections.deque(maxlen=100)
        self._last_problematic = -1000
        t_start = time.time()
        try:
            iteration = start_iteration - 1
            while iteration + 1 < config.num_iterations:
                iteration += 1
                if (iteration % config.half_downsample_factor_interval == 0
                        and iteration > 0 and downsample_factor > 1):
                    downsample_factor //= 2
                    # the factor only falls: the windows of the old sizes
                    # cannot recur, and their graphs go
                    self._step_cache = {
                        k: v for k, v in self._step_cache.items()
                        if len(k) < 4 or k[3] == 0}
                sh_band = iteration // config.increase_color_max_sh_band_interval
                window = self._window_size(iteration)
                # -1 holds the pose still during the pose warm-up
                warm_pose = iteration >= config.pose_refinement_warm_up
                if self.parallel == "dp":
                    # this rank's camera of each step of the dispatch; the
                    # logged item is the last step's batch row 0 (the main
                    # rank's), whose frame the step's frame stats hold
                    nxt = iteration + window
                    items, window = self._dp_items(
                        window, self._window_size(nxt)
                        if nxt < config.num_iterations else 0)
                    if downsample_factor > 1:
                        items = [downsample_item(it, downsample_factor, tile)
                                 for it in items]
                    item = items[-1]
                    h = item.camera_info.camera_height
                    w = item.camera_info.camera_width
                    # the JAX trainer's iteration + d // rows_per_step, one
                    # row a step on each rank
                    idxs = [it.index if iteration + d
                            >= config.pose_refinement_warm_up else -1
                            for d, it in enumerate(items)]
                    rows = self._window_tensors(items, uint8=False)
                    if window > 1:
                        state, stacked, frame_stats = self._get_step(
                            h, w, window)(
                                state, *(x[:, None] for x in rows), sh_band,
                                [[i] for i in idxs])
                        metrics = self._emit_window_metrics(
                            stacked, iteration, window, recent_losses)
                        iteration += window - 1
                    else:
                        state, metrics, frame_stats = self._get_step(h, w)(
                            state, *rows, sh_band, idxs)
                    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (  # noqa: E501
                        frame_stats_aux,
                    )

                    aux = frame_stats_aux(frame_stats)
                else:
                    items = [next(data_iter) for _ in range(window)]
                    if downsample_factor > 1:
                        items = [downsample_item(it, downsample_factor, tile)
                                 for it in items]
                    item = items[-1]
                    h = item.camera_info.camera_height
                    w = item.camera_info.camera_width
                    if any((it.camera_info.camera_height,
                            it.camera_info.camera_width) != (h, w)
                           for it in items):
                        # mixed resolutions: a window of one, the newest
                        # item (the JAX trainer's fallback)
                        window = 1
                    if window > 1:
                        idxs = [it.index if iteration + d
                                >= config.pose_refinement_warm_up else -1
                                for d, it in enumerate(items)]
                        state, stacked, aux = self._get_step(h, w, window)(
                            state, *self._window_tensors(items), sh_band,
                            idxs)
                        metrics = self._emit_window_metrics(
                            stacked, iteration, window, recent_losses)
                        iteration += window - 1
                    else:
                        pose_idx = item.index if warm_pose else -1
                        state, metrics, aux = self._get_step(h, w)(
                            state, *self._item_tensors(item), sh_band,
                            pose_idx)

                # densify cadence, on the post-optimizer-step scene
                warm = iteration >= ccfg.num_iterations_warm_up
                if warm and iteration % ccfg.num_iterations_densify == 0:
                    info = self.densify_find(
                        state.scene, state.ctrl, aux["stats"],
                        aux["point_depth"],
                        iteration > ccfg.iteration_start_remove_floater)
                    if (ccfg.plot_densify_interval
                            and iteration % ccfg.plot_densify_interval == 0):
                        self._log_densify_scatter(info, aux, iteration)
                    new_scene, new_ctrl = self.densify_apply(
                        state.scene, info, self.generator)
                    if self.parallel:
                        # the ranks drew the same noise from the same
                        # generator state; rank 0's pool keeps them equal
                        # bit for bit
                        new_scene = mh.broadcast_tree(new_scene)
                    state = state._replace(scene=new_scene, ctrl=new_ctrl)
                if warm and iteration % ccfg.num_iterations_reset_alpha == 0:
                    state = state._replace(
                        scene=self.alpha_reset(state.scene))

                # the scene as a Gaussian mixture, in Fourier space: a
                # diagnostic, so a failure is printed and training goes on;
                # the scene is replicated, so the main rank's covers the job
                if iteration and iteration % 1234 == 0 and self.is_main:
                    try:
                        from taichi_3d_gaussian_splatting_tpu_torch.tools.ftgmm import (  # noqa: E501
                            ft_grab_scene,
                        )
                        ft_grab_scene(state.scene, vis_dir=os.path.join(
                            config.summary_writer_log_dir, "vis"))
                    except Exception as e:  # the analysis is diagnostic-only
                        print(f"ftgmm analysis failed at {iteration}: {e}")

                # metrics stay on the device and are read at log cadence
                recent_losses.append(metrics["loss"])
                if self._capped and iteration % 100 == 0:
                    # the last step's true key total (a window end)
                    self._maybe_rebucket_key_cap(int(metrics["num_keys"]))
                self._log_step(state, metrics, aux, iteration, t_start)
                self._profile_window(iteration)

                log_images_now = (config.log_image_interval and
                                  iteration % config.log_image_interval == 0)
                # "problematic" frame: loss over 1.5x the rolling average,
                # checked at loss-log cadence
                problematic = False
                if (iteration % config.log_loss_interval == 0
                        and len(recent_losses) == recent_losses.maxlen
                        and iteration - self._last_problematic > 100):
                    avg = float(torch.stack(list(recent_losses)).mean())
                    if float(metrics["loss"]) > 1.5 * avg:
                        problematic = True
                        self._last_problematic = iteration
                if (log_images_now or problematic) and self.writer is not None:
                    if config.train_slim:
                        # the slim step blends rgb only: render this frame's
                        # depth and count grids on demand
                        _, _, depth, count = self._eval_frame(state, item,
                                                              sh_band)
                        aux = dict(aux, depth=depth, count=count)
                    self._log_images(item, metrics, aux, iteration,
                                     problematic=problematic)

                if ((iteration % config.val_interval == 0 and iteration != 0)
                        or iteration in (5000, 7000)):
                    state = self._validate(state, iteration)
        finally:
            if data_iter is not None:
                data_iter.close()
            else:
                self._loader.close()
            if self._profiler is not None:
                self._profiler.stop()
                self._profiler = None
        if self.writer is not None:
            self.writer.flush()
        self.scene = state.scene
        return state

    def _emit_window_metrics(self, stacked: dict, iteration: int,
                             window: int, recent_losses) -> dict:
        """Log a window's interior steps from its stacked metrics (the
        scalars and the ``key=value;`` console lines of every log point, as
        a window of one would) and return the last step's row."""
        config = self.config
        for d in range(window - 1):
            k = iteration + d
            row = {key: v[d] for key, v in stacked.items()}
            recent_losses.append(row["loss"])
            if k % config.log_loss_interval == 0:
                loss_val = float(row["loss"])
                l1 = float(row["l1"])
                ssim_loss = 1.0 - float(row["ssim"])
                self._scalar("train/loss", loss_val, k)
                self._scalar("train/l1 loss", l1, k)
                self._scalar("train/ssim loss", ssim_loss, k)
                self._console(train_iteration=k, train_loss=loss_val,
                              train_l1_loss=l1, train_ssim_loss=ssim_loss)
            if k % config.log_metrics_interval == 0:
                p = float(row["psnr"])
                s = float(row["ssim"])
                self._scalar("train/psnr", p, k)
                self._scalar("train/ssim", s, k)
                self._console(train_psnr=p, train_ssim=s,
                              **{f"train_psnr_{k}": p,
                                 f"train_ssim_{k}": s})
        return {key: v[-1] for key, v in stacked.items()}

    def _log_step(self, state, metrics, aux, iteration: int,
                  t_start: float) -> None:
        config = self.config
        if iteration % config.log_loss_interval == 0:
            loss_val = float(metrics["loss"])
            l1 = float(metrics["l1"])
            ssim_loss = 1.0 - float(metrics["ssim"])
            self._scalar("train/loss", loss_val, iteration)
            self._scalar("train/l1 loss", l1, iteration)
            self._scalar("train/ssim loss", ssim_loss, iteration)
            self._console(train_iteration=iteration, train_loss=loss_val,
                          train_l1_loss=l1, train_ssim_loss=ssim_loss)
        if iteration % config.log_metrics_interval == 0:
            p = float(metrics["psnr"])
            s = float(metrics["ssim"])
            self._scalar("train/psnr", p, iteration)
            self._scalar("train/ssim", s, iteration)
            self._scalar("train/num_valid_points",
                         int(state.scene.num_valid()), iteration)
            self._log_histograms(state, aux, iteration)
            self._scalar("train/steps_per_s",
                         (iteration + 1) / (time.time() - t_start), iteration)
            self._console(train_psnr=p, train_ssim=s,
                          **{f"train_psnr_{iteration}": p,
                             f"train_ssim_{iteration}": s})

    def _profile_window(self, iteration: int) -> None:
        """``enable_jax_profiler``: a torch.profiler trace (CPU, and CUDA on
        a card) of the same window of iterations, written as a Chrome trace
        to ``<summary_writer_log_dir>/torch_trace.json``."""
        config = self.config
        if not config.enable_jax_profiler or not self.is_main:
            return
        if iteration == config.jax_profiler_start_iteration:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif (self._profiler is not None
              and iteration == config.jax_profiler_start_iteration
              + config.jax_profiler_num_iterations):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            self._profiler.export_chrome_trace(os.path.join(
                config.summary_writer_log_dir, "torch_trace.json"))
            self._profiler = None

    def _log_densify_scatter(self, info, aux, iteration: int) -> None:
        """The points selected this round over the current prediction:
        split (red), clone (green), removed (blue)."""
        if self.writer is None:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        uv = _np(aux["point_uv"])
        if not uv.any():
            return
        in_cam = _np(aux["stats"].in_camera)
        densify = _np(info.densify_mask) & in_cam
        over = _np(info.over_mask)
        remove = _np(info.remove_mask) & in_cam
        pred = _np(aux["pred"])
        h, w = pred.shape[:2]
        fig, ax = plt.subplots(figsize=(6, 6 * h / max(w, 1)))
        ax.imshow(np.clip(pred, 0, 1))
        for mask, color, label in ((densify & over, "red", "split"),
                                   (densify & ~over, "green", "clone"),
                                   (remove, "blue", "remove")):
            pts = uv[mask]
            if len(pts):
                ax.scatter(pts[:, 0], pts[:, 1], s=2, c=color, label=label)
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)
        ax.legend(loc="upper right", fontsize=6)
        self.writer.add_figure("densify/selection", fig, iteration)
        plt.close(fig)

    def _log_histograms(self, state, aux, iteration: int) -> None:
        """Parameter and gradient histograms at the metrics cadence."""
        if self.writer is None:
            return
        valid = ~_np(state.scene.invalid)
        if valid.sum() == 0:
            return
        f = _np(state.scene.features)[valid]
        self.writer.add_histogram("value/q", f[:, 0:4], iteration)
        self.writer.add_histogram("value/s", f[:, 4:7], iteration)
        self.writer.add_histogram("value/alpha", f[:, 7], iteration)
        self.writer.add_histogram("value/sh_dc", f[:, [8, 24, 40]], iteration)
        self.writer.add_histogram("value/xyz", _np(state.scene.xyz)[valid],
                                  iteration)
        stats = aux.get("stats")
        if stats is not None:
            mag = _np(stats.magnitude_grad_viewspace)[valid]
            if np.isfinite(mag).all() and mag.size:
                self.writer.add_histogram("grad/viewspace_magnitude", mag,
                                          iteration)
        gf = aux.get("grad_features")
        if gf is not None:
            g = _np(gf)[valid]
            hi = np.concatenate([g[:, 9:24], g[:, 25:40], g[:, 41:56]], axis=1)
            for tag, arr in (("grad/q", g[:, 0:4]), ("grad/s", g[:, 4:7]),
                             ("grad/alpha", g[:, 7]),
                             ("grad/sh_dc", g[:, [8, 24, 40]]),
                             ("grad/sh_high_order", hi)):
                if np.isfinite(arr).all() and arr.size:
                    self.writer.add_histogram(tag, arr, iteration)
        gx = aux.get("grad_xyz")
        if gx is not None:
            g = _np(gx)[valid]
            if np.isfinite(g).all() and g.size:
                self.writer.add_histogram("grad/xyz", g, iteration)

    @staticmethod
    def _easy_cmap(depth: np.ndarray) -> np.ndarray:
        """Near/mid/far depth bands, inverted."""
        return 1.0 - np.stack([
            np.clip(depth, 0, 10) / 10.0,
            np.clip(depth - 10, 0, 50) / 50.0,
            np.clip(depth - 60, 0, 200) / 200.0,
        ], axis=-1)

    def _log_validation_image(self, item, pred, depth, count, idx: int,
                              iteration: int) -> None:
        """pred | gt / depth | count / |diff| grid under ``val/image idx``."""
        pred = np.clip(_np(pred), 0, 1)
        gt = np.asarray(item.image)
        d_rgb = self._easy_cmap(_np(depth))
        count = _np(count).astype(np.float32)
        c_rgb = np.repeat((count / max(count.max(), 1.0))[..., None], 3,
                          axis=-1)
        diff = np.abs(pred - gt)
        grid = np.concatenate([
            np.concatenate([pred, gt], axis=1),
            np.concatenate([d_rgb, c_rgb], axis=1),
            np.concatenate([diff, np.zeros_like(diff)], axis=1),
        ], axis=0)
        self.writer.add_image(
            f"val/image {idx}",
            (grid.transpose(2, 0, 1) * 255).astype(np.uint8), iteration)

    def _log_images(self, item, metrics, aux, iteration: int,
                    problematic: bool = False) -> None:
        """pred | gt / depth | point-count grid."""
        pred = _np(aux["pred"])
        d_rgb = self._easy_cmap(_np(aux["depth"]))
        count = _np(aux["count"]).astype(np.float32)
        c_rgb = np.repeat((count / max(count.max(), 1.0))[..., None], 3,
                          axis=-1)
        grid = np.concatenate([np.concatenate([pred, item.image], axis=1),
                               np.concatenate([d_rgb, c_rgb], axis=1)],
                              axis=0)
        tag = "train/image_problematic" if problematic else "train/image"
        self.writer.add_image(
            tag, (grid.transpose(2, 0, 1) * 255).astype(np.uint8), iteration)

    # -- validation -------------------------------------------------------------

    def _export_refined_poses(self, state: TrainState) -> None:
        """Write ``refined_poses.json`` beside the checkpoints: the train
        dataset's records with ``T_pointcloud_camera`` replaced by the pose
        composed with its learned delta, R(q) R(exp(omega)) and t + dt (what
        ``apply_pose_delta`` renders), a dataset json the render CLI and
        ``ImagePoseDataset`` read as it is."""
        import json

        from scipy.spatial.transform import Rotation

        deltas = _np(state.pose_deltas)  # (N, 6)
        recs = self.train_dataset.records
        Ts = np.stack([np.asarray(r["T_pointcloud_camera"], np.float32)
                       for r in recs])
        R_new = (Rotation.from_matrix(Ts[:, :3, :3])
                 * Rotation.from_rotvec(deltas[:, :3])).as_matrix()
        t_new = Ts[:, :3, 3] + deltas[:, 3:]
        records = []
        for i, rec in enumerate(recs):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_new[i]
            T[:3, 3] = t_new[i]
            records.append(dict(rec, T_pointcloud_camera=T.tolist()))
        with open(os.path.join(self.output_model_dir, "refined_poses.json"),
                  "w") as f:
            json.dump(records, f)

    def _validate(self, state: TrainState, iteration: int) -> TrainState:
        """Render every val view; log the mean loss, PSNR and SSIM; write
        ``scene_{iteration}``, ``checkpoint_latest`` and, on a new best
        PSNR, ``best_scene``. On several ranks each renders every
        world-th view (its own share) and the totals are all-reduced; the
        main rank writes."""
        config = self.config
        sh_band = min(iteration // config.increase_color_max_sh_band_interval,
                      3)
        keys = ("loss", "l1", "psnr", "ssim_score")
        totals = collections.defaultdict(float)
        frame_times = []
        n = 0
        if self.world == 1:
            items = PrefetchLoader(self.val_dataset, shuffle=False,
                                   loop=False,
                                   num_threads=config.num_data_threads)
        else:
            items = (self.val_dataset[i] for i in range(len(self.val_dataset))
                     if i % self.world == self.rank)
        for item in items:
            t0 = time.time()
            metrics, pred, depth, count = self._eval_frame(state, item,
                                                           sh_band)
            values = {k: float(metrics[k]) for k in keys}
            frame_times.append(time.time() - t0)
            for k, v in values.items():
                totals[k] += v
            if config.log_validation_image and self.writer is not None:
                self._log_validation_image(item, pred, depth, count,
                                           item.index, iteration)
            n += 1
        if self.world > 1:
            from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
                multihost as mh,
            )

            vec = torch.tensor([totals[k] for k in keys] + [float(n)],
                               dtype=torch.float64, device=self.device)
            (vec,) = mh.all_reduce_packed([vec], "sum", dtype=torch.float64)
            vec = vec.tolist()
            totals, n = dict(zip(keys, vec[:4])), int(round(vec[4]))
        if n == 0:
            return state
        mean_psnr = totals["psnr"] / n
        mean_ssim = totals["ssim_score"] / n
        self._scalar("val/loss", totals["loss"] / n, iteration)
        self._scalar("val/psnr", mean_psnr, iteration)
        self._scalar("val/ssim", mean_ssim, iteration)
        # the median leaves out the first frame's one-time costs
        if frame_times:
            self._scalar("val/inference_time", float(np.median(frame_times)),
                         iteration)
        self._console(val_loss=totals["loss"] / n, val_psnr=mean_psnr,
                      val_ssim=mean_ssim,
                      **{f"val_psnr_{iteration}": mean_psnr,
                         f"val_ssim_{iteration}": mean_ssim})
        if not self.is_main:
            # the totals were all-reduced, so every rank keeps the same
            # best-PSNR bookkeeping; the writes belong to the main rank
            self.best_psnr_score = max(self.best_psnr_score, mean_psnr)
            return state

        self._save_scene(state.scene, os.path.join(
            self.output_model_dir, f"scene_{iteration}.parquet"))
        if config.pose_refinement and state.pose_deltas is not None:
            self._export_refined_poses(state)
        if config.save_full_checkpoint:
            from taichi_3d_gaussian_splatting_tpu_torch.training.checkpoint import (  # noqa: E501
                save_checkpoint,
            )

            save_checkpoint(
                os.path.join(self.output_model_dir, "checkpoint_latest"),
                state,
                {"iteration": iteration, "best_psnr": self.best_psnr_score,
                 "key_cap": self._key_cap,
                 "rng_state": self.generator.get_state().tolist()})
        if mean_psnr > self.best_psnr_score:
            self.best_psnr_score = mean_psnr
            self._save_scene(state.scene, os.path.join(
                self.output_model_dir, "best_scene.parquet"))
        return state
