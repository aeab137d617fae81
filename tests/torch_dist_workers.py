"""Rank functions of the port's multi-device tests, and their seeded inputs.

The tests run these on ranks that ``multihost.run_local_ranks`` spawns
(gloo on the CPU), so this module imports torch, numpy and the port only:
a spawned rank never imports JAX. The inputs are those of
tests/test_parallel.py (32x32 views, 96 points), made with numpy here so
the JAX side of a test can build the same arrays.
"""
import dataclasses
import os

import numpy as np
import torch

HW = 32
K32 = np.asarray([[24.0, 0, 16.0], [0, 24.0, 16.0], [0, 0, 1.0]], np.float32)
Q_ID = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
T_B = np.asarray([0.1, 0.0, -0.2], np.float32)
POSE_LR = 1e-3


def spawn_ranks(fn, world=2, args=()):
    """``fn(*args)`` on ``world`` gloo ranks on the CPU, two torch threads
    a rank (the test workers share the host's cores); each rank's return
    value, in rank order."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        return mh.run_local_ranks(fn, world, args=args, device="cpu",
                                  timeout_s=240)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def dp_scene(n=96, seed=0):
    """tests/test_parallel.py::make_scene as numpy (xyz, features)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack(
        [rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
         rng.uniform(2.0, 4.0, n)], axis=-1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = -2.0
    feats[:, 8] = rng.normal(size=n)
    return xyz, feats


def _images(seed, count):
    rng = np.random.default_rng(seed)
    return [rng.random((HW, HW, 3)).astype(np.float32) for _ in range(count)]


def dp_case(name):
    """The inputs of one data-parallel case of tests/test_parallel.py:
    (scene seed, the two rows' images and translations, the rows' view
    indices or None, pose refinement on)."""
    zero = np.zeros(3, np.float32)
    if name == "identical":          # :70, :194
        img = _images(1, 1)[0]
        return 0, [img, img], [zero, zero], None, False
    if name == "different":          # :109, :258
        return 3, _images(2, 2), [zero, T_B], None, False
    if name == "pose_rows":          # :300
        img = _images(4, 1)[0]
        return 9, [img, img], [zero, zero], [0, 1], True
    if name == "duplicate":          # :408
        img = _images(4, 1)[0]
        return 9, [img, img], [zero, zero], [0, 0], True
    raise KeyError(name)


DP_CASES = ("identical", "different", "pose_rows", "duplicate")


def port_config(pose=False, **rcfg):
    """tests/test_parallel.py::make_config for the port; ``rcfg``: other
    rasterizer fields (tile_size 32 by default)."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
        RasterizerConfig,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        TrainConfig,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.loss import (
        LossConfig,
    )

    config = TrainConfig(
        rasterisation_config=RasterizerConfig(**dict(dict(tile_size=32),
                                                     **rcfg)),
        loss_function_config=LossConfig(enable_regularization=False),
        feature_learning_rate=1e-2)
    if pose:
        config = dataclasses.replace(config, pose_refinement=True,
                                     pose_learning_rate=POSE_LR,
                                     pose_refinement_warm_up=0)
    return config


def port_state(config, xyz, feats, num_images=0, device="cpu"):
    from taichi_3d_gaussian_splatting_tpu_torch.convert import (
        scene_from_jax_arrays,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        init_train_state,
    )

    scene = scene_from_jax_arrays(xyz, feats, np.zeros(len(xyz), bool),
                                  device=device)
    return init_train_state(scene, config, num_images)


def state_np(state) -> dict:
    """The leaves of a port TrainState as numpy arrays."""
    out = {"features": state.scene.features, "xyz": state.scene.xyz,
           "feat_mu": state.feat_opt.mu, "feat_nu": state.feat_opt.nu,
           "pos_mu": state.pos_opt.mu, "pos_nu": state.pos_opt.nu}
    out.update({f"ctrl_{f}": getattr(state.ctrl, f)
                for f in state.ctrl._fields})
    if state.pose_deltas is not None:
        out["pose_deltas"] = state.pose_deltas
        out.update({f"pose_{k}": v for k, v in state.pose_opt.items()})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def dp_ranks():
    """Each data-parallel case on this rank's row of the two-camera batch:
    {case: {"state", "metrics", "frame_stats"}} as numpy."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
        shard_batch,
    )

    out = {}
    for name in DP_CASES:
        seed, imgs, ts, idx, pose = dp_case(name)
        config = port_config(pose)
        xyz, feats = dp_scene(seed=seed)
        state = mh.broadcast_tree(
            port_state(config, xyz, feats, 2 if pose else 0))
        step = make_dp_train_step(config, HW, HW, device="cpu")
        rows = shard_batch(np.stack(imgs), np.stack([Q_ID, Q_ID]),
                           np.stack(ts), np.stack([K32, K32]), device="cpu")
        my_idx = None if idx is None else idx[mh.rank():mh.rank() + 1]
        new, metrics, fs = step(state, *rows, 3, my_idx)
        out[name] = {
            "state": state_np(new),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "frame_stats": {k: _np(v) for k, v in fs.items()},
            "collectives": [(c.op, c.numel) for c in step.collectives],
        }
    return out


# --- data-parallel windows -------------------------------------------------

# 32x8 tiles (a shape of tests/test_rasterizer.py:426): the window views
# carry 165-177 keys each, so a capacity of 128 lies below every total and
# 256 above (the JAX blend takes multiples of 128)
WIN_TILE = dict(tile_size=32, tile_h=8)
WIN_CAPS = (256, 128)
WIN_CASES = ("window", "pose_window")
WIN_STEPS = 2


def win_case(name):
    """The inputs of a window case of tests/test_parallel.py: two steps of
    two cameras, (scene seed, the 4 images and translations in (step,
    row) order, the rows' view indices or None, pose refinement on).
    ``pose_window`` (:351) starts with a -1 row, as the warm-up does."""
    if name == "window":             # :139
        rng = np.random.default_rng(5)
        ts = [np.zeros(3, np.float32), T_B,
              np.asarray([-0.1, 0.05, 0.1], np.float32),
              np.zeros(3, np.float32)]
        return 7, [rng.random((HW, HW, 3)).astype(np.float32)
                   for _ in range(4)], ts, None, False
    if name == "pose_window":        # :351
        rng = np.random.default_rng(8)
        return 21, [rng.random((HW, HW, 3)).astype(np.float32)
                    for _ in range(4)], [np.zeros(3, np.float32)] * 4, \
            [-1, 1, 1, 0], True
    raise KeyError(name)


def win_inputs(name, rows, device="cpu"):
    """(images, qs, ts, Ks (WIN_STEPS, len(rows), ...), idxs or None) of a
    window case: each step's batch rows ``rows``."""
    _, imgs, ts, idx, _ = win_case(name)

    def take(a):
        return torch.from_numpy(np.stack(
            [np.stack([np.asarray(a[2 * s + r], np.float32) for r in rows])
             for s in range(WIN_STEPS)])).to(device)
    idxs = None if idx is None else [[idx[2 * s + r] for r in rows]
                                     for s in range(WIN_STEPS)]
    return (take(imgs), take([Q_ID] * 4), take(ts), take([K32] * 4), idxs)


def leaves_equal(a, b) -> bool:
    from taichi_3d_gaussian_splatting_tpu_torch.training.checkpoint import (
        state_leaves,
    )

    return all(torch.equal(x, y)
               for x, y in zip(state_leaves(a), state_leaves(b)))


def dp_window_cases():
    """Each window case at each capacity on this rank's row of every step:
    the window, and its steps as eager capped data-parallel steps."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    out = {}
    for name in WIN_CASES:
        for cap in WIN_CAPS:
            seed, _, _, _, pose = win_case(name)
            config = port_config(pose, key_cap=cap, **WIN_TILE)
            xyz, feats = dp_scene(seed=seed)
            state = mh.broadcast_tree(
                port_state(config, xyz, feats, 2 if pose else 0))
            *views, idxs = win_inputs(name, [mh.rank()])
            window = make_dp_train_step(config, HW, HW, device="cpu",
                                        scan_steps=WIN_STEPS)
            new, stacked, fs = window(state, *views, 3, idxs)
            capped = make_dp_train_step(config, HW, HW, device="cpu",
                                        key_cap=cap)
            eager, rows = state, []
            for k in range(WIN_STEPS):
                eager, m, efs = capped(eager, *(v[k] for v in views), 3,
                                       None if idxs is None else idxs[k])
                rows.append(m)
            out[(name, cap)] = {
                "mode": window.mode, "state": state_np(new),
                "metrics": {k: v.numpy() for k, v in stacked.items()},
                "in_camera": fs["in_camera"].numpy(),
                "eager_equal": leaves_equal(new, eager) and all(
                    torch.equal(stacked[k], torch.stack([m[k] for m in rows]))
                    for k in stacked) and all(
                        torch.equal(fs[k], efs[k]) for k in fs),
            }
    return out


WIN4_WORLD = 4
WIN4_CAPS = (256, 128)


def win4_inputs(rows, device="cpu"):
    """A window of WIN_STEPS steps of four cameras (seeded images, moved
    cameras), view 4s + r at step s, batch row r: (images, qs, ts, Ks),
    each (WIN_STEPS, len(rows), ...), of the batch rows ``rows``."""
    rng = np.random.default_rng(13)
    count = WIN_STEPS * WIN4_WORLD
    imgs = [rng.random((HW, HW, 3)).astype(np.float32) for _ in range(count)]
    ts = [np.asarray([0.04 * (i % 4) - 0.06, 0.03 * (i // 4) - 0.02,
                      0.05 * (i % 3) - 0.05], np.float32)
          for i in range(count)]

    def take(a):
        return torch.from_numpy(np.stack(
            [np.stack([np.asarray(a[WIN4_WORLD * s + r], np.float32)
                       for r in rows]) for s in range(WIN_STEPS)])).to(device)
    return (take(imgs), take([Q_ID] * count), take(ts), take([K32] * count))


def dp_window4_ranks():
    """On this rank of four: the window of WIN_STEPS steps on its row of
    ``win4_inputs`` at each capacity of WIN4_CAPS (the ``window`` case's
    scene), its mode, state, metrics and last frame's ``in_camera``."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    out = {}
    for cap in WIN4_CAPS:
        config = port_config(key_cap=cap, **WIN_TILE)
        xyz, feats = dp_scene(seed=win_case("window")[0])
        state = mh.broadcast_tree(port_state(config, xyz, feats))
        window = make_dp_train_step(config, HW, HW, device="cpu",
                                    scan_steps=WIN_STEPS)
        new, stacked, fs = window(state, *win4_inputs([mh.rank()]), 3)
        out[cap] = {"mode": window.mode, "world": mh.world_size(),
                    "state": state_np(new),
                    "metrics": {k: v.numpy() for k, v in stacked.items()},
                    "in_camera": fs["in_camera"].numpy()}
    return out


def _train_run(config_dict):
    """One data-parallel train() on this rank: the final state's leaves,
    this rank's camera indices of each dispatch, (iteration, steps) of
    each dispatch, and the key-capacity refits."""
    from taichi_3d_gaussian_splatting_tpu_torch.training.checkpoint import (
        state_leaves,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        from_dict,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        GaussianPointCloudTrainer,
    )

    trainer = GaussianPointCloudTrainer(from_dict(config_dict), device="cpu")
    draws, refits = [], []
    dp_items, rebucket = trainer._dp_items, trainer._maybe_rebucket_key_cap

    def recorded_items(window, next_window):
        items, steps = dp_items(window, next_window)
        draws.append((steps, [it.index for it in items]))
        return items, steps

    def recorded_rebucket(num_keys):
        refits.append((num_keys, trainer._key_cap))
        return rebucket(num_keys)

    trainer._dp_items = recorded_items
    trainer._maybe_rebucket_key_cap = recorded_rebucket
    state = trainer.train()
    if trainer.writer is not None:
        trainer.writer.close()  # before the rank exits (apps/train.py)
    caches = sorted(trainer._step_cache)
    return {"leaves": [t.numpy().copy() for t in state_leaves(state)],
            "draws": draws, "refits": refits, "key_cap": trainer._key_cap,
            "step_cache": caches}


def dp_window_ranks(runs: dict):
    """``dp_window_cases`` and the data-parallel train() runs of ``runs``
    ({name: config dict}) on this rank."""
    import contextlib
    import io

    out = {"cases": dp_window_cases()}
    for name, config_dict in runs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            out[name] = _train_run(config_dict)
    return out


# --- band-parallel --------------------------------------------------------

TP_H, TP_W = 64, 32
TP_K = np.asarray([[30.0, 0, 16.0], [0, 30.0, 32.0], [0, 0, 1.0]], np.float32)


def tp_case(name):
    """(xyz, feats, image) of a band-parallel case: ``spanning``, the
    96-point scene of tests/test_parallel.py:531 with 8 large splats over
    the band boundary; ``top_band``, its points moved into the top band's
    view, so the bottom band has no keys."""
    xyz, feats = dp_scene(96, seed=13)
    feats[:8, 4:7] = -0.5
    if name == "top_band":
        # v = 30 y / z + 32 < 0 on screen rows well inside the top band
        xyz[:, 1] = -np.abs(xyz[:, 1]) * 0.4 - 0.5 * xyz[:, 2] * 0.5
        feats[:, 4:7] = -3.0
    img = np.random.default_rng(11).random((TP_H, TP_W, 3)).astype(
        np.float32)
    return xyz, feats, img


TP_CASES = ("spanning", "top_band")


def tp_ranks():
    """Each band-parallel case: one TP train step on this rank's band."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (
        make_tp_train_step,
    )

    out = {}
    for name in TP_CASES:
        xyz, feats, img = tp_case(name)
        config = port_config()
        state = port_state(config, xyz, feats)
        step = make_tp_train_step(config, TP_H, TP_W, device="cpu")
        new, metrics, aux = step(
            state, torch.from_numpy(img), torch.from_numpy(Q_ID),
            torch.zeros(3), torch.from_numpy(TP_K), 3)
        st = aux["stats"]
        out[name] = {
            "state": state_np(new),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "band_keys": aux["band_keys"],
            "pred": _np(aux["pred"]), "point_uv": _np(aux["point_uv"]),
            "stats": {f: _np(getattr(st, f)) for f in st._fields},
        }
    return out


def band_render_scene():
    """tests/test_parallel.py:667: 160 points, some LARGE splats, a
    32x128 camera."""
    rng = np.random.default_rng(3)
    n = 160
    xyz = np.stack(
        [rng.uniform(-1.2, 1.2, n), rng.uniform(-2.2, 2.2, n),
         rng.uniform(2.0, 6.0, n)], axis=-1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    feats[:, 0:4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3.0, -0.5, (n, 3))
    feats[:, 7] = rng.uniform(-1.0, 2.0, n)
    feats[:, 8:] = rng.normal(size=(n, 48)) * 0.3
    w, h = 32, 128
    K = np.asarray([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]],
                   np.float32)
    return xyz, feats, K, w, h


def band_render_ranks():
    """The full-output band render of ``band_render_scene`` on this
    rank's band, gathered: {rgb, depth, alpha, count} as numpy."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
        Camera,
        RasterizerConfig,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (
        rasterize_band_sharded,
    )

    xyz, feats, K, w, h = band_render_scene()
    out = rasterize_band_sharded(
        torch.from_numpy(xyz), torch.from_numpy(feats),
        torch.zeros(len(xyz), dtype=torch.bool), torch.from_numpy(Q_ID),
        torch.zeros(3), Camera(torch.from_numpy(K), w, h),
        RasterizerConfig(tile_size=32))
    return {f: _np(getattr(out, f)) for f in out._fields}
