"""Card-only: the port's entry points on an NVIDIA card at the Truck cell's
size (428,687 points of ``make_truck_scene`` at 960x544, 32x32 tiles),
each against the plain route or its own saved state.

- ``GaussianPointCloudTrainer.train()`` over 8 in-memory views, 40
  iterations with a downsample, SH bands 0-3, densify rounds and a
  validation, in single steps and in graph windows of 8, then a resume;
  and a 49-iteration schedule whose windows replay their graph after
  densify rounds and recapture at an SH-band change without the memory
  held growing by a graph;
- a step whose key capacity drops keys, and the pose-refining step,
  against the plain route: every kernel wrapper swapped for its plain
  version;
- two ranks sharing the card over gloo: ``parallel/mh_smoke.py``, the
  data-parallel step and window, the band-parallel step at 1920x1088,
  the render app pose-sharded and band-split, and ``train()`` with
  ``data_parallel_devices: 2``, against the single-device paths;
- ``tools/inference_benchmark.py`` in its reference protocol: one graph,
  every replayed frame the exact frame bit for bit;
- ``tools/quality_run.py``'s default preset in full (marked ``slow``).

Needs an NVIDIA card and nvcc; skipped elsewhere. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest tests/test_torch_card_paths.py --noconftest -q -m cuda
"""
import contextlib
import gc
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.convert import (
    scene_from_jax_arrays,
)
from taichi_3d_gaussian_splatting_tpu_torch.data.camera import CameraInfo
from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import DatasetItem
from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
from taichi_3d_gaussian_splatting_tpu_torch.ops import attributes as attrs
from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, expand, histogram
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    quaternion_exp,
    quaternion_multiply,
    se3_to_qt,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as T
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
    TrainConfig,
    from_dict,
)
from tests.torch_port_scenes import make_K, make_truck_scene

pytestmark = pytest.mark.cuda

N, W, H, TILE = 428_687, 960, 544, 32
K_NP = make_K(W, H, 580.0)
GRAD_GATE = (5e-4, 1e-3)  # atol, rtol: the JAX package's gradient gate


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    R.pin_f32_matmul()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene():
    """(xyz, features) numpy of the Truck-like scene."""
    xyz, feats, _ = make_truck_scene(N)
    return xyz, feats


def poses(count):
    """Camera->world poses: the identity, then small turns and shifts."""
    out = [np.eye(4, dtype=np.float32)]
    for i in range(1, count):
        a = 0.02 * i * (-1) ** i
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                     [-math.sin(a), 0, math.cos(a)]]
        p[:3, 3] = [0.05 * i * (-1) ** i, 0.02 * i, 0.1 * i]
        out.append(p)
    return np.stack(out)


def _to_u8(rgb):
    return torch.round(torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8)


def gate_excess(got, want) -> float:
    """The largest |got - want| - (atol + rtol |want|): <= 0 inside the
    gradient gate."""
    atol, rtol = GRAD_GATE
    d = (got.double() - want.double()).abs()
    return float((d - (atol + rtol * want.double().abs())).max())


PLAIN = [(attrs, "point_attributes_vjp_plain"),
         (expand, "slot_keys_plain"), (expand, "sorted_table_plain"),
         (histogram, "tile_ranges_plain"), (blend, "blend_forward_plain"),
         (blend, "blend_backward_plain"),
         (sr, "segment_reduce_sorted_plain")]
KERNELS = {"point_attributes": attrs.point_attributes,
           "point_attributes_vjp": attrs.point_attributes_vjp,
           "slot_keys": expand.slot_keys,
           "sorted_table": expand.sorted_table,
           "tile_ranges": histogram.tile_ranges,
           "blend_forward": blend.blend_forward,
           "blend_backward": blend.blend_backward,
           "segment_reduce_sorted": sr.segment_reduce_sorted}


@pytest.fixture
def plain_calls(monkeypatch):
    """{name: calls} of the plain versions of the main path's kernels
    while the test runs (the wrappers take them for CPU tensors only)."""
    calls = {name: 0 for _, name in PLAIN}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


def launches() -> dict:
    return {name: f.launches for name, f in KERNELS.items()}


@pytest.fixture
def plain_route(monkeypatch):
    """A context in which every kernel wrapper of the main path is its
    plain version, so a call through the entry points runs the plain
    versions on the card's tensors."""
    swaps = [(R, "point_attributes", R.point_attributes_plain),
             (R, "point_attributes_vjp", attrs.point_attributes_vjp_plain),
             (expand, "slot_keys", expand.slot_keys_plain),
             (expand, "sorted_table", expand.sorted_table_plain),
             (histogram, "tile_ranges", histogram.tile_ranges_plain),
             (blend, "blend_forward", blend.blend_forward_plain),
             (blend, "blend_backward", blend.blend_backward_plain),
             (R, "segment_reduce_sorted", sr.segment_reduce_sorted_plain)]

    @contextlib.contextmanager
    def route():
        with monkeypatch.context() as m:
            for mod, name, fn in swaps:
                m.setattr(mod, name, fn)
            yield
    return route


def card_camera(dev, height=H, width=W):
    """The Truck cell's camera, its focal length scaled with the width."""
    return R.Camera(torch.from_numpy(make_K(width, height, 580.0 * width / W))
                    .to(dev), width, height)


def train_setup(dev, scene, height=H, width=W):
    """A fresh state of the scene, its step, and a uint8 target rendered
    from it at the identity pose with seeded noise (sigma 0.3) on the DC
    colours: (config, step, state, (gt, q, t, K, band))."""
    xyz, feats = scene
    config = TrainConfig(
        rasterisation_config=R.RasterizerConfig(tile_size=TILE))
    state = T.init_train_state(scene_from_jax_arrays(
        xyz, feats, np.zeros((N,), bool), device=dev), config)
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t = torch.zeros(3, device=dev)
    cam = card_camera(dev, height, width)
    gt = _to_u8(R.rasterize(
        state.scene.xyz, torch.from_numpy(_noisy_dc(feats)).to(dev),
        state.scene.invalid, q, t, cam,
        R.RasterizerConfig(rgb_only=True, tile_size=TILE)).rgb)
    step = T.make_train_step(config, height, width, device=dev)
    return config, step, state, (gt, q, t, cam.K, 3)


def view_targets(state, feats, cam, ids):
    """(uint8 target, q, t) of each pose ``poses()[i]``, i in ``ids``,
    rendered from the state's scene with seeded noise (sigma 0.3) on the
    DC colours."""
    dev = state.scene.xyz.device
    noisy = torch.from_numpy(_noisy_dc(feats)).to(dev)
    qs, ts = se3_to_qt(torch.from_numpy(poses(max(ids) + 1)).to(dev))
    cfg = R.RasterizerConfig(rgb_only=True, tile_size=TILE)
    return [(_to_u8(R.rasterize(state.scene.xyz, noisy, state.scene.invalid,
                                qs[i], ts[i], cam, cfg).rgb),
             qs[i].contiguous(), ts[i].contiguous()) for i in ids]


def _noisy_dc(feats):
    out = feats.copy()
    out[:, [8, 24, 40]] += np.random.default_rng(11).normal(
        0.0, 0.3, (len(feats), 3)).astype(np.float32)
    return out


def test_a_capped_step_below_the_key_total_is_the_plain_routes(
        dev, scene, plain_route):
    """A step at a key capacity of 2^18, below the frame's key total: the
    true total reported, the loss within 1e-4 of the plain route's on the
    same capacity and other than the exact step's (keys dropped), the frame
    within 1e-4, the gradients within the gradient gate."""
    config, step, start, inputs = train_setup(dev, scene)
    capped = T.make_train_step(config, H, W, device=dev, key_cap=2 ** 18)
    _, mk, ak = capped(start, *inputs)
    with plain_route():
        _, mp, ap = capped(start, *inputs)
    _, me, _ = step(start, *inputs)
    total = int(me["num_keys"])
    assert total > 2 ** 18
    assert int(mk["num_keys"]) == int(mp["num_keys"]) == total
    loss, plain = float(mk["loss"]), float(mp["loss"])
    assert abs(loss - plain) <= 1e-4 * abs(plain)
    assert loss != float(me["loss"])
    torch.testing.assert_close(ak["pred"], ap["pred"], rtol=0, atol=1e-4)
    assert gate_excess(ak["grad_features"], ap["grad_features"]) <= 0
    assert gate_excess(ak["grad_xyz"], ap["grad_xyz"]) <= 0


def test_pose_refining_steps_match_the_plain_route(dev, scene, plain_route):
    """make_train_step with pose refinement (warm-up 2) over 3 views whose
    poses are perturbed by a seeded rotation (up to 0.01 rad an axis) and
    shift (up to 2 cm): 3 warm-up steps, the first 2 with view index -1,
    and 20 more; every loss, pose cotangent and delta finite, the deltas
    zero through the warm-up and moving after it, K1-K5 once a step; then
    one step's se(3) pose cotangent within 1e-3 of its norm of the plain
    route's."""
    xyz, feats = scene
    config = TrainConfig(
        rasterisation_config=R.RasterizerConfig(tile_size=TILE),
        pose_refinement=True, pose_refinement_warm_up=2)
    state = T.init_train_state(scene_from_jax_arrays(
        xyz, feats, np.zeros((N,), bool), device=dev), config,
        num_train_images=3)
    cam = card_camera(dev)
    rng = np.random.default_rng(17)
    views = []
    for gt, q, t in view_targets(state, feats, cam, range(3)):
        w = torch.from_numpy(rng.uniform(-0.01, 0.01, 3).astype(
            np.float32)).to(dev)
        dt = torch.from_numpy(rng.uniform(-0.02, 0.02, 3).astype(
            np.float32)).to(dev)
        views.append((gt, quaternion_multiply(q, quaternion_exp(w)), t + dt))
    step = T.make_train_step(config, H, W, device=dev)
    deltas = []
    for i in range(23):
        if i == 3:
            before = launches()
        gt, q, t = views[i % 3]
        idx = -1 if i < 2 else i % 3
        state, metrics, aux = step(state, gt, q, t, cam.K, 3, idx)
        checks = [metrics["loss"], state.pose_deltas]
        if idx >= 0:
            checks += [aux["grad_q"], aux["grad_t"], aux["grad_pose"]]
        assert all(bool(torch.isfinite(c).all()) for c in checks), i
        deltas.append(float(state.pose_deltas.abs().max()))
    assert deltas[:2] == [0.0, 0.0] and deltas[2] > 0
    after = launches()
    per_step = {k: (after[k] - before[k]) / 20 for k in after}
    # the pose step keeps autograd's tape of the attributes
    assert per_step == dict(point_attributes=0, point_attributes_vjp=0,
                            slot_keys=1, sorted_table=1, tile_ranges=1,
                            blend_forward=1, blend_backward=1,
                            segment_reduce_sorted=1)
    gt, q, t = views[0]
    got = step(state, gt, q, t, cam.K, 3, 0)[2]["grad_pose"].double()
    with plain_route():
        want = step(state, gt, q, t, cam.K, 3, 0)[2]["grad_pose"].double()
    assert float((got - want).norm() / want.norm()) <= 1e-3


class MemoryViews:
    """ImagePoseDataset's interface over DatasetItems held in memory."""

    def __init__(self, items):
        self.items = items
        self.records = [{"camera_height": it.camera_info.camera_height,
                         "camera_width": it.camera_info.camera_width}
                        for it in items]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def loop_views(dev, count=8):
    """``count`` DatasetItems at 960x544 rendered at ``poses(count)`` from
    a second seeded scene and quantized to 8 bits as a PNG decode gives
    them."""
    xyz, feats, invalid = (torch.from_numpy(a).to(dev)
                           for a in make_truck_scene(N, seed=1))
    qs, ts = se3_to_qt(torch.from_numpy(poses(count)).to(dev))
    cam = card_camera(dev)
    cfg = R.RasterizerConfig(rgb_only=True, tile_size=TILE)
    return [DatasetItem(
        image=_to_u8(R.rasterize(xyz, feats, invalid, qs[i], ts[i], cam,
                                 cfg).rgb).cpu().numpy().astype(np.float32)
        / 255.0,
        q_pointcloud_camera=qs[i].cpu().numpy(),
        t_pointcloud_camera=ts[i].cpu().numpy(),
        camera_info=CameraInfo(K_NP.copy(), H, W, 0), index=i)
        for i in range(count)]


def loop_config(log_dir, **over):
    """40 iterations, downsample factor 2 for the first 20, SH bands 0-3,
    warm-up 10, densify every 10 with a threshold that fills the free
    slots, an alpha reset at 25, a validation at 20; a pool of 1.25x the
    scene's points."""
    d = {
        "num_iterations": 40, "val_interval": 20,
        "initial_downsample_factor": 2, "half_downsample_factor_interval": 20,
        "increase_color_max_sh_band_interval": 10,
        "log_loss_interval": 10, "log_metrics_interval": 20,
        "num_data_threads": 2, "summary_writer_log_dir": str(log_dir),
        "rasterisation_config": {"tile_size": TILE},
        "adaptive_controller_config": {
            "num_iterations_warm_up": 10, "num_iterations_densify": 10,
            "num_iterations_reset_alpha": 25,
            "densification_view_space_position_gradients_threshold": 1e-12,
        },
        "gaussian_point_cloud_scene_config": {"max_num_points_ratio": 1.25},
    }
    d.update(over)
    return from_dict(d)


def trainer_class(views, scene):
    """The stock trainer with 6 train and 2 val views in memory and the
    scene from its arrays; scene files as .ply where no parquet writer is
    installed."""
    xyz, feats = scene

    class CardTrainer(T.GaussianPointCloudTrainer):
        def _load_datasets(self):
            return MemoryViews(views[:6]), MemoryViews(views[6:])

        def _load_scene(self):
            return scene_lib.create_scene(
                xyz, self.config.gaussian_point_cloud_scene_config,
                features=feats, device=self.device)

        def _save_scene(self, scene_, path):
            try:
                scene_lib.to_parquet(scene_, path)
            except ImportError:
                scene_lib.to_ply(scene_, str(Path(path).with_suffix(".ply")))
    return CardTrainer


def held_gib():
    """What the process holds on the card (after the allocator's free
    cache is returned), GiB."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2 ** 30


def record_calls(trainer, memory=False):
    """Rows appended by each step or window call of the trainer: size, SH
    band, capacity, whether it is a window, whether its losses are finite,
    whether it captured a graph, the graphs every cached step holds after
    it, and with ``memory`` the memory held before and after."""
    rows = []
    get_step = trainer._get_step

    def recorded(h, w, scan_steps=0):
        fn = get_step(h, w, scan_steps)

        def call(state, *a):
            row = {"size": (h, w), "sh_band": int(a[4]),
                   "key_cap": trainer._key_cap, "window": scan_steps > 0}
            if memory:
                row["held_before"] = held_gib()
            captures = getattr(fn, "captures", 0)
            out = fn(state, *a)
            row.update(
                finite=bool(torch.isfinite(out[1]["loss"]).all()),
                captured=getattr(fn, "captures", 0) > captures,
                graphs_held=sum(len(getattr(f, "graphs", {}))
                                for f in trainer._step_cache.values()))
            if memory:
                row["held_after"] = held_gib()
            rows.append(row)
            return out
        return call

    trainer._get_step = recorded
    return rows


@pytest.mark.parametrize("spd, group", [(1, False), (8, False), (8, True)],
                         ids=["steps", "windows", "nccl-windows"])
def test_the_train_loop_on_the_card(dev, scene, plain_calls, monkeypatch,
                                    tmp_path, spd, group):
    """``train()`` at full width with ``steps_per_dispatch`` 1 and 8, and 8
    with ``multihost`` in a process group of one over NCCL (data-parallel
    windows, each one graph holding its collectives): every iteration run
    with finite losses and no plain version; with 1, one step a launch of
    K4, K5 and the attribute VJP, the forward kernels once more a
    validation frame, a densify round that changes the valid points, the
    scene and checkpoint files written; with 8, windows each holding one
    graph, one capture a (size, SH band, capacity); then a fresh trainer
    resumed from ``checkpoint_latest`` holds the saved state, the
    generator's state (1) and the capacity (8)."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    over = dict(steps_per_dispatch=spd)
    if group:
        over.update(multihost=True, num_processes=1, process_id=0,
                    coordinator_address=f"127.0.0.1:{mh.free_port()}")
    try:
        _train_loop(dev, scene, plain_calls, monkeypatch, tmp_path, spd,
                    over)
        if group:
            assert mh.dist.get_backend() == "nccl"
    finally:
        mh.shutdown()
    assert not mh.dist.is_initialized() and mh.live_windows() == []


def _train_loop(dev, scene, plain_calls, monkeypatch, tmp_path, spd, over):
    views = loop_views(dev)
    Trainer = trainer_class(views, scene)
    trainer = Trainer(loop_config(tmp_path, **over), device=dev)
    rows = record_calls(trainer)
    rounds = []
    apply = trainer.densify_apply

    def densify_apply(scene_, info, generator):
        new = apply(scene_, info, generator)
        rounds.append((int(scene_.num_valid()), int(new[0].num_valid())))
        return new

    trainer.densify_apply = densify_apply
    saves = {}
    save = checkpoint.save_checkpoint

    def recorded_save(path, state, meta):
        save(path, state, meta)
        # a window's state lives in its graph's buffers, which later
        # replays overwrite: keep a copy of what was saved
        saves.update(leaves=[t.clone() for t in
                             checkpoint.state_leaves(state)], meta=meta)

    monkeypatch.setattr(checkpoint, "save_checkpoint", recorded_save)
    before = launches()
    state = trainer.train()
    after = launches()
    ran = {k: after[k] - before[k] for k in after}
    assert sum(8 if r["window"] else 1 for r in rows) == 40
    assert all(r["finite"] for r in rows)
    assert not any(plain_calls.values()), plain_calls
    assert bool(torch.isfinite(state.scene.features).all())
    if spd == 1:
        assert not any(r["window"] for r in rows)
        assert ran["blend_backward"] == ran["segment_reduce_sorted"] == 40
        assert ran["point_attributes_vjp"] == 40
        # the steps' and the validation frames' renders
        frames = ran["blend_forward"]
        assert frames > 40 and ran["point_attributes"] >= frames
        assert all(ran[k] == frames for k in ("slot_keys", "sorted_table",
                                              "tile_ranges"))
        assert any(a != b for a, b in rounds), rounds
        files = {p.name for p in tmp_path.iterdir()}
        assert "checkpoint_latest" in files
        assert any(n.startswith("scene_") for n in files), files
    else:
        windows = [r for r in rows if r["window"]]
        assert len(windows) >= 2
        assert all(r["graphs_held"] == 1 for r in windows), windows
        keys = {(r["size"], r["sh_band"], r["key_cap"]) for r in windows}
        assert sum(r["captured"] for r in windows) == len(keys), windows
    saved_it = int(saves["meta"]["iteration"])
    resumed = Trainer(loop_config(
        tmp_path / "resumed", num_iterations=saved_it + 1,
        resume_from=str(tmp_path / "checkpoint_latest"), **over), device=dev)
    restored = resumed.train()
    for a, b in zip(checkpoint.state_leaves(restored), saves["leaves"]):
        assert torch.equal(a, b)
    if spd == 1:
        assert (resumed.generator.get_state().tolist()
                == saves["meta"]["rng_state"])
    else:
        assert resumed._key_cap == saves["meta"]["key_cap"]


def test_windows_replay_after_densify_and_recapture_at_a_band_change(
        dev, scene, tmp_path):
    """49 iterations in windows of 8: windows 1-2 at SH band 0 and 3-4 at
    band 1 at 480x256, densify rounds before windows 2 and 4, window 5 at
    960x544. Windows 2 and 4 replay their cached graph after the densify
    round; window 3's band change releases window 2's graph and captures
    anew, and the memory held before window 4 is less than half a graph's
    more than before window 2; one graph held after every window."""
    trainer = trainer_class(loop_views(dev), scene)(loop_config(
        tmp_path, steps_per_dispatch=8, num_iterations=49, val_interval=40,
        half_downsample_factor_interval=33,
        increase_color_max_sh_band_interval=17,
        adaptive_controller_config={
            "num_iterations_warm_up": 8, "num_iterations_densify": 8,
            "num_iterations_reset_alpha": 1000,
            "densification_view_space_position_gradients_threshold": 1e-12}),
        device=dev)
    rows = record_calls(trainer, memory=True)
    densify_after = []
    apply = trainer.densify_apply

    def densify_apply(scene_, info, generator):
        densify_after.append(sum(r["window"] for r in rows))
        return apply(scene_, info, generator)

    trainer.densify_apply = densify_apply
    gc.collect()
    held0 = held_gib()
    state = trainer.train()
    windows = [r for r in rows if r["window"]]
    sizes = sorted({r["size"] for r in windows})
    assert [(sizes.index(r["size"]), r["sh_band"]) for r in windows] == [
        (0, 0), (0, 0), (0, 1), (0, 1), (1, 2)]
    assert [r["captured"] for r in windows] == [True, False, True, False,
                                                True]
    assert all(r["graphs_held"] == 1 for r in windows)
    assert {1, 3} <= set(densify_after), densify_after
    before = [r["held_before"] for r in windows]
    assert before[3] - before[1] < 0.5 * (before[1] - held0), windows
    assert bool(torch.isfinite(state.scene.features).all())


# Two ranks sharing the card: each a process that
# ``multihost.run_local_ranks`` spawns, which imports ``two_rank_paths``
# from this module; ranks that share a card run over gloo. Each rank counts
# its own launches, so the counts below are a rank's.

TP_H, TP_W = 1088, 1920  # Truck's frame cropped to 32-px tiles: 2 bands of 17
WINDOW_STEPS = 4         # the data-parallel window's steps on two ranks
GLOO_LOOP_ITERS = 20     # train() on two ranks in windows of 8
RENDER_KERNELS = ("slot_keys", "sorted_table", "tile_ranges",
                  "blend_forward")


def digest(state) -> str:
    """A hash of every leaf of the state: equal on ranks that agree bit for
    bit."""
    import hashlib

    h = hashlib.sha256()
    for leaf in checkpoint.state_leaves(state):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def compared_leaves(state) -> dict:
    return {"features": state.scene.features, "xyz": state.scene.xyz,
            "feat_mu": state.feat_opt.mu, "pos_mu": state.pos_opt.mu,
            "num_in_camera": state.ctrl.num_in_camera}


def gates(got, want, names=("features", "xyz", "feat_mu", "pos_mu")) -> dict:
    a, b = compared_leaves(got), (want if isinstance(want, dict)
                                  else compared_leaves(want))
    return {k: gate_excess(a[k], b[k]) for k in names}


def since(before) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def window_rows(views, rows):
    """(images f32, qs, ts, Ks), each (steps, len(row), ...): step s takes
    the views ``rows[s]``, the targets widened to f32 as the trainer stages
    a data-parallel dispatch's."""
    def take(i):
        return torch.stack([torch.stack([views[v][i] for v in row])
                            for row in rows])
    return [take(0).to(torch.float32) * (1.0 / 255.0), take(1), take(2),
            take(3)]


def window_views(dev, scene):
    """The setup's start state and ``2 * WINDOW_STEPS`` views (target, q,
    t, K) at ``poses()``, and the capacity that fits the largest key total
    of their exact steps taken in turn from that state."""
    config, step, state, inputs = train_setup(dev, scene)
    K = inputs[3]
    views = [(gt, q, t, K) for gt, q, t in view_targets(
        state, scene[1], card_camera(dev), range(2 * WINDOW_STEPS))]
    s, totals = state, []
    for gt, q, t, _ in views:
        s, m, _ = step(s, gt, q, t, K, 3)
        totals.append(int(m["num_keys"]))
    return config, state, views, T.fit_key_cap(max(totals))


def window_reference(dev, scene, path):
    """``WINDOW_STEPS`` capped data-parallel steps with no process group,
    each on both rows (2s, 2s + 1), saved to ``path``; returns the
    capacity."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    config, state, views, cap = window_views(dev, scene)
    dp = make_dp_train_step(config, H, W, device=dev, key_cap=cap)
    rows = window_rows(views, [[2 * s, 2 * s + 1]
                               for s in range(WINDOW_STEPS)])
    losses = []
    for s in range(WINDOW_STEPS):
        state, m, _ = dp(state, *(x[s] for x in rows), 3)
        losses.append(float(m["loss"]))
    torch.save({**compared_leaves(state), "losses": losses}, path)
    return cap


def two_rank_paths(ply, cap, ref_path):
    """This rank's part of every path of two ranks on the card, in one
    process (a process takes seconds to reach the card); returns what
    ``test_two_ranks_sharing_the_card_match_the_single_device_paths``
    holds to its gates."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import mh_smoke
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    R.pin_f32_matmul()
    dev, rank = mh.rank_device("cuda"), mh.rank()
    out = {"backend": mh.dist.get_backend()}
    before = launches()
    out["mh_smoke"] = mh_smoke.run_worker(None, 2, rank, 2, None,
                                          device="cuda")
    out["mh_smoke"]["launches"] = since(before)
    scene = make_truck_scene(N)[:2]
    config, step, start, inputs = train_setup(dev, scene)
    gt, q, t, K, band = inputs
    dp = make_dp_train_step(config, H, W, device=dev)

    # both ranks on the same view, 3 steps, against 3 single steps
    s, ref = start, start
    for _ in range(3):
        s, m, _ = dp(s, gt[None], q[None], t[None], K[None], band)
        ref, _, _ = step(ref, *inputs)
    out["same_view"] = {
        "digest": digest(s), "gates": gates(s, ref),
        "num_in_camera_doubled": bool(torch.equal(
            s.ctrl.num_in_camera, 2 * ref.ctrl.num_in_camera))}

    # rank r on view r
    (gt_r, q_r, t_r), = view_targets(start, scene[1], card_camera(dev),
                                     [rank])
    s, before = start, launches()
    for _ in range(3):
        s, m, _ = dp(s, gt_r[None], q_r[None], t_r[None], K[None], band)
    out["own_view"] = {"digest": digest(s), "launches": since(before),
                       "finite": bool(torch.isfinite(m["loss"]))}
    del s, ref, dp, m
    out["window"] = _gloo_window(dev, scene, rank, cap, ref_path)
    out["band_step"] = _band_step(dev, scene)
    out["render"] = _render_modes(ply)
    out["loop"] = _gloo_loop(dev, scene)
    return out


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _gloo_window(dev, scene, rank, cap, ref_path):
    """A data-parallel window of WINDOW_STEPS steps at ``cap``, step s on
    view 2s + rank, from the start state of ``window_reference``."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    _free()
    config, start, views, fitted = window_views(dev, scene)
    window = make_dp_train_step(config, H, W, device=dev,
                                scan_steps=WINDOW_STEPS, key_cap=cap)
    rows = window_rows(views, [[2 * s + rank] for s in range(WINDOW_STEPS)])
    before = launches()
    new, m, _ = window(start, *rows, 3)
    ref = torch.load(ref_path, map_location=dev)
    return {"mode": window.mode, "captures": window.captures,
            "graphs": len(window.graphs), "cap": fitted,
            "launches": since(before), "digest": digest(new),
            "losses": [float(v) for v in m["loss"]],
            "ref_losses": ref["losses"], "gates": gates(new, ref),
            "num_in_camera_equal": bool(torch.equal(
                new.ctrl.num_in_camera, ref["num_in_camera"]))}


def _band_step(dev, scene):
    """The band-parallel step at TP_W x TP_H against the single-device
    step at that size, from one state on one view."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (
        make_tp_train_step,
    )

    _free()
    config, step, start, inputs = train_setup(dev, scene, TP_H, TP_W)
    tp = make_tp_train_step(config, TP_H, TP_W, device=dev)
    before = launches()
    new, metrics, aux = tp(start, *inputs)
    ran = since(before)
    single, m1, aux1 = step(start, *inputs)
    return {"band_keys": int(aux["band_keys"]), "launches": ran,
            "digest": digest(new),
            "grad_gates": {k: gate_excess(aux[k], aux1[k])
                           for k in ("grad_features", "grad_xyz")},
            "mu_gates": gates(new, single, ("feat_mu", "pos_mu")),
            "num_in_camera_equal": bool(torch.equal(
                new.ctrl.num_in_camera, single.ctrl.num_in_camera)),
            "pred_max_abs": float((aux["pred"] - aux1["pred"]).abs().max()),
            "losses": [float(metrics["loss"]), float(m1["loss"])]}


def _render_modes(ply):
    """``apps/render.py``'s renderer over ``poses(9)``, pose-sharded and
    band-split: each mode's uint8 frames and launches; then the band
    render's float frames against this rank's single-device render."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps import render
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (
        rasterize_band_sharded,
    )

    _free()
    res = {}
    for mode in ("data_parallel", "tile_parallel"):
        renderer = render.GaussianPointRenderer(render.RendererConfig(
            parquet_paths=[ply], image_height=H, image_width=W,
            camera_intrinsics=K_NP, **{mode: True}), poses(9),
            device="cuda")
        before = launches()
        frames = dict(renderer.frames())
        ran = since(before)
        res[mode] = {"frames": frames,
                     "launches": {k: ran[k] for k in RENDER_KERNELS}}
    s = renderer.scene
    qs, ts = render.se3_to_qt(renderer.poses)
    worst = {"rgb": 0.0}
    for i in range(len(qs)):
        out = rasterize_band_sharded(s.xyz, s.features, s.invalid, qs[i],
                                     ts[i], renderer.camera, renderer.rcfg,
                                     point_object_id=s.object_id)
        worst["rgb"] = max(worst["rgb"], float((torch.clamp(
            out.rgb, 0.0, 1.0) - renderer.render(qs[i], ts[i])).abs().max()))
    full = R.RasterizerConfig(tile_size=TILE)
    out = rasterize_band_sharded(s.xyz, s.features, s.invalid, qs[1], ts[1],
                                 renderer.camera, full,
                                 point_object_id=s.object_id)
    ref = R.rasterize(s.xyz, s.features, s.invalid, qs[1], ts[1],
                      renderer.camera, full, point_object_id=s.object_id)
    for f in ("alpha", "depth"):
        worst[f] = float((getattr(out, f) - getattr(ref, f)).abs().max())
    worst["count_differs"] = int((out.count != ref.count).sum())
    res["band_float"] = worst
    return res


def _gloo_loop(dev, scene):
    """``train()`` with ``data_parallel_devices: 2`` and windows of 8 for
    GLOO_LOOP_ITERS iterations, in this rank of the group."""
    import tempfile

    _free()
    Trainer = trainer_class(loop_views(dev), scene)
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = Trainer(loop_config(
            log_dir, steps_per_dispatch=8, data_parallel_devices=2,
            num_iterations=GLOO_LOOP_ITERS), device=dev)
        rows = record_calls(trainer)
        state = trainer.train()
    return {"calls": rows, "digest": digest(state),
            "finite": bool(torch.isfinite(state.scene.features).all())}


def test_two_ranks_sharing_the_card_match_the_single_device_paths(
        dev, scene, tmp_path):
    """Two ranks on the one card (gloo), each a spawned process:

    - ``parallel/mh_smoke.py``'s worker against its one-process
      reference: losses within rtol 1e-5, first moments in the gradient
      gate, visibility counts exact, the ranks' features equal, every
      kernel 8 times (2 steps of 4 rows);
    - the data-parallel step, both ranks on one view for 3 steps: states
      equal across the ranks and within the gradient gate of 3
      single-device steps, ``num_in_camera`` doubled; each rank on its
      own view: states equal, every kernel once a step;
    - a data-parallel window of 4 steps (eager over gloo, no graph) at the
      capacity fitted in this process: states equal across the ranks,
      losses within rtol 1e-5 and the state within the gradient gate of
      the same steps with both rows on one device;
    - the band-parallel step at 1920x1088 against the single-device
      step: states equal, gradients and first moments in the gate,
      ``num_in_camera`` equal, the frame within 1e-4, each band with
      keys, every kernel once;
    - the render app pose-sharded (each rank its poses, uint8 frames equal
      to the single-device app's, K1-K3 at the graph's warm-up and capture
      alone) and band-split (all frames on rank 0, K1-K3 once a frame;
      float frames within 1e-4, depth 5e-4, count equal on all but 0.01%
      of the pixels);
    - ``train()`` with ``data_parallel_devices: 2`` in windows of 8:
      the same calls on both ranks, eager, finite, states equal."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps import render
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import mh_smoke
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    xyz, feats = scene
    ply = str(tmp_path / "scene.ply")
    scene_lib.to_ply(scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                            features=feats, device="cpu"),
                     ply)
    renderer = render.GaussianPointRenderer(render.RendererConfig(
        parquet_paths=[ply], image_height=H, image_width=W,
        camera_intrinsics=K_NP), poses(9), device="cuda")
    frames = dict(renderer.frames())
    renderer.graph.release()
    mh_ref = mh_smoke.single_process_reference(2, device="cuda")
    ref_path = str(tmp_path / "window.pt")
    cap = window_reference(dev, scene, ref_path)
    del renderer
    _free()
    ranks = mh.run_local_ranks(two_rank_paths, 2, args=(ply, cap, ref_path),
                               device="cuda", timeout_s=900)
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    every = lambda n: {k: n for k in KERNELS}  # noqa: E731

    got, other = (r["mh_smoke"] for r in ranks)
    np.testing.assert_allclose(got["losses"], mh_ref["losses"], rtol=1e-5,
                               atol=0)
    for k in ("feat_mu", "pos_mu"):
        # Adam's first moments over 1 - b1, on the gradients' scale
        assert gate_excess(torch.from_numpy(got[k]) / 0.1,
                           torch.from_numpy(mh_ref[k]) / 0.1) <= 0, k
    assert np.array_equal(got["num_in_camera"], mh_ref["num_in_camera"])
    assert np.array_equal(other["features"], got["features"])
    assert got["launches"] == other["launches"] == every(
        2 * mh_smoke.TOTAL_DEVICES // 2)

    a, b = (r["same_view"] for r in ranks)
    assert a["digest"] == b["digest"]
    assert max(a["gates"].values()) <= 0, a["gates"]
    assert a["num_in_camera_doubled"]
    a, b = (r["own_view"] for r in ranks)
    assert a["digest"] == b["digest"] and a["finite"]
    assert a["launches"] == b["launches"] == every(3)

    a, b = (r["window"] for r in ranks)
    assert a["digest"] == b["digest"]
    for w in (a, b):
        assert (w["mode"], w["captures"], w["graphs"]) == ("eager", 0, 0)
        assert w["cap"] == cap
        assert w["launches"] == every(WINDOW_STEPS)
    np.testing.assert_allclose(a["losses"], a["ref_losses"], rtol=1e-5,
                               atol=0)
    assert max(a["gates"].values()) <= 0, a["gates"]
    assert a["num_in_camera_equal"]

    a, b = (r["band_step"] for r in ranks)
    assert a["digest"] == b["digest"]
    assert max(a["grad_gates"].values()) <= 0, a["grad_gates"]
    assert max(a["mu_gates"].values()) <= 0, a["mu_gates"]
    assert a["num_in_camera_equal"]
    assert a["pred_max_abs"] <= 1e-4, a["pred_max_abs"]
    for x in (a, b):
        assert x["band_keys"] >= 1
        assert x["launches"] == every(1)

    a, b = (r["render"] for r in ranks)
    sharded = {**a["data_parallel"]["frames"], **b["data_parallel"]["frames"]}
    assert sorted(a["data_parallel"]["frames"]) == [0, 2, 4, 6, 8]
    assert sorted(sharded) == sorted(frames)
    assert all(np.array_equal(sharded[i], frames[i]) for i in frames)
    assert sorted(a["tile_parallel"]["frames"]) == sorted(frames)
    assert b["tile_parallel"]["frames"] == {}
    assert all(f.shape == (H, W, 3)
               for f in a["tile_parallel"]["frames"].values())
    fl = a["band_float"]
    assert fl["rgb"] <= 1e-4 and fl["alpha"] <= 1e-4, fl
    assert fl["depth"] <= 5e-4 and fl["count_differs"] <= 1e-4 * H * W, fl
    for x in (a, b):
        assert x["data_parallel"]["launches"] == {
            k: 2 for k in RENDER_KERNELS}
        assert x["tile_parallel"]["launches"] == {
            k: len(frames) for k in RENDER_KERNELS}

    a, b = (r["loop"] for r in ranks)
    assert a["calls"] == b["calls"] and a["digest"] == b["digest"]
    assert a["finite"] and any(c["window"] for c in a["calls"])
    assert all(c["finite"] and not c["captured"] and c["graphs_held"] == 0
               for c in a["calls"]), a["calls"]


def write_views(tmp: Path, count: int, dev):
    """A dataset .json of ``count`` PNG views at 960x544 (``loop_views``,
    at ``poses(count)``)."""
    from PIL import Image

    Ts = poses(count)
    records = []
    for i, item in enumerate(loop_views(dev, count)):
        path = tmp / f"view_{i}.png"
        Image.fromarray(np.round(item.image * 255).astype(np.uint8),
                        "RGB").save(path)
        records.append({"image_path": str(path),
                        "T_pointcloud_camera": Ts[i].tolist(),
                        "camera_intrinsics": K_NP.tolist(),
                        "camera_height": H, "camera_width": W,
                        "camera_id": 0})
    path = tmp / "views.json"
    path.write_text(json.dumps(records))
    return path


def test_the_inference_benchmark_replays_the_exact_frames(
        dev, scene, plain_calls, tmp_path):
    """``tools/inference_benchmark.py`` in its reference protocol (1000
    warm-up and 100 timed frames) on the scene as a .ply over a dataset
    .json of 8 PNG views at 960x544: one graph for the one (H, W) bucket,
    K1a (in its capped mode), K1b, K2 and K3 launched at its warm-up and
    capture alone, no plain version, no frame past the capacity, and every
    view's replayed frame the exact eager frame bit for bit; then
    ``tools/profile_attribution.py --rgb-only --fit-cap`` reads device
    time from its trace."""
    from taichi_3d_gaussian_splatting_tpu_torch.tools import (
        inference_benchmark as ib,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.tools import (
        profile_attribution as pa,
    )

    xyz, feats = scene
    ply = str(tmp_path / "scene.ply")
    scene_lib.to_ply(scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                            features=feats, device="cpu"),
                     ply)
    args = ib.parse_args(["--scene", ply, "--dataset",
                          str(write_views(tmp_path, 8, dev)),
                          "--save_image", str(tmp_path / "frame.png")])
    assert (args.warmup, args.iters) == (1000, 100)
    before = launches()
    capped = expand.slot_keys.capped_launches
    rec, bench = ib.run(args)
    after = launches()
    ran = {k: after[k] - before[k] for k in after}
    ran.pop("point_attributes")  # the capacity fit's probes launch it too
    assert ran == dict(point_attributes_vjp=0, slot_keys=2, sorted_table=2,
                       tile_ranges=2, blend_forward=2, blend_backward=0,
                       segment_reduce_sorted=0)
    assert expand.slot_keys.capped_launches - capped == 2
    assert not any(plain_calls.values()), plain_calls
    assert rec["graphs"] == [(H, W)] and rec["frames_over_cap"] == 0
    s = bench.scene
    for i, (hw, q, t, K) in enumerate(bench.items):
        exact = R.rasterize(s.xyz, s.features, s.invalid, q, t,
                            R.Camera(K=K, width=hw[1], height=hw[0]),
                            bench.rcfg, sh_max_band=3,
                            point_object_id=s.object_id).rgb
        assert torch.equal(bench.render(i), exact), i
    assert int(bench.over_cap) == 0
    bench.release()
    prof = pa.main(["--rgb-only", "--fit-cap", "--out",
                    str(tmp_path / "trace")])
    assert prof["device_ms_per_run"] > 0


@pytest.mark.slow
def test_the_quality_gate_lands_in_the_jax_band(dev, plain_calls, tmp_path):
    """``tools/quality_run.py``'s default preset in full: 2001 iterations of
    the stock trainer in windows of 10 steps over 48 views at 256 px of
    its procedural scene. The best val PSNR lies within 0.5 dB of the JAX
    package's 27.07-27.222 on a TPU v5e (RESULTS.md), the final valid
    points reach 36,000 (JAX: 40,000); every kernel launched, no plain
    version, every loss finite, one graph held after every window."""
    from taichi_3d_gaussian_splatting_tpu_torch.tools import quality_run as qr

    args = qr.parse_args(["--out", str(tmp_path), "--device", "cuda"])
    qr.write_dataset(args.out, qr.make_dataset(args))
    trainer = T.GaussianPointCloudTrainer(from_dict(qr.config_dict(args)),
                                          device=dev)
    before = launches()
    rec = qr.train(trainer, args.iterations)
    after = launches()
    assert 26.57 <= rec["best_val_psnr"] <= 27.72, rec["best_val_psnr"]
    assert rec["final_valid_points"] >= 36_000
    assert all(after[k] > before[k] for k in after), (before, after)
    assert not any(plain_calls.values()), plain_calls
    assert rec["nonfinite_losses"] == 0
    assert rec["steps_run"] == args.iterations
    assert rec["windows"] and rec["graphs_held"] == [1]
    assert bool(torch.isfinite(rec["state"].scene.features).all())
