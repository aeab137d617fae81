"""The unbounded 360-degree training cell (``m360-bicycle-6100k``,
traffic ``train-w8-orbit``) at a small size on the CPU, and the tile
counters it reads:

- the port's window of 2 steps (``make_train_step(..., scan_steps=2,
  key_cap=)``, as the cell runs it) against the plain reference
  (``perfbench/reference/step.py``) on the orbit layout, 3,000 points at
  128x96, the last step's image included, and the image reading's
  median against a few far values and a broad shift;
- the tile counters of ``ops/tiling.py`` (recorded by ``ops/stages.py``)
  against the reference's own per-tile key counts, exactly;
- the window's outputs bit for bit the same with the counters recorded
  and without.
"""
import copy

import numpy as np
import pytest
import torch

from perfbench import cells, drive, inputs, orbit
from perfbench.reference import splat
from taichi_3d_gaussian_splatting_tpu_torch.ops import histogram
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
from taichi_3d_gaussian_splatting_tpu_torch.ops import stages

CELL = "m360-bicycle-6100k.train-w8-orbit"
SEED = 2 ** 31 + 4049
# loss_gap: the port and the reference may sum the same f32 image terms in
# other orders (SSIM's blur, the means); three seeds read 0 here. 1e-5 is
# some 80 f32 ulps of the loss, and the faults below read 1.2e-2 to 8e-2
LOSS_GAP = 1e-5
# grad_gap, change_gap: the plain kernel versions and the reference add
# the same f32 terms in other orders: three seeds read 1.7-2.5e-7 and
# 0.6-1.7e-7 here; 1e-4 leaves 400x of room for the order of the sums,
# and a fault that darkens the top half of the image by a tenth reads
# 4e-2 and 1.5e-3 (``test_a_broken_window_fails_the_comparison``)
GRAD_GAP = 1e-4
CHANGE_GAP = 1e-4
# image_median_gap (8-bit levels, the median value's |difference| of the
# last step's image against the reference's): most of this small image is
# black background, so three seeds and the faults all read 0 here; the
# number is meant for the full-size cell, whose far shell fills the frame
# (``test_image_readings_keep_a_few_far_values_out_of_the_median``)
IMAGE_MEDIAN_GAP = 1e-3


def small_cell(points=3000, width=128, height=96, focal=100.0, steps=2):
    cell = cells.load(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["points"] = points
    cell.config["views"] = {"width": width, "height": height,
                            "focal_px": focal}
    cell.traffic = dict(cell.traffic, steps_per_call=steps)
    return cell


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain kernel versions run many small torch operations; on a CPU
    shared by several test workers, threads of one test waiting on each
    other at every operation cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_readings(monkeypatch):
    stages.reset()
    # the reference in blocks of about one tile: the same sums over each
    # tile's keys, in tensors a sixteenth the size, which is most of its
    # time on a CPU
    monkeypatch.setattr(splat, "BLOCK_ELEMENTS", 2 ** 20)
    yield
    stages.reset()


def test_the_cell_loads_its_traffic_kind_and_configuration():
    cell = cells.load(CELL)
    assert cell.config["points"] == 6_100_000
    assert cell.config["sh_degree"] == 3
    assert cell.config["features_per_point"] == 56
    assert cell.views == {"width": 1216, "height": 800, "focal_px": 1000.0}
    assert cell.config["reduced"] == ["views"]
    kind = drive.driver_class(cell.kind)
    assert issubclass(kind, drive.TrainDriver)
    assert cell.traffic["steps_per_call"] == 8
    assert cell.traffic["sh_band"] == 3


def test_the_orbit_layout_keeps_its_shares_and_the_cameras_look_inward():
    xyz, feats = orbit.scene(20_000, 5, "cpu")
    assert xyz.shape == (20_000, 3) and feats.shape == (20_000, 56)
    r = torch.linalg.vector_norm(xyz, dim=1)
    ax = torch.tensor(orbit.OBJECT_AXES)
    in_object = (torch.linalg.vector_norm(xyz / ax, dim=1) <= 1.0)
    shell = r >= orbit.SHELL_RANGE[0] * 0.999
    ground = ~in_object & ~shell
    assert abs(float(in_object.float().mean()) - orbit.OBJECT_SHARE) < 0.02
    assert abs(float(ground.float().mean()) - orbit.GROUND_SHARE) < 0.02
    assert float(r[shell].max()) <= orbit.SHELL_RANGE[1] * 1.001
    # each camera sits on the orbit, level, and looks at the object's centre
    for pose in orbit.pose_set(8):
        R_wc, c = pose[:3, :3].astype(np.float64), pose[:3, 3]
        assert abs(np.linalg.norm(c) - orbit.ORBIT_RADIUS) < 1e-5
        assert c[1] == 0.0
        np.testing.assert_allclose(R_wc[:, 2], -c / np.linalg.norm(c),
                                   atol=1e-6)
        q = inputs.quaternion_xyzw(R_wc)
        np.testing.assert_allclose(splat.rotation(torch.from_numpy(
            q.astype(np.float64))).numpy(), R_wc, atol=1e-6)


def test_a_window_of_two_steps_matches_the_plain_reference():
    """The cell's timed path at a small size: the first step's relative
    loss gap, the worst leaf's gradient-norm and change-norm gaps after 2
    steps and the last step's image, against the reference from the same
    seeded state."""
    d = drive.driver_class("train-orbit")(small_cell(), SEED, "cpu")
    d.setup()
    win = d.window(0.0, calls=1)
    assert win.attempted == 2 and win.failed == 0
    got = d.check()
    assert got["loss_gap"] <= LOSS_GAP, d.detail
    assert got["grad_gap"] <= GRAD_GAP, d.detail
    assert got["change_gap"] <= CHANGE_GAP, d.detail
    assert got["image_median_gap"] <= IMAGE_MEDIAN_GAP, got
    # the state moved: the change compared is not the state left as it was
    assert min(d.detail["change_ref"].values()) > 0


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch",
                                   "state_unchanged"])
def test_a_broken_window_fails_the_comparison(fault):
    """The same window with the harness's planted faults (the image
    darkened a tenth in its top half, half the rows out of the loss, the
    state left unchanged) fails at least one of the tolerances."""
    from perfbench import calibrate

    with calibrate.FAULTS[fault]():
        d = drive.driver_class("train-orbit")(small_cell(), SEED, "cpu")
        d.setup()
        d.window(0.0, calls=1)
    got = d.check()
    assert (got["loss_gap"] > LOSS_GAP or got["grad_gap"] > GRAD_GAP
            or got["change_gap"] > CHANGE_GAP), got


@pytest.mark.parametrize("pose", [0, 3, 6])
def test_tile_counters_equal_the_references_per_tile_counts(pose):
    """One orbit view's tile counters (exact tile cull off, so every key
    of a tile's bounding box stays, as the reference keeps it): the
    heaviest tile's keys, the kept keys and the tiles that hold one, equal
    to the reference's own per-tile key counts."""
    cell = small_cell(points=4000)
    v = cell.views
    xyz, feats = orbit.scene(4000, 11, "cpu")
    K = torch.from_numpy(inputs.intrinsics(v["width"], v["height"],
                                           v["focal_px"]))
    p = torch.from_numpy(orbit.pose_set(8)[pose])
    view = splat.View(p, K, v["width"], v["height"])
    tr = cell.config["train"]["rasterisation_config"]
    at = splat.attributes(xyz, feats, view)
    ref = splat.tile_keys(at, view, tr["near_plane"], tr["far_plane"],
                          tr["depth_to_sort_key_scale"], tr["tile_size"])
    want = {"tile_keys_max": int(ref.count.max()),
            "tile_keys_kept": int(ref.count.sum()),
            "tiles_nonempty": int((ref.count > 0).sum())}
    assert want["tiles_nonempty"] >= 4  # the view holds keys in many tiles
    cfg = R.RasterizerConfig(
        near_plane=tr["near_plane"], far_plane=tr["far_plane"],
        depth_to_sort_key_scale=tr["depth_to_sort_key_scale"],
        tile_size=tr["tile_size"], exact_tile_cull=False)
    q = torch.from_numpy(inputs.quaternion_xyzw(p[:3, :3].numpy()))
    camera = R.Camera(K, v["width"], v["height"])
    invalid = torch.zeros(xyz.shape[0], dtype=torch.bool)
    for key_cap in (None, 2 ** 15):
        stages.reset()
        raw, radius = R.compute_raw_attrs(xyz, feats, q, p[:3, 3], camera)
        R.build_keys(raw, radius, invalid, camera, cfg, key_cap)
        assert stages.read().counts == want, key_cap


def test_tile_counters_follow_the_exact_cull_and_the_capacity():
    """With the exact tile cull on (the train steps') the kept keys are the
    keys below the sentinel; at a capacity under the total they are the
    keys the capacity keeps; the counters sum what ``tile_start`` /
    ``tile_end`` hold."""
    cell = small_cell(points=4000)
    v = cell.views
    xyz, feats = orbit.scene(4000, 11, "cpu")
    K = torch.from_numpy(inputs.intrinsics(v["width"], v["height"],
                                           v["focal_px"]))
    p = torch.from_numpy(orbit.pose_set(8)[0])
    q = torch.from_numpy(inputs.quaternion_xyzw(p[:3, :3].numpy()))
    camera = R.Camera(K, v["width"], v["height"])
    invalid = torch.zeros(xyz.shape[0], dtype=torch.bool)
    raw, radius = R.compute_raw_attrs(xyz, feats, q, p[:3, 3], camera)
    for key_cap in (None, 2 ** 15, 1024):
        stages.reset()
        keys, _, _ = R.build_keys(raw, radius, invalid, camera,
                                  R.RasterizerConfig(tile_size=32), key_cap)
        n = (keys.tile_end - keys.tile_start).long()
        assert stages.read().counts == {
            "tile_keys_max": int(n.max()), "tile_keys_kept": int(n.sum()),
            "tiles_nonempty": int((n > 0).sum())}
        if key_cap == 1024:
            assert int(n.sum()) <= 1024 < int(keys.total)


def test_image_readings_keep_a_few_far_values_out_of_the_median():
    """``image_median_gap``: a few values moved by many levels (a splat
    that takes another place in the blend) leave the median where it was
    and move the mean; a small shift of every value (a render one step
    lower in precision) moves the median."""
    driver = drive.driver_class("train-orbit")
    image_readings = driver.reference_numbers.__globals__["image_readings"]
    g = torch.Generator().manual_seed(5)
    want = torch.rand((96, 128, 3), generator=g)
    flips = want.clone()
    flips.view(-1)[:40] += 0.05  # 40 of 36,864 values, 12.75 levels each
    shifted = want + 0.01 / 255.0
    few, broad = image_readings(flips, want), image_readings(shifted, want)
    assert few["median"] == 0.0 and few["mean"] > 1e-2
    assert few["over_10"] == pytest.approx(40 / want.numel())
    assert broad["median"] == pytest.approx(0.01, rel=1e-3)
    assert broad["median"] > 10 * IMAGE_MEDIAN_GAP


def test_tile_counts_plain_summarizes_bounds():
    out = torch.empty(3, dtype=torch.int64)
    histogram.tile_counts(torch.tensor([0, 0, 5, 5, 12, 13],
                                       dtype=torch.int32), out)
    assert out.tolist() == [7, 13, 3]
    histogram.tile_counts(torch.zeros(1, dtype=torch.int32), out)
    assert out.tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        histogram.tile_counts(torch.zeros(3, dtype=torch.int32),
                              torch.empty(2, dtype=torch.int64))


def test_the_window_is_bit_for_bit_the_same_with_and_without_counters(
        monkeypatch):
    """The orbit window of 2 steps on the same seed twice: once recording
    the tile counters, once with ``stages.count`` doing nothing. Every
    leaf of the state and every metric is equal bit for bit."""
    def run():
        d = drive.driver_class("train-orbit")(small_cell(points=2000),
                                              SEED, "cpu")
        d.setup()
        d.window(0.0, calls=1)
        return d.state, d.first

    with_counts = run()
    counts = stages.read().counts
    assert set(counts) == set(histogram.TILE_COUNTS)
    monkeypatch.setattr(stages, "count", lambda names, fill, device: None)
    stages.reset()
    without = run()
    assert stages.read().counts == {}

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in leaves(tree[k])]
        if isinstance(tree, (tuple, list)):
            return [t for x in tree for t in leaves(x)]
        if isinstance(tree, np.ndarray):
            return [torch.from_numpy(tree)]
        return []

    a, b = leaves(with_counts), leaves(without)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert torch.equal(x, y)
