"""The port's dataset (``data/dataset.py``) against the JAX package's, on
PNGs written in tmp_path: every item (image, q, t, K, crop), the >1600 px
resize, ``downsample_item`` and the ``PrefetchLoader`` order, exactly."""
import json

import numpy as np
import pytest

pytest.importorskip("jax")
from PIL import Image  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.data import dataset as jds  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.data import dataset as tds  # noqa: E402


def _pose(i):
    a = 0.1 * i
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = [0.1 * i, -0.05 * i, 0.2]
    return T


@pytest.fixture(scope="module")
def dataset_json(tmp_path_factory):
    """Six views: RGB at the tile multiple, RGB and grey to be cropped,
    RGBA and palette images (converted to RGB), and one over 1600 px wide
    (resized)."""
    tmp = tmp_path_factory.mktemp("views")
    rng = np.random.default_rng(0)
    shapes = [(64, 64, "RGB"), (70, 50, "RGB"), (45, 96, "L"),
              (64, 40, "RGBA"), (33, 65, "P"), (40, 1700, "RGB")]
    records = []
    for i, (h, w, mode) in enumerate(shapes):
        chans = {"RGB": 3, "RGBA": 4}.get(mode, 1)
        arr = rng.integers(0, 256, (h, w, chans)).astype(np.uint8)
        img = Image.fromarray(arr[..., 0] if chans == 1 else arr,
                              "L" if chans == 1 else mode)
        if mode == "P":
            img = img.convert("P")
        path = tmp / f"{i}.png"
        img.save(path)
        K = [[60.0 + i, 0.0, w / 2], [0.0, 61.0, h / 2], [0.0, 0.0, 1.0]]
        records.append({
            "image_path": str(path), "T_pointcloud_camera": _pose(i).tolist(),
            "camera_intrinsics": K, "camera_height": h + 2 * (i == 1),
            "camera_width": w, "camera_id": i % 2})
    path = tmp / "views.json"
    path.write_text(json.dumps(records))
    return str(path)


def _same_item(a, b):
    assert a.index == b.index
    for name in ("image", "q_pointcloud_camera", "t_pointcloud_camera"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    ca, cb = a.camera_info, b.camera_info
    assert (ca.camera_height, ca.camera_width, ca.camera_id) == (
        cb.camera_height, cb.camera_width, cb.camera_id)
    np.testing.assert_array_equal(ca.camera_intrinsics, cb.camera_intrinsics)


@pytest.mark.parametrize("tile", [32, 16])
def test_items_match_jax(dataset_json, tile):
    j = jds.ImagePoseDataset(dataset_json, tile_size=tile)
    t = tds.ImagePoseDataset(dataset_json, tile_size=tile)
    assert len(t) == len(j) == 6
    for i in range(len(t)):
        item = t[i]
        _same_item(item, j[i])
        h, w = item.image.shape[:2]
        assert h % tile == 0 and w % tile == 0 and h > 0 and w > 0
        assert t[i] is item  # served from the decoded-item cache
    assert t[5].image.shape[1] <= jds.MAX_RESOLUTION_TRAIN  # resized


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_matches_jax(dataset_json, factor):
    j = jds.ImagePoseDataset(dataset_json, tile_size=16)
    t = tds.ImagePoseDataset(dataset_json, tile_size=16)
    for i in (0, 2, 5):
        _same_item(tds.downsample_item(t[i], factor, 16),
                   jds.downsample_item(j[i], factor, 16))
    assert tds.downsample_item(t[0], 1, 16) is t[0]


@pytest.mark.parametrize("shuffle, loop, seed", [(True, True, 0),
                                                 (True, True, 5),
                                                 (False, False, 0)])
def test_loader_order_matches_jax(dataset_json, shuffle, loop, seed):
    kw = dict(shuffle=shuffle, loop=loop, num_threads=3, seed=seed,
              prefetch=4)
    j = jds.PrefetchLoader(jds.ImagePoseDataset(dataset_json), **kw)
    t = tds.PrefetchLoader(tds.ImagePoseDataset(dataset_json), **kw)
    take = 20 if loop else 6
    jit, tit = iter(j), iter(t)
    got = [next(tit) for _ in range(take)]
    want = [next(jit) for _ in range(take)]
    tit.close()
    jit.close()
    assert [g.index for g in got] == [w.index for w in want]
    for g, w in zip(got, want):
        _same_item(g, w)
    if not loop:
        assert [g.index for g in got] == list(range(6))
        assert list(tds.PrefetchLoader(tds.ImagePoseDataset(dataset_json),
                                       **kw)) != []


def test_missing_column_raises(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps([{"image_path": "x.png"}]))
    with pytest.raises(ValueError, match="T_pointcloud_camera"):
        tds.ImagePoseDataset(str(path))
