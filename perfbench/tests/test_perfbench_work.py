"""The frozen work counts, held to hand-worked values on a 64x64,
200-point frame."""
import math

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.reference import splat


def frame_64():
    """A 64x64 frame (2x2 tiles of 32 px) of a 200-point scene."""
    xyz, feats = inputs.truck_scene(200, 7, "cpu")
    # pull the points in front of the camera and widen the splats so that
    # pixels stop and keys overlap
    xyz = xyz * torch.tensor([0.2, 0.2, 0.3]) + torch.tensor([0.0, 0.0, 1.0])
    feats[:, 4:7] += 1.5
    feats[:, 7] += 3.0
    view = splat.View(torch.eye(4), torch.as_tensor(
        inputs.intrinsics(64, 64, 60.0)), 64, 64)
    return xyz, feats, view


def loop_counts(xyz, feats, view):
    """The pairs walked, blended and the live keys, one pixel at a time
    over its tile's sorted keys (the plain semantics, no vectors)."""
    at = splat.attributes(xyz, feats, view)
    keys = splat.tile_keys(at, view, 0.4, 2000.0, 10.0, 32)
    pairs = included = 0
    live = set()
    for t in range(keys.tiles_x * keys.tiles_y):
        s, n = int(keys.start[t]), int(keys.count[t])
        x0, y0 = (t % keys.tiles_x) * 32, (t // keys.tiles_x) * 32
        for py in range(32):
            for px in range(32):
                T, walked = 1.0, 0
                for j in range(n):
                    p = int(keys.point[s + j])
                    walked += 1
                    dx = (px + 0.5) - (float(at.uv[p, 0]) - x0)
                    dy = (py + 0.5) - (float(at.uv[p, 1]) - y0)
                    a, b, c = (float(v) for v in at.conic[p])
                    q = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                    alpha = math.exp(q) * float(at.ro[p])
                    if not alpha >= 1.0 / 255.0:
                        continue
                    nxt = T * (1.0 - min(alpha, 0.99))
                    if nxt < 1e-4:
                        break
                    included += 1
                    live.add((t, j))
                    T = nxt
                pairs += walked
    return {"pairs": pairs, "included": included, "live": len(live),
            "keys": keys.total}


def test_vectorised_pairs_equal_the_pixel_walk():
    xyz, feats, view = frame_64()
    counts = {}
    splat.render(xyz, feats, view, 0.4, 2000.0, 10.0, counts=counts)
    want = loop_counts(xyz, feats, view)
    assert want["included"] > 1000 and want["pairs"] > want["included"]
    # the float32 vectors and the float64 loop may split a pixel's stop
    # differently only where T lands on 1e-4 to rounding
    for k in ("pairs", "included", "live"):
        assert abs(counts[k] - want[k]) <= 2e-3 * want[k] + 2, (k, counts,
                                                                  want)
    assert counts["keys"] == want["keys"]


def test_kernel_counts_by_hand():
    n, total, tiles, px = 200, 1000, 4, 64 * 64
    assert work.expand_keys(n, total) == (
        16 * 200 + 40 * 200 + 68 * 1000, 1000 * (2 * 8 + 45))
    assert work.tile_ranges(total, tiles) == (4000 + 20, 1000)
    assert work.blend_forward(300, tiles, px, 5000, 2000) == (
        36 * 300 + 32 + 32 * px, 16 * 5000 + 11 * 2000)
    assert work.blend_backward(300, tiles, px, 5000, 2000) == (
        36 * 300 + 32 + 24 * px + 44 * 300 + 8 * px,
        16 * 5000 + 45 * 2000)
    assert work.segment_reduce(n, total) == (
        48 * 1000 + 4000 + 1600 + 48 * 200, 12 * 1000)


def test_step_and_frame_parts_by_hand():
    counts = {"keys": 1000, "live": 300, "pairs": 5000, "included": 2000}
    frame = work.frame_parts(200, 64, 64, 32, counts)
    step = work.step_parts(200, 64, 64, 32, counts)
    assert set(frame) < set(step)
    assert frame["attributes"] == (4 * 72 * 200, 367 * 200)
    assert step["adam"] == (28 * 200 * 59, 14 * 200 * 59)
    loss_ops = 3 * 64 * 64 * 3 + (5 * 42 + 15) * 54 * 54 * 3
    assert step["loss"][1] == 2 * loss_ops
    assert work.total_ops(step) == sum(o for _, o in step.values())
    assert np.isclose(work.least_seconds(3.35e12, 0.0), 1.0)
    assert np.isclose(work.least_seconds(0.0, 67e12), 1.0)


def test_collective_bytes_are_the_data_parallel_steps():
    """``work.dp_collective_bytes`` against the collectives a data-parallel
    step of the port logs (a group of one, on the CPU)."""
    import json

    from conftest import HERE
    from taichi_3d_gaussian_splatting_tpu_torch.models.scene import (
        GaussianScene,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (  # noqa: E501
        make_dp_train_step,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        from_dict,
    )

    n = 300
    config = from_dict(json.loads((HERE / "configs" / "truck-428k.json")
                                  .read_text())["train"])
    xyz, feats = inputs.truck_scene(n, 5, "cpu")
    state = trainer.init_train_state(GaussianScene(
        xyz=xyz, features=feats, invalid=torch.zeros(n, dtype=torch.bool),
        object_id=torch.zeros(n, dtype=torch.int32)), config)
    step = make_dp_train_step(config, 64, 64, device="cpu", key_cap=4096)
    K = torch.as_tensor(inputs.intrinsics(64, 64, 60.0))
    step(state, torch.rand(1, 64, 64, 3), torch.tensor([[0.0, 0, 0, 1]]),
         torch.zeros(1, 3), K[None], 3)
    got = sum(c.numel * c.dtype.itemsize for c in step.collectives)
    assert [c.op for c in step.collectives] == ["sum", "max"]
    assert got == work.dp_collective_bytes(n)
