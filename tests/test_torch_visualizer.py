"""The port's viewer (``apps/visualizer.py``) against the JAX package's:
the event cases of tests/test_visualizer.py, each driven through both
viewers and their states held equal after every event (the same numpy
state machine: exactly), frames against the JAX viewer's render at the
image gate (rgb atol 1e-4), and the HTTP round trip. Two small parquets
at 64x64, on the CPU (the port's plain kernel versions, JAX's interpret
mode)."""
import io
import json
import threading
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("pandas")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.apps import visualizer as jvis  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.apps import visualizer as tvis  # noqa: E402
from tests.test_visualizer import _write_parquet  # noqa: E402

K64 = np.asarray([[60.0, 0.0, 32.0], [0.0, 60.0, 32.0], [0.0, 0.0, 1.0]],
                 np.float32)


@pytest.fixture(scope="module")
def viewers(tmp_path_factory):
    d = tmp_path_factory.mktemp("vis")
    a, b = d / "a.parquet", d / "b.parquet"
    _write_parquet(a, 24, 0, (220, 40, 40))
    _write_parquet(b, 16, 1, (40, 220, 40))
    kw = dict(parquet_paths=[str(a), str(b)], image_height=64,
              image_width=64, camera_intrinsics=K64)
    return (jvis.GaussianPointVisualizer(jvis.VisualizerConfig(**kw)),
            tvis.GaussianPointVisualizer(tvis.VisualizerConfig(**kw),
                                         device="cpu"))


@pytest.fixture(autouse=True)
def _home(viewers):
    """Each test starts both viewers from the home state."""
    for v in viewers:
        v.q = np.tile(np.asarray([0, 0, 0, 1], np.float32),
                      (v.num_objects, 1))
        v.t = np.zeros((v.num_objects, 3), np.float32)
        v.selected = 0
        v._invalid = np.asarray(v.scene.invalid).copy()
    yield


def _same_state(j, t):
    assert t.selected == j.selected
    np.testing.assert_array_equal(t.q, j.q)
    np.testing.assert_array_equal(t.t, j.t)
    np.testing.assert_array_equal(t._invalid, j._invalid)


def _jax_frame(j):
    return np.asarray(j._render(jnp.asarray(j.q), jnp.asarray(j.t),
                                jnp.asarray(j._invalid)))


EVENTS = {
    "digits": ["1", "0", "7", "2"],
    "w moves the camera": ["w", "s", "a", "d", "-", "="],
    "w moves the object with the sign flip": ["2", "w", "d", "="],
    "q and e turn": ["e", "e", "q"],
    "object turns": ["1", "e", "w"],
    "hide and show an object": ["2", "h", "p", "h"],
    "hide everything": ["h"],
    "camera drag": [(0.1, -0.05), (0.02, 0.03)],
    "object drag": ["1", (0.2, 0.1), "2", (-0.1, 0.05)],
}


@pytest.mark.parametrize("case", list(EVENTS))
def test_events_match_jax(viewers, case):
    j, t = viewers
    for ev in EVENTS[case]:
        for v in viewers:
            if isinstance(ev, tuple):
                v.handle_drag(*ev)
            else:
                v.handle_key(ev)
        _same_state(j, t)
    if case == "w moves the camera":
        np.testing.assert_allclose(t.t, 0.0, atol=1e-6)
    if case == "object drag":
        # the spun object's centre stays put in its camera frame
        c = t.object_centers[1]
        np.testing.assert_allclose(
            tvis._np_quat_rotate(tvis._np_quat_conj(t.q[1]), c - t.t[1]),
            tvis._np_quat_rotate(np.asarray([0, 0, 0, 1], np.float32), c),
            atol=1e-5)


def test_scene_layout_matches_jax(viewers):
    j, t = viewers
    assert t.num_objects == j.num_objects == 2
    assert t.object_ranges == j.object_ranges == [(0, 24), (24, 40)]
    for a, b in zip(t.object_centers, j.object_centers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.scene.object_id.numpy(),
                                  np.asarray(j.scene.object_id))
    assert (t.height, t.width) == (64, 64)
    assert tvis.VisualizerConfig().image_width == 992


def test_frames_match_jax_with_distinct_object_poses(viewers):
    j, t = viewers
    home = t.render_frame().numpy()
    for ev in ["2", "w", "e", (0.1, 0.05), "0", "d"]:
        for v in viewers:
            v.handle_drag(*ev) if isinstance(ev, tuple) else v.handle_key(ev)
    assert not np.allclose(t.q[0], t.q[1])
    got = t.render_frame().numpy()
    np.testing.assert_allclose(got, _jax_frame(j), rtol=0, atol=1e-4)
    assert got.max() > 0.1 and np.abs(got - home).max() > 0.05


def test_equal_poses_render_the_single_pose_frame(viewers):
    """With every object at one pose, the per-object frame is the
    single-pose render, bit for bit."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
        rasterize,
    )

    _, t = viewers
    t.handle_key("e")
    t.handle_key("w")
    s = t.scene
    one = rasterize(s.xyz, s.features, s.invalid, torch.from_numpy(t.q[0]),
                    torch.from_numpy(t.t[0]), t.camera, t.rcfg,
                    point_object_id=s.object_id).rgb
    assert torch.equal(t.render_frame(), torch.clamp(one, 0.0, 1.0))


def test_jpeg_frames_and_http_round_trip(viewers):
    from PIL import Image

    _, t = viewers
    server = tvis.make_server(t, 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        assert b"3DGS viewer" in urllib.request.urlopen(url + "/",
                                                        timeout=30).read()
        first = urllib.request.urlopen(url + "/frame", timeout=60).read()
        assert first[:2] == b"\xff\xd8"  # JPEG SOI
        img = Image.open(io.BytesIO(first))
        assert img.size == (64, 64)
        for body in ({"key": "2"}, {"dx": 0.1, "dy": 0.0}, {"key": "h"}):
            req = urllib.request.Request(url + "/event",
                                         data=json.dumps(body).encode(),
                                         method="POST")
            assert urllib.request.urlopen(req, timeout=30).status == 204
        assert t.selected == 2 and not np.allclose(t.q[1], [0, 0, 0, 1])
        after = urllib.request.urlopen(url + "/frame", timeout=60).read()
        a = np.asarray(img.convert("RGB"), np.float32)
        b = np.asarray(Image.open(io.BytesIO(after)).convert("RGB"),
                       np.float32)
        assert np.abs(a - b).max() > 10
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
