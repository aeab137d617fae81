"""The port's process-group layer (``parallel/multihost.py``) against the
JAX package's: the shared-seed camera stream, the per-rank slices and the
resolution checks equal JAX's functions exactly (tests/test_multihost.py
:27-65), and the port's own rules: the backend choice, a world size that
is not the one asked for, the collectives without a group, and a decode
whose shape disagrees with its metadata."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh

jax = pytest.importorskip("jax")
from taichi_3d_gaussian_splatting_tpu.parallel import multihost as jmh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("num_items, seed, count", [
    (10, 7, 8), (10, 1, 20), (3, 0, 7), (25, 42, 4)])
def test_stream_matches_jax(num_items, seed, count):
    a = mh.GlobalShuffleSampler(num_items, seed=seed)
    b = jmh.GlobalShuffleSampler(num_items, seed=seed)
    for _ in range(5):
        assert a.peek_global(count) == b.peek_global(count)
        assert a.next_global(count) == b.next_global(count)


def test_stream_is_the_single_device_loader_order():
    from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import (
        PrefetchLoader,
    )

    loader = PrefetchLoader(list(range(6)), seed=3)
    stream = loader._index_stream()
    want = [next(stream) for _ in range(20)]
    assert mh.GlobalShuffleSampler(6, seed=3).next_global(20) == want


def test_epochs_cover_every_item():
    seen = mh.GlobalShuffleSampler(10, seed=1).next_global(20)
    assert sorted(seen[:10]) == list(range(10))
    assert sorted(seen[10:]) == list(range(10))


def test_no_shuffle_is_sequential():
    s = mh.GlobalShuffleSampler(4, seed=0, shuffle=False)
    assert s.next_global(6) == [0, 1, 2, 3, 0, 1] == jmh.GlobalShuffleSampler(
        4, seed=0, shuffle=False).next_global(6)


@pytest.mark.parametrize("per_step, local, offset", [
    (8, 4, 0), (8, 4, 4), (2, 1, 1), (4, 2, 2)])
def test_local_slice_matches_jax(per_step, local, offset):
    win = list(range(2 * per_step))
    assert (mh.GlobalShuffleSampler.local_slice(win, per_step, local, offset)
            == jmh.GlobalShuffleSampler.local_slice(win, per_step, local,
                                                    offset))


@pytest.mark.parametrize("h, w", [(546, 980), (1080, 1920), (1920, 1080),
                                  (1600, 1601), (64, 64), (33, 97)])
def test_expected_resolution_matches_jax(h, w):
    rec = {"camera_height": h, "camera_width": w}
    assert mh.expected_resolution(rec, 32) == jmh.expected_resolution(rec, 32)


def test_uniform_check_raises_on_mixed():
    recs = [{"camera_height": 546, "camera_width": 980},
            {"camera_height": 640, "camera_width": 980}]
    with pytest.raises(ValueError, match="uniform-resolution"):
        mh.check_uniform_resolution(recs, 32)
    with pytest.raises(ValueError, match="uniform-resolution"):
        jmh.check_uniform_resolution(recs, 32)
    assert (mh.check_uniform_resolution(recs[:1], 32)
            == jmh.check_uniform_resolution(recs[:1], 32) == (544, 960))


@pytest.mark.parametrize("device, local_world, cards, backend", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "gloo")])
def test_backend_rule(device, local_world, cards, backend):
    assert mh.choose_backend(device, local_world, cards) == backend


def test_collectives_without_a_group_are_identities():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.tensor([True, False])
    log = []
    got = mh.all_reduce_packed([a, b.float()], "sum", log=log)
    assert torch.equal(got[0], a) and torch.equal(got[1], b.float())
    assert log == [mh.Collective("sum", 8, torch.float32)]
    tree = {"x": (a, [b]), "n": 3}
    assert mh.broadcast_tree(tree) is tree
    assert mh.world_size() == 1 and mh.rank() == 0 and mh.is_main()
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        shard_batch,
    )

    (rows,) = shard_batch(np.arange(4), local_count=2, device="cpu")
    assert rows.tolist() == [0, 1]


def test_initialize_raises_on_world_size_mismatch():
    """A process that joins a group of one but was told of two (e.g. a
    launcher that started each process alone) must stop, not train an
    independent job."""
    code = (
        "import sys\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.parallel import "
        "multihost as mh\n"
        "port = mh.free_port()\n"
        "assert mh.initialize(f'127.0.0.1:{port}', 1, 0, device='cpu', "
        "timeout_s=30) == 'gloo'\n"
        "assert mh.initialize(f'127.0.0.1:{port}', 1, 0) == 'gloo'  # again\n"
        "try:\n"
        "    mh.initialize(num_processes=2, device='cpu')\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "refused: multihost init expected 2 processes" in r.stdout


def test_loader_names_an_image_that_disagrees_with_its_metadata():
    class Item:
        class camera_info:
            camera_height, camera_width = 32, 64

    class Dataset:
        records = [{"image_path": "a.png"}]

        def __getitem__(self, i):
            return Item()

    loader = mh.ThreadedIndexLoader(Dataset(), expected_hw=(32, 32))
    with pytest.raises(ValueError, match="a.png"):
        loader.load([0])
    loader.close()
    ok = mh.ThreadedIndexLoader(Dataset(), expected_hw=(32, 64))
    assert len(ok.load([0, 0])) == 2
    ok.close()
