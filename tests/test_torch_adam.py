"""The port's Adam update on the CPU: the plain formula, the constants and
leaf descriptions the wrapper hands ``csrc/adam.cu``, and the checks that
run before any launch. The kernel itself is compared with the plain
formula on the card (``test_torch_kernels_cuda.py``)."""
import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig

OPTIMIZERS = trainer.make_optimizers(TrainConfig(
    feature_learning_rate=1e-2, position_learning_rate=1e-3,
    position_learning_rate_decay_interval=3))


def _leaf(tx, shape, rng, count=0):
    param = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    grad = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    state = tx.init(param)._replace(
        mu=torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
        nu=torch.from_numpy(rng.random(shape).astype(np.float32)),
        count=torch.tensor(count, dtype=torch.int64))
    return tx, grad, state, param


@pytest.mark.parametrize("count", [0, 7, 17_330])
def test_adam_on_the_cpu_is_the_plain_formula(count):
    """On the CPU both leaves go to ``Adam.update_plain``, bit for bit, the
    inputs are left as they were, and nothing is launched."""
    rng = np.random.default_rng(count)
    leaves = [_leaf(tx, (33, w), rng, count)
              for tx, w in zip(OPTIMIZERS, (56, 3))]
    copies = [[t.clone() for t in (g, s.mu, s.nu, s.count, p)]
              for _, g, s, p in leaves]
    before = trainer.adam_update.launches
    got = trainer.adam_update(leaves)
    one = [tx.update(g, s, p) for tx, g, s, p in leaves]
    assert trainer.adam_update.launches == before
    for (tx, g, s, p), (p2, s2), (p1, s1), kept in zip(leaves, got, one,
                                                        copies):
        want_p, want_s = tx.update_plain(g, s, p)
        for x, y, z in zip((p2, *s2), (p1, *s1), (want_p, *want_s)):
            assert torch.equal(x, z) and torch.equal(y, z)
        assert int(s2.count) == count + 1
        assert all(torch.equal(a, b) for a, b in zip(
            (g, s.mu, s.nu, s.count, p), kept))


@pytest.mark.parametrize("which", [0, 1])  # features, positions
def test_the_kernels_constants_are_the_plain_formulas_casts(which):
    """The f32 constants in the kernel's leaf are the casts of the Python
    doubles the plain formula multiplies by: multiplying an f32 tensor by
    either gives the same bits (``1.0 - 0.9`` is not 0.1 in f64, and both
    round to the same f32)."""
    tx = OPTIMIZERS[which]
    rng = np.random.default_rng(which)
    _, grad, state, param = _leaf(tx, (64, 3), rng)
    outs = [torch.empty_like(param) for _ in range(3)] + [
        torch.empty_like(state.count)]
    leaf = trainer._adam_leaf(tx, grad, state, param, outs)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -8, 5, size=4096)).astype(np.float32))
    doubles = {"c1": 1.0 - tx.b1, "b1": tx.b1, "c2": 1.0 - tx.b2,
               "b2": tx.b2, "eps": tx.eps, "neg_lr": -tx.lr0}
    for name, d in doubles.items():
        got = getattr(leaf, name)
        assert got == float(np.float32(d)), name
        assert torch.equal(d * x, got * x) and torch.equal(x + d, x + got)
    # the decayed position rate goes by pointer, read on the device
    assert (leaf.lr is None) == (tx.decay_interval == 0)
    assert leaf.len1 == 166 and leaf.len2 == 17_322
    assert (leaf.n, leaf.vec4, leaf.units) == (192, 48, 48)


def test_a_leaf_off_16_byte_alignment_takes_the_scalar_path():
    """A leaf of N x 3 values takes float4s and a scalar tail; one whose
    stream starts off a 16-byte boundary takes the scalar path alone."""
    tx = OPTIMIZERS[1]
    rng = np.random.default_rng(5)
    _, grad, state, param = _leaf(tx, (7, 3), rng)
    outs = [torch.empty_like(param) for _ in range(3)] + [
        torch.empty_like(state.count)]
    leaf = trainer._adam_leaf(tx, grad, state, param, outs)
    assert (leaf.n, leaf.vec4, leaf.units) == (21, 5, 6)
    flat = torch.zeros(22)
    assert flat.data_ptr() % 16 == 0
    leaf = trainer._adam_leaf(tx, flat[1:].view(7, 3), state, param, outs)
    assert (leaf.n, leaf.vec4, leaf.units) == (21, 0, 21)


def _rejects(leaves, error, match):
    before = trainer.adam_update.launches
    with pytest.raises(error, match=match):
        trainer.adam_update(leaves)
    assert trainer.adam_update.launches == before


@pytest.mark.parametrize("case, error, match", [
    ("grad_f64", TypeError, "grad"),
    ("param_f16", TypeError, "param"),
    ("grad_not_contiguous", ValueError, "grad: must be contiguous"),
    ("nu_not_contiguous", ValueError, "nu: must be contiguous"),
    ("mu_shape", ValueError, "mu: need"),
    ("count_int", ValueError, "count"),
    ("count_int32", ValueError, "count"),
    ("three_leaves", ValueError, "1 or 2 leaves"),
    ("meta", ValueError, "unsupported device"),
])
def test_adam_update_refuses_what_the_kernel_does_not_take(case, error,
                                                           match):
    """Checked on either device before anything runs: the kernel takes
    contiguous f32 streams of the parameter's shape and a () int64 count."""
    rng = np.random.default_rng(3)
    tx, grad, state, param = _leaf(OPTIMIZERS[0], (16, 8), rng)
    transposed = lambda t: t.t().contiguous().t()  # noqa: E731
    meta = lambda t: t.to("meta")  # noqa: E731
    leaves = {
        "grad_f64": [(tx, grad.double(), state, param)],
        "param_f16": [(tx, grad, state, param.half())],
        "grad_not_contiguous": [(tx, transposed(grad), state, param)],
        "nu_not_contiguous": [(tx, grad, state._replace(
            nu=transposed(state.nu)), param)],
        "mu_shape": [(tx, grad, state._replace(mu=state.mu[:8]), param)],
        "count_int": [(tx, grad, state._replace(count=3), param)],
        "count_int32": [(tx, grad, state._replace(
            count=state.count.int()), param)],
        "three_leaves": [(tx, grad, state, param)] * 3,
        "meta": [(tx, meta(grad), trainer.AdamState(*map(meta, state)),
                  meta(param))],
    }[case]
    _rejects(leaves, error, match)
