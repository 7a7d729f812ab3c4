"""The sparse 3D encoder of the port's voxel ObjDGCNN (``ops/sparse.py``,
``models/sparse_encoder.py``) against the JAX package, on the CPU.

Shapes are those of tests/test_sparse_encoder_oracle.py (grid (8, 12, 12),
V = 192, 5 input channels); tests/test_torch_voxel.py holds the whole
model.  Inputs and weights are seeded numpy; each JAX function is jitted
once per shape.  The port folds the batch into its keys where JAX maps
one sample at a time, and gathers the 27 taps into one matrix product
where JAX sums 27 dots, so features agree to float32 rounding (1e-5 for
one conv, 1e-4 through the encoder) and site sets, coords and counts
exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_model import _random_params
from transcar_tpu.models.sparse_encoder import SparseEncoder as JaxEncoder
from transcar_tpu.ops import sparse as jsparse
from transcar_tpu_torch.models.sparse_encoder import SparseEncoder
from transcar_tpu_torch.ops import sparse
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers

GRID = (8, 12, 12)
V = 192
CIN = 5


def t(a):
    return torch.from_numpy(np.asarray(a))


def _sites(rng, counts, cin=CIN, v=V, grid=GRID):
    """Unique random sites per sample in [B, V] buffers (rows past the
    count hold zeros), features N(0, 1)."""
    b = len(counts)
    feats = np.zeros((b, v, cin), np.float32)
    coords = np.zeros((b, v, 3), np.int32)
    for bi, n in enumerate(counts):
        lin = rng.choice(grid[0] * grid[1] * grid[2], size=n, replace=False)
        coords[bi, :n] = np.stack([lin // (grid[1] * grid[2]),
                                   (lin // grid[2]) % grid[1],
                                   lin % grid[2]], axis=1)
        feats[bi, :n] = rng.normal(size=(n, cin))
    return feats, coords, np.asarray(counts, np.int32)


# --- ops ---------------------------------------------------------------------

def test_subm_conv_matches_jax():
    rng = np.random.default_rng(0)
    feats, coords, counts = _sites(rng, [70, 41], cin=8)
    weight = (rng.normal(size=(27, 8, 16)) * 0.2).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda f, c, n: jsparse.subm_conv(
        f, c, n, jnp.asarray(weight), GRID)))(feats, coords, counts)
    got = sparse.subm_conv(t(feats), t(coords), t(counts), t(weight), GRID)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (got[1, 41:] == 0).all() and got[1, :41].abs().sum() > 0
    # one table and one rule book serve every conv on a site set
    sites = sparse.Sites(t(coords), t(counts), GRID)
    assert sites.table.dtype == torch.int32
    assert sites.table.shape == (2 * 8 * 12 * 12 + 1,)
    assert sites.subm_rules is sites.subm_rules
    assert int(sites.table[-1]) == 2 * V               # the zero row


@pytest.mark.parametrize("out_max", [V, 40])
def test_sparse_conv_down_matches_jax(out_max):
    """Coords and counts exactly, features to 1e-5; at out_max 40 both
    samples overfill the cap, so the same first 40 sites (ascending
    linear id) are kept and the dropped count is the rest."""
    rng = np.random.default_rng(1)
    feats, coords, counts = _sites(rng, [60, 23], cin=4)
    weight = (rng.normal(size=(27, 4, 8)) * 0.2).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda f, c, n: jsparse.sparse_conv_down(
        f, c, n, jnp.asarray(weight), GRID, out_max)))(feats, coords, counts)
    of, oc, on, dropped = sparse.sparse_conv_down(
        t(feats), t(coords), t(counts), t(weight), GRID, out_max)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(on.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(of.numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5)
    assert oc.dtype == on.dtype == dropped.dtype == torch.int32
    # the site set before the cap, brute force: o with 2o + t = an input
    out_grid = tuple((g + 1) // 2 for g in GRID)
    offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    for bi, n in enumerate(counts):
        cand = (coords[bi, :n, None, :] + offs)               # i − t = 2o
        even = (cand % 2 == 0).all(-1)
        o = cand[even] // 2
        o = o[((o >= 0) & (o < out_grid)).all(-1)]
        marked = len({tuple(x) for x in o})
        assert int(dropped[bi]) == max(marked - out_max, 0)
        assert int(on[bi]) == min(marked, out_max)
    assert (dropped > 0).all() if out_max == 40 else (dropped == 0).all()


def test_sparse_op_gradients_match_jax():
    """The gradients of both convs' features and weights (the gathers'
    backward is gathers by the inverse rule books, ``GatherConv``) against
    ``jax.vjp``, the downsample at a cap that binds; float32 at 1e-5 of
    each gradient's scale."""
    rng = np.random.default_rng(2)
    feats, coords, counts = _sites(rng, [60, 23], cin=4)
    w_subm = (rng.normal(size=(27, 4, 4)) * 0.2).astype(np.float32)
    w_down = (rng.normal(size=(27, 4, 8)) * 0.2).astype(np.float32)
    g_subm = rng.normal(size=(2, V, 4)).astype(np.float32)
    g_down = rng.normal(size=(2, 40, 8)).astype(np.float32)

    def run(f, ws, wd):
        def convs(f, ws, wd):
            a = jax.vmap(lambda f, c, n: jsparse.subm_conv(
                f, c, n, ws, GRID))(f, coords, counts)
            b = jax.vmap(lambda f, c, n: jsparse.sparse_conv_down(
                f, c, n, wd, GRID, 40)[0])(f, coords, counts)
            return a, b
        _, vjp = jax.vjp(convs, f, ws, wd)
        return vjp((g_subm, g_down))

    ref = jax.jit(run)(feats, w_subm, w_down)
    args = [t(a).clone().requires_grad_() for a in (feats, w_subm, w_down)]
    a = sparse.subm_conv(args[0], t(coords), t(counts), args[1], GRID)
    b = sparse.sparse_conv_down(args[0], t(coords), t(counts), args[2],
                                GRID, 40)[0]
    torch.autograd.backward([a, b], [t(g_subm), t(g_down)])
    for arg, want, name in zip(args, ref, ("feats", "w_subm", "w_down")):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(arg.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


# --- the encoder -------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_case():
    """Sites (two samples of 24 and 17, so no downsample reaches the cap
    of V = 192), seeded variables with non-identity statistics, a
    cotangent, and JAX's dense encoder in one jit: train-mode outputs,
    new running statistics, the (parameter, feature) gradients under the
    cotangent, and eval-mode outputs with the new statistics.  The JAX
    gather encoder is the same math while no cap binds
    (tests/test_sparse_encoder_oracle.py holds the two together) and
    takes several times as long to compile; the ops above hold the port's
    gathers against JAX's, and tests/test_torch_voxel.py the whole model
    on the gather encoder."""
    rng = np.random.default_rng(7)
    feats, coords, counts = _sites(rng, [24, 17])
    enc = JaxEncoder(sparse_shape=GRID, impl="dense")
    variables = _random_params(lambda k: enc.init(
        k, jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(counts),
        train=True), seed=5)
    cot = rng.normal(size=(2, 2, 2, 256)).astype(np.float32)

    def run(v, f, g):
        def fwd(p, f):
            return enc.apply({"params": p, "batch_stats": v["batch_stats"]},
                             f, coords, counts, train=True,
                             mutable=["batch_stats"])
        out, vjp, new = jax.vjp(fwd, v["params"], f, has_aux=True)
        d_params, d_feats = vjp(g)
        evl = enc.apply({"params": v["params"],
                         "batch_stats": new["batch_stats"]}, f, coords,
                        counts, train=False)
        return out, new["batch_stats"], d_params, d_feats, evl

    ref = jax.jit(run)(variables, feats, cot)
    return (feats, coords, counts, variables, cot,
            jax.tree_util.tree_map(np.asarray, ref))


def _close(a, b, what, floor=1e-6):
    np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                               atol=1e-4 * max(np.abs(b).max(), floor),
                               err_msg=what)


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_sparse_encoder_matches_jax(encoder_case, impl):
    """Train mode (outputs, running statistics, the gradients of the
    features and of every parameter) and eval mode with the updated
    statistics, float32 at 1e-4 of each tensor's scale."""
    feats, coords, counts, variables, cot, ref = encoder_case
    out, stats, d_params, d_feats, evl = ref
    enc = SparseEncoder(CIN, GRID, impl=impl)
    enc.load_state_dict(from_jax_params(variables), strict=True)
    x = t(feats).clone().requires_grad_()
    got = enc.train()(x, t(coords), t(counts))
    got.backward(t(cot))

    assert got.shape == (2, 2, 2, 256) and np.abs(out).max() > 0.1
    # the encoder's own audit: three downsamples, none capped
    assert len(enc.downsample_sites) == 3
    assert all(torch.equal(m, k) and (k > 0).all()
               for m, k in enc.downsample_sites)
    _close(got, out, "train outputs")
    buffers = dict(enc.named_buffers())
    stats = from_jax_params(stats)
    assert stats.keys() == buffers.keys()
    for name, want in stats.items():
        _close(buffers[name], want.numpy(), name)
    assert np.abs(d_feats[:, :17]).max() > 0 and (d_feats[1, 17:] == 0).all()
    _close(x.grad, d_feats, "d_feats")
    grads = from_jax_params(d_params)
    params = dict(enc.named_parameters())
    assert grads.keys() == params.keys()
    # out_conv's bias meets a train-mode BatchNorm: its gradient is zero
    # but for rounding, so each leaf is held at 1e-4 of at least 1e-3 of
    # the largest leaf's scale
    floor = 1e-3 * max(g.abs().max().item() for g in grads.values())
    for name, want in grads.items():
        _close(params[name].grad, want.numpy(), name, floor)
    with torch.no_grad():
        _close(enc.eval()(t(feats), t(coords), t(counts)), evl,
               "eval outputs")


def test_dense_impl_bfloat16_convs(encoder_case):
    """``compute_dtype`` bfloat16: a dense block's conv rounds its
    operands and output to bfloat16 (2⁻⁸ relative), the BatchNorm
    computes in float32 and the block's output stays bfloat16, within
    2e-2 of the float32 block's scale; the encoder's output is float32
    and finite."""
    feats, coords, counts, variables = encoder_case[:4]
    enc = SparseEncoder(CIN, GRID, impl="dense")
    enc.load_state_dict(from_jax_params(variables), strict=True)
    bf = SparseEncoder(CIN, GRID, impl="dense", compute_dtype="bfloat16")
    bf.load_state_dict(enc.state_dict(), strict=True)
    x, mask = enc._scatter(t(feats), t(coords), t(counts), GRID)
    with torch.no_grad():
        ref, m32 = enc.train().conv_input(x, mask)
        got, m16 = bf.train().conv_input(x.bfloat16(), mask)
        assert got.dtype == torch.bfloat16 and torch.equal(m16, m32)
        assert (got.float() - ref).abs().max() <= 2e-2 * ref.abs().max()
        out = bf(t(feats), t(coords), t(counts))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
