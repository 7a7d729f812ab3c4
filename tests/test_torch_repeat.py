"""What makes the port repeat bit for bit on the card, held on the CPU.

* The voxel conv's backward as gathers (``ops/sparse.py::GatherConv``):
  the submanifold and the strided conv's gradients against the JAX
  package's (``jax.vjp``), float32 at 1e-5 of each gradient's scale, and a
  float64 ``gradcheck`` of the Function itself.
* PyTorch's deterministic mode (``core/device.set_deterministic``): it
  changes nothing for the CPU, sets cuBLAS's workspace, the deterministic
  algorithms and cuDNN's flags for a card, and every entry point calls it
  before it touches the card.
* The Hungarian matching with more gts than queries: a real slot the
  solver leaves unmatched is −1, as the JAX solver returns, and the loss
  targets put it where the JAX scatter does.

The kernels' own repeats (K3, K4, K5, K9 launched twice) need the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 28.  Each JAX
oracle is jitted once a shape; no JAX train step is compiled.
"""
import ast
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sparse import GRID, V, _sites, t
from transcar_tpu.core import config as jcfg
from transcar_tpu.ops import sparse as jsparse
from transcar_tpu.ops.hungarian import hungarian_match as jhungarian
from transcar_tpu.train.loss import _single_sample_targets
from transcar_tpu.train.loss import detr3d_loss as jloss
from transcar_tpu_torch.core import device as core_device
from transcar_tpu_torch.ops import sparse
from transcar_tpu_torch.ops.hungarian import hungarian_match
from transcar_tpu_torch.train.loss import detr3d_loss, hungarian_targets

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers


# --- the voxel conv's backward as gathers -----------------------------------

@pytest.mark.parametrize("kind", ["subm", "down"])
def test_gather_conv_backward_matches_jax(kind):
    """d_feats by the inverse rule book and d_W = tapsᵀ · d_out against
    ``jax.vjp`` of the JAX op; the strided conv at a cap that binds (30 of
    the marked sites), so the inverse meets dropped outputs."""
    rng = np.random.default_rng(11)
    feats, coords, counts = _sites(rng, [57, 31], cin=6)
    cout, cap = 5, 30
    w = (rng.normal(size=(27, 6, cout)) * 0.2).astype(np.float32)
    rows = V if kind == "subm" else cap
    g_out = rng.normal(size=(2, rows, cout)).astype(np.float32)

    def jax_op(f, w):
        if kind == "subm":
            return jax.vmap(lambda f, c, n: jsparse.subm_conv(
                f, c, n, w, GRID))(f, coords, counts)
        return jax.vmap(lambda f, c, n: jsparse.sparse_conv_down(
            f, c, n, w, GRID, cap)[0])(f, coords, counts)

    ref = jax.jit(lambda f, w: jax.vjp(jax_op, f, w)[1](g_out))(feats, w)
    f, wt = (t(a).clone().requires_grad_() for a in (feats, w))
    if kind == "subm":
        out = sparse.subm_conv(f, t(coords), t(counts), wt, GRID)
    else:
        out = sparse.sparse_conv_down(f, t(coords), t(counts), wt, GRID,
                                      cap)[0]
    out.backward(t(g_out))
    for got, want, name in ((f.grad, ref[0], "d_feats"),
                            (wt.grad, ref[1], "d_w")):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["subm", "down"])
def test_gather_conv_gradcheck(kind):
    """``GatherConv`` in float64 against finite differences, features and
    weights, on a small grid with empty rows and (strided) a binding cap."""
    rng = np.random.default_rng(12)
    grid, v = (4, 5, 5), 24
    feats, coords, counts = _sites(rng, [17, 9], cin=2, v=v, grid=grid)
    f = t(feats).double().requires_grad_()
    w = torch.from_numpy(rng.normal(size=(27, 2, 3)) * 0.3).requires_grad_()
    if kind == "subm":
        fn = lambda f, w: sparse.subm_conv(f, t(coords), t(counts), w, grid)
    else:
        fn = lambda f, w: sparse.sparse_conv_down(f, t(coords), t(counts), w,
                                                  grid, 6)[0]
    assert torch.autograd.gradcheck(fn, (f, w), eps=1e-6, atol=1e-8)


# --- the deterministic mode ---------------------------------------------------

def _mode():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.utils.deterministic.fill_uninitialized_memory,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


def test_set_deterministic_leaves_the_cpu_alone_and_sets_the_card(
        monkeypatch):
    before = _mode()
    for dev in ("cpu", torch.device("cpu")):
        assert core_device.set_deterministic(dev) is False
        assert _mode() == before
    # for a card (the flags need no card to be set): every setting, then
    # the process's own restored
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    try:
        assert core_device.set_deterministic("cuda") is True
        assert _mode() == (True, False, True, False, False, ":4096:8")
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
        core_device.set_deterministic("cuda:0")
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]
        torch.backends.cudnn.benchmark = before[3]
        torch.utils.deterministic.fill_uninitialized_memory = before[4]
    assert _mode()[:5] == before[:5]


def _calls(fn) -> list:
    """The names of the functions ``fn`` calls, in source order."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            names.append((node.lineno, node.col_offset,
                           f.attr if isinstance(f, ast.Attribute)
                           else getattr(f, "id", "")))
    return [n for _, _, n in sorted(names)]


def test_every_entry_point_sets_the_deterministic_mode_first():
    """``cli.train``, ``cli.test``, ``cli.parity_check``, ``cli.benchmark``
    (its ``_setup``, which ``main`` reaches), the ranks the launchers and
    the dry run start and ``chip_smoke.py`` call ``set_deterministic``
    before anything that touches the card."""
    import chip_smoke
    from transcar_tpu_torch.cli import benchmark, parity_check, test, train
    from transcar_tpu_torch.parallel import dryrun

    touch = {"resolve_device", "maybe_initialize_distributed", "init_group",
             "build_model", "device", "phase_device", "export_child"}
    for fn in (train.main, test.main, parity_check.main, benchmark._setup,
               dryrun._rank_entry, chip_smoke.main):
        calls = _calls(fn)
        assert "set_deterministic" in calls, fn.__qualname__
        first = calls.index("set_deterministic")
        assert not touch & set(calls[:first]), (fn.__module__, calls[:first])
    assert "_setup" in _calls(benchmark.run) and "_setup" in _calls(
        benchmark.run_train)


# --- the Hungarian matching with more gts than queries ------------------------

def test_unmatched_gt_slots_match_the_jax_solver_and_its_targets():
    """Q = 5 queries, 8 gt slots: the plain solver's matches equal the JAX
    solver's index for index (−1 at the real slots left unmatched, Q at the
    padded ones), the targets equal the JAX scatter's (which takes −1 from
    the end) and every loss key equals JAX's to 1e-5."""
    rng = np.random.default_rng(13)
    nl, b, q, g = 2, 2, 5, 8
    cfg = jcfg.HeadConfig(num_query=q)
    counts = np.array([8, 6], np.int32)
    cls = (rng.normal(size=(nl, b, q, 10)) * 2).astype(np.float32)
    box = (rng.normal(size=(nl, b, q, 10)) * 3).astype(np.float32)
    gt_boxes = np.ones((b, g, 9), np.float32)
    gt_boxes[..., :3] = rng.uniform(-20, 20, (b, g, 3))
    gt_boxes[..., 3:6] = rng.uniform(0.5, 4, (b, g, 3))
    gt_labels = rng.integers(0, 10, (b, g)).astype(np.int32)

    costs = rng.normal(size=(3, q, g)).astype(np.float32)
    matched, valid = hungarian_match(t(costs), t(np.array([8, 6, 3])))
    for i, n in enumerate((8, 6, 3)):
        jm, jv = jhungarian(jnp.asarray(costs[i]), jnp.int32(n))
        np.testing.assert_array_equal(matched[i].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
    assert (matched[0, :8] == -1).sum() == 3 and (matched[1] == -1).sum() == 1

    labels, targets, weights = hungarian_targets(
        t(cls), t(box), t(gt_boxes), t(gt_labels), t(counts), cfg)
    ref = jax.jit(jax.vmap(jax.vmap(
        lambda c, bx, gb, gl, n: _single_sample_targets(c, bx, gb, gl, n, cfg),
        in_axes=(0, 0, 0, 0, 0)), in_axes=(0, 0, None, None, None)))(
            cls, box, gt_boxes, gt_labels, counts)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(targets.numpy(), np.asarray(ref[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(weights.numpy(), np.asarray(ref[2]))

    preds = {"all_cls_scores": cls, "all_bbox_preds": box}
    ours = detr3d_loss({k: t(v) for k, v in preds.items()}, t(gt_boxes),
                       t(gt_labels), t(counts), cfg)
    want = jloss({k: jnp.asarray(v) for k, v in preds.items()},
                 jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                 jnp.asarray(counts), cfg)
    for k in want:
        np.testing.assert_allclose(ours[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
