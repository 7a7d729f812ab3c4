"""The port's Hungarian matching (``transcar_tpu_torch/ops/hungarian.py``)
against the JAX solver (``transcar_tpu/ops/hungarian.py``) on the CPU.

On CPU tensors ``hungarian_match`` takes ``hungarian_match_plain``, the
kernel's algorithm in PyTorch loop for loop: on continuous costs (and on
tied integer costs, argmin ties going to the lowest query) its matches
are the JAX solver's, index for index.  On non-finite costs both
sanitize; the matched total then equals scipy's optimum of the sanitized
costs (rtol 1e-6, atol 1e-3: float32 sums of ±1e7 entries).  The kernel
itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Each JAX oracle is
jitted once per shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from transcar_tpu.ops.hungarian import hungarian_match as jax_match
from transcar_tpu_torch.ops import hungarian
from transcar_tpu_torch.ops.hungarian import (hungarian_match,
                                              hungarian_match_host,
                                              hungarian_match_plain,
                                              sanitize_cost)


def _jax(cost_qg: np.ndarray, n: int):
    m, v = jax_match(jnp.asarray(cost_qg), jnp.int32(n))
    return np.asarray(m), np.asarray(v)


def _check_jax(costs: np.ndarray, counts) -> torch.Tensor:
    """The plain solver on all problems at once against the JAX solver on
    each; returns the scans a problem."""
    scans = torch.zeros(len(counts), dtype=torch.int32)
    matched, valid = hungarian_match_plain(
        torch.from_numpy(costs), torch.tensor(counts), scans=scans)
    assert matched.dtype == torch.int64 and valid.dtype == torch.bool
    for i, n in enumerate(counts):
        jm, jv = _jax(costs[i], n)
        np.testing.assert_array_equal(matched[i].numpy(), jm)
        np.testing.assert_array_equal(valid[i].numpy(), jv)
    return scans


def _check_optimum(costs: np.ndarray, counts, matched, valid) -> None:
    """Real slots hold distinct queries, padded ones Q, and the matched
    total of the sanitized costs is scipy's optimum."""
    p, q, g = costs.shape
    sane = sanitize_cost(torch.from_numpy(costs)).double().numpy()
    for i, n in enumerate(counts):
        m = matched[i].numpy()
        assert valid[i].tolist() == [k < n for k in range(g)]
        assert (m[n:] == q).all()
        assert len(set(m[:n].tolist())) == n and (m[:n] < q).all()
        got = sane[i, m[:n], np.arange(n)].sum()
        rows, cols = scipy.optimize.linear_sum_assignment(sane[i, :, :n])
        np.testing.assert_allclose(got, sane[i, rows, cols].sum(),
                                   rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("q,g", [(40, 12), (300, 32)])
def test_plain_matches_jax_on_continuous_costs(q, g):
    rng = np.random.default_rng(q)
    counts = [0, 1, 7, g]
    costs = (rng.normal(size=(len(counts), q, g)) * 3).astype(np.float32)
    scans = _check_jax(costs, counts)
    # one scan a row at the least, and no scan for an empty problem
    assert scans[0] == 0 and all(scans[i] >= n for i, n in
                                 enumerate(counts))


def test_plain_matches_jax_on_a_batch_of_mixed_gt_counts():
    rng = np.random.default_rng(3)
    counts = [12, 0, 5, 1, 9, 12]
    costs = rng.uniform(0, 8, (len(counts), 40, 12)).astype(np.float32)
    _check_jax(costs, counts)


def test_plain_breaks_ties_as_jax_does():
    # integer costs: many equal minima, each taken at its lowest query
    rng = np.random.default_rng(4)
    costs = rng.integers(0, 4, (3, 40, 12)).astype(np.float32)
    _check_jax(costs, [12, 7, 3])


def test_plain_on_non_finite_costs_reaches_the_sanitized_optimum():
    rng = np.random.default_rng(5)
    counts = [12, 9, 5, 0]
    costs = rng.normal(size=(4, 40, 12)).astype(np.float32)
    costs[0, 3, 2] = np.nan
    costs[0, 7] = np.inf
    costs[1, :, 1] = -np.inf
    costs[2, rng.random((40, 12)) < 0.3] = np.nan
    costs[2, :5, :5] = 3e9                       # past the ±1e7 clip
    matched, valid = hungarian_match_plain(torch.from_numpy(costs),
                                           torch.tensor(counts))
    _check_optimum(costs, counts, matched, valid)


def test_plain_on_all_nan_costs_terminates_with_distinct_queries():
    costs = np.full((2, 40, 12), np.nan, np.float32)
    counts = [12, 4]
    matched, valid = hungarian_match_plain(torch.from_numpy(costs),
                                           torch.tensor(counts))
    _check_optimum(costs, counts, matched, valid)


def test_cpu_route_takes_the_plain_solver_not_scipy(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route called scipy")

    monkeypatch.setattr(scipy.optimize, "linear_sum_assignment", refuse)
    rng = np.random.default_rng(6)
    costs = rng.normal(size=(3, 40, 12)).astype(np.float32)
    before = hungarian.launches
    matched, valid = hungarian_match(torch.from_numpy(costs),
                                     torch.tensor([12, 6, 0]))
    plain = hungarian_match_plain(torch.from_numpy(costs),
                                  torch.tensor([12, 6, 0]))
    assert torch.equal(matched, plain[0]) and torch.equal(valid, plain[1])
    assert hungarian.launches == before          # no kernel on the CPU


def test_host_solve_reaches_the_same_optimum():
    rng = np.random.default_rng(7)
    counts = [12, 6, 0]
    costs = rng.normal(size=(3, 40, 12)).astype(np.float32)
    costs[1, 2, 3] = np.nan
    matched, valid = hungarian_match_host(torch.from_numpy(costs),
                                          torch.tensor(counts))
    _check_optimum(costs, counts, matched, valid)


def test_kernel_refuses_cpu_tensors():
    # the kernel never falls back: a CPU tensor is an error, raised before
    # any build
    with pytest.raises(ValueError, match="one CUDA device"):
        hungarian.kernel(torch.zeros(2, 40, 12), torch.tensor([3, 4]))
