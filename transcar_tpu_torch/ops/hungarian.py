"""Hungarian matching of ground truth to queries, on the card
(``csrc/hungarian.cu``; ``transcar_tpu/ops/hungarian.py``).

The reference solves each [900, num_gt] cost matrix on the CPU with
scipy's ``linear_sum_assignment`` (hungarian_assigner_3d.py:108-125), a
device-to-host round trip in every train step.  The JAX package solves
every (layer, sample) problem on the device inside the jitted step
(``hungarian_match``: a shortest-augmenting-path LAP in
``lax.while_loop``s), so its step never waits for the host.  Plain
PyTorch cannot do that: every ``while`` condition read on the host is a
sync.  So the port runs the whole solver in one hand-written kernel,
which replaces that JAX function (no Pallas kernel precedes it).

What bounds it on the H100: the bytes are small (the solved rows of the
cost read once, the matches written: ~0.9 MB, 0.3 µs at 3.35 TB/s, for
six problems of 900 queries and 240 gts in all).  What paces it is the
sequence: each Dijkstra scan needs the previous scan's argmin, about one
scan a row when the rows are few against the queries and more as they
fill.  The design (see the source): one block a problem, all of a
problem's state in shared memory, one ``__syncthreads`` a scan (the warp
minima double-buffered), the cost read where it lies (a problem's stays
in L2 for its rescans), and the host reading nothing.

Semantics kept from the JAX solver, step for step: non-finite costs
become ±1e7 (NaN → +1e7) and every cost is clipped to ±1e7; only the
first ``num_gt`` gt slots of a problem are solved; the float32 sums in
the same order and argmin ties to the lowest query, so the matches are
the JAX solver's; padded gt slots carry the out-of-range sentinel Q,
which the target scatters drop, and a real slot that the solver's
backstops leave unmatched (more gts than queries; no other sane input
reaches that after sanitizing) carries −1, as the JAX solver returns.
The targets (``train/loss.py``) place a −1 where the JAX scatter does.

:func:`hungarian_match` takes the kernel on CUDA tensors and raises if it
cannot; on CPU tensors it takes :func:`hungarian_match_plain`, the same
algorithm in PyTorch loop for loop.  :func:`hungarian_match_host` is the
scipy solve with one copy each way, the counterpart of the JAX
``hungarian_match_callback``; it is on no path.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from transcar_tpu_torch.ops import kernel_lib

#: Kernel launches since the count was last set to 0.
launches = 0

BIG_M = 1e7
#: The JAX solver's ``_INF``: float32 max / 4.
INF = float(np.finfo(np.float32).max) / 4

_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_ARGTYPES = (_P,) * 5 + (_I,) * 3 + (_P,)


def sanitize_cost(cost: torch.Tensor) -> torch.Tensor:
    """NaN → +1e7, ±inf → ±1e7, then clip to ±1e7 (float32)."""
    cost = torch.nan_to_num(cost.float(), nan=BIG_M, posinf=BIG_M,
                            neginf=-BIG_M)
    return cost.clamp(-BIG_M, BIG_M)


def hungarian_match(cost_qg: torch.Tensor, num_gt: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-cost assignment of gts to queries for a batch of problems.

    Args:
      cost_qg: [P, Q, G] costs (rows: queries, cols: gt slots).
      num_gt: [P] real gt counts (≤ G), on ``cost_qg``'s device.
    Returns:
      (matched [P, G] int64 query per gt slot, Q at padded slots and −1
       at a real slot left unmatched; valid [P, G] bool, slot < num_gt),
       both on ``cost_qg``'s device.
    A CUDA ``cost_qg`` launches the kernel (:func:`kernel`) or raises; a
    CPU one takes :func:`hungarian_match_plain`.
    """
    if cost_qg.device.type == "cpu":
        return hungarian_match_plain(cost_qg, num_gt)
    return kernel(cost_qg, num_gt)


def kernel(cost_qg: torch.Tensor, num_gt: torch.Tensor,
           scans: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors (see :func:`hungarian_match`), launched
    on the current stream; nothing is read on the host.  ``scans``, an
    int32 [P] tensor on the card, receives each problem's Dijkstra
    scans."""
    global launches
    if cost_qg.dim() != 3:
        raise ValueError(f"hungarian kernel: cost must be [P, Q, G], got "
                         f"{tuple(cost_qg.shape)}")
    p, q, g = cost_qg.shape
    dev = cost_qg.device
    if dev.type != "cuda" or num_gt.device != dev:
        raise ValueError("hungarian kernel: cost and num_gt must be on one "
                         "CUDA device")
    if num_gt.numel() != p:
        raise ValueError(f"hungarian kernel: num_gt has {num_gt.numel()} "
                         f"entries for {p} problems")
    if q < 1:
        raise ValueError("hungarian kernel needs Q >= 1 queries")
    if scans is not None and (scans.shape != (p,) or scans.device != dev
                              or scans.dtype != torch.int32):
        raise ValueError(f"hungarian kernel: scans must be int32 [{p}] on "
                         f"{dev}")
    cost = cost_qg.detach().float().contiguous()
    counts = num_gt.reshape(p).to(torch.int32).contiguous()
    matched = torch.empty((p, g), dtype=torch.int64, device=dev)
    valid = torch.empty((p, g), dtype=torch.bool, device=dev)
    if p == 0 or g == 0:
        return matched, valid
    fn = kernel_lib.function("hungarian_match_f32", *ENTRY_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cost.data_ptr(), counts.data_ptr(), matched.data_ptr(),
                valid.data_ptr(),
                None if scans is None else scans.data_ptr(), p, q, g, stream)
    kernel_lib.check(rc, "hungarian_match_f32")
    launches += 1
    return matched, valid


def _solve_plain(cost: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """One problem: cost [G, Q] float32 (rows gts, sanitized), solved for
    its first ``n`` rows; returns (col4row [G] int64, −1 where unmatched;
    the Dijkstra scans).  The JAX ``hungarian_match`` and the kernel, step
    for step (the kernel's guards on a broken path included)."""
    g, q = cost.shape
    dev = cost.device
    u = torch.zeros(g, dtype=torch.float32, device=dev)
    v = torch.zeros(q, dtype=torch.float32, device=dev)
    col4row = torch.full((g,), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((q,), -1, dtype=torch.int64, device=dev)
    inf = torch.full((), INF, dtype=torch.float32, device=dev)
    scans = 0
    for cur in range(n):
        shortest = torch.full((q,), INF, dtype=torch.float32, device=dev)
        path = torch.full((q,), -1, dtype=torch.int64, device=dev)
        sr = torch.zeros(g, dtype=torch.bool, device=dev)
        sc = torch.zeros(q, dtype=torch.bool, device=dev)
        i, sink, it = cur, -1, 0
        min_val = torch.zeros((), dtype=torch.float32, device=dev)
        while sink == -1 and it < q:
            sr[i] = True
            reduced = ((min_val + cost[i]) - u[i]) - v
            lower = ~sc & (reduced < shortest)
            shortest = torch.where(lower, reduced, shortest)
            path = torch.where(lower, i, path)
            masked = torch.where(sc, inf, shortest)
            j = int(torch.argmin(masked))       # the first least column
            min_val = masked[j]
            sc[j] = True
            owner = int(row4col[j])
            if owner == -1:
                sink = j
            else:
                i = owner
            it += 1
        scans += it
        # potentials (rectangular_lsap.cpp semantics)
        u[cur] = u[cur] + min_val
        others = sr.clone()
        others[cur] = False
        u = torch.where(others, (u + min_val)
                        - shortest[col4row.clamp(0, q - 1)], u)
        v = torch.where(sc, v - (min_val - shortest), v)
        # augment; a bailed Dijkstra (sink −1) leaves the row unmatched
        if sink != -1:
            j = sink
            for _ in range(g + 1):
                pi = int(path[j])
                if not 0 <= pi < g:
                    break
                row4col[j] = pi
                nj = int(col4row[pi])
                col4row[pi] = j
                if pi == cur or nj < 0:
                    break
                j = nj
    return col4row, scans


def hungarian_match_plain(cost_qg: torch.Tensor, num_gt: torch.Tensor,
                          scans: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, one problem after another
    on ``cost_qg``'s device (its loop conditions are read on the host);
    the same returns as :func:`hungarian_match`, bit for bit the kernel's.
    ``scans``, an integer [P] tensor, receives each problem's Dijkstra
    scans."""
    p, q, g = cost_qg.shape
    dev = cost_qg.device
    cost = sanitize_cost(cost_qg.detach()).transpose(1, 2)     # [P, G, Q]
    counts = num_gt.reshape(p).clamp(0, g)
    matched = torch.full((p, g), q, dtype=torch.int64, device=dev)
    for k, n in enumerate(counts.tolist()):
        col4row, done = _solve_plain(cost[k], int(n))
        matched[k, :n] = col4row[:n]
        if scans is not None:
            scans[k] = done
    valid = torch.arange(g, device=dev)[None, :] < counts.to(dev)[:, None]
    return matched, valid


def hungarian_match_host(cost_qg: torch.Tensor, num_gt: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scipy's ``linear_sum_assignment`` on the host: all P problems cross
    to the host in one copy and their matches come back in one copy (the
    JAX ``hungarian_match_callback``; on no path).  The sanitized costs'
    optimum; tied costs may match other queries than the solver does."""
    from scipy.optimize import linear_sum_assignment

    p, q, g = cost_qg.shape
    cost = sanitize_cost(cost_qg.detach().cpu()).numpy()       # one copy
    counts = torch.as_tensor(num_gt).cpu().numpy().astype(np.int64)
    counts = counts.reshape(p)
    matched = np.full((p, g), q, np.int64)
    for i, n in enumerate(counts):
        if n > 0:
            rows, cols = linear_sum_assignment(cost[i, :, :n])
            matched[i, cols] = rows
    valid = np.arange(g)[None, :] < counts[:, None]
    both = torch.from_numpy(np.concatenate([matched, valid], axis=1))
    both = both.to(cost_qg.device)                              # one copy
    return both[:, :g], both[:, g:].bool()
