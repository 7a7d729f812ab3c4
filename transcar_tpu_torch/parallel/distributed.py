"""Process groups, batch slices and collectives of multi-process training
and eval (``transcar_tpu/parallel/distributed.py``).

The reference initializes one NCCL process group with one process a GPU
(mmcv ``init_dist``, tools/train.py:153-160) and gathers eval results
across ranks (tools/test.py:218-223).  So does the port: one process
drives one card, every rank builds the same global shuffle and loads its
rows of each global batch (:func:`local_batch_slice`), and the sums that
span the batch (the loss normalizers, the BatchNorm statistics) and the
gradients are summed over the ranks, so that a W-rank step is the step of
the global batch, as the JAX step jitted over a W-device data mesh is.

Env contract (:func:`maybe_initialize_distributed`): torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, or Slurm's ``SLURM_PROCID``, ``SLURM_NTASKS`` and
``SLURM_LOCALID`` with ``MASTER_ADDR`` / ``MASTER_PORT`` exported by the
launcher (``transcar_tpu_torch/tools/slurm_*.sh``).

The backend is the caller's: ``nccl`` for the card, ``gloo`` for the CPU
or where the caller names it (two ranks on one card, which NCCL refuses).
Nothing falls back from one to the other.  Gloo does only ``all_reduce``
and ``broadcast`` on CUDA tensors, so every collective on device tensors
here is an ``all_reduce``; the eval gather runs on host tensors over a
gloo group.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: Bytes of one flat buffer of :func:`all_reduce_`.
BUCKET_BYTES = 64 << 20

_host_group = []     # the gloo group of allgather_eval_outputs, made once


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def env_ranks() -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) from torchrun's env or, with more
    than one task, Slurm's; None for a single process."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", "0")))
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", "0")))
    return None


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(rank: int, world: int, backend: str, address: str) -> None:
    """``init_process_group`` at ``tcp://<address>`` (host:port)."""
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)


def maybe_initialize_distributed(device="cuda",
                                 backend: Optional[str] = None
                                 ) -> Tuple[int, int]:
    """Join the process group that the launcher's env describes; returns
    (rank, world size), (0, 1) with no group.  Idempotent.

    On the card each rank takes ``cuda:LOCAL_RANK`` (``torch.cuda.
    set_device``) before the group starts.  ``backend`` defaults to
    :func:`default_backend` of ``device``."""
    if initialized():
        return dist.get_rank(), dist.get_world_size()
    ranks = env_ranks()
    if ranks is None or ranks[1] <= 1:
        return 0, 1
    rank, world, local = ranks
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local)
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise RuntimeError(f"rank {rank} of {world}: MASTER_ADDR and "
                           "MASTER_PORT must name rank 0's host and a free "
                           "port (torchrun sets them; the Slurm launchers "
                           "export them)")
    init_group(rank, world, backend or default_backend(device),
               f"{addr}:{port}")
    return rank, world


def rank_world(group=None) -> Tuple[int, int]:
    """(rank, size) of ``group`` (the default group when None); (0, 1)
    with no process group."""
    if not initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_main() -> bool:
    """True on rank 0, and in a process with no group."""
    return rank_world()[0] == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def local_batch_slice(process_index: int, process_count: int,
                      global_batch: int) -> slice:
    """This process's rows of each global batch (loader-side sharding)."""
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def summed(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x`` summed over the ranks of ``group`` (no autograd)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _GlobalSum(torch.autograd.Function):
    """Σ over the ranks; the backward sums the gradients over the ranks
    too, since every rank's loss (their sum is the objective) reads the
    sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return summed(grad, ctx.group), None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (each rank gets the sum),
    under autograd; ``x`` itself when ``group`` is None (one rank)."""
    if group is None:
        return x
    if not (x.requires_grad and torch.is_grad_enabled()):
        return summed(x, group)
    return _GlobalSum.apply(x, group)


def all_reduce_(tensors: Iterable[torch.Tensor], group,
                bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum ``tensors`` over the ranks of ``group``, in place, through flat
    buffers of at most ``bucket_bytes`` (one device and dtype each); a
    no-op when ``group`` is None."""
    if group is None:
        return
    buckets: Dict[tuple, list] = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for same in buckets.values():
        chunk, size = [], 0
        for t in same + [None]:
            if t is not None:
                chunk.append(t)
                size += t.numel() * t.element_size()
            if chunk and (t is None or size >= bucket_bytes):
                flat = torch.cat([c.reshape(-1) for c in chunk])
                dist.all_reduce(flat, group=group)
                for c, part in zip(chunk, flat.split(
                        [c.numel() for c in chunk])):
                    c.copy_(part.view_as(c))
                chunk, size = [], 0


def host_group():
    """A gloo group over every rank for host tensors: the default group
    when its backend is gloo, else one made at the first call (every rank
    calls this at the same point, as :func:`allgather_eval_outputs`
    does)."""
    if dist.get_backend() == "gloo":
        return None
    if not _host_group:
        _host_group.append(dist.new_group(backend="gloo"))
    return _host_group[0]


def _all_gather_host(x: np.ndarray, group) -> np.ndarray:
    """[n, ...] from every rank → [world · n, ...] in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(
        x.view(np.uint8) if x.dtype == np.bool_ else x))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts).numpy()
    return out.view(np.bool_) if x.dtype == np.bool_ else out


def allgather_eval_outputs(local: Dict[str, np.ndarray], n_local: int
                           ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Gather per-rank eval outputs to every rank (mmcv
    ``collect_results_cpu``, tools/test.py:222-223), over a host gloo
    group.

    ``local`` maps name → [n_local, ...] stacked per-sample arrays; the
    counts may differ across ranks, so each array is padded to the largest
    and a mask of the real rows is gathered beside it.  Returns (the
    gathered dict: the real rows, in rank order; their indices into the
    padded [world · max_local] stack)."""
    _, world = rank_world()
    if world == 1:
        return ({k: np.asarray(v)[:n_local] for k, v in local.items()},
                np.arange(n_local))
    group = host_group()
    counts = _all_gather_host(np.asarray([n_local], np.int64), group)
    max_local = int(counts.max())
    mask = np.zeros((max_local,), np.bool_)
    mask[:n_local] = True
    keep = np.nonzero(_all_gather_host(mask, group))[0]
    out = {}
    for k, v in local.items():
        v = np.asarray(v)[:n_local]
        pad = [(0, max_local - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
        out[k] = _all_gather_host(np.pad(v, pad), group)[keep]
    return out, keep
