"""Multi-rank dry run (the JAX ``__graft_entry__.dryrun_multichip``) and
the rank side of the parallel checks.

    python -m transcar_tpu_torch.parallel.dryrun N [--device cpu]
        [--backend gloo|nccl]

spawns N ranks of one process group.  With N ≥ 4 and even they form a
(N/2 × 2) data × model grid: one train step of the JAX dry run's tiny
``transcar_r101`` (2 decoder layers, 48 queries, 64 radar tokens, a
global batch of N/2 six-camera 64 × 96 samples on the uint8 training
wire, dropout on) with the head split over the model group is held to
the same step with the head replicated, at the JAX tolerances (loss
within 1e-4 · (1 + |loss|), every parameter within 1e-3).  With fewer
ranks, or an odd count, the grid is data-parallel only.  Then one
data-parallel ``objdgcnn_pillar`` step at the JAX dry run's shapes.  It
prints ``dryrun_multichip(N) ok on mesh {...}: total loss X``.  It runs
on the card unless ``--device cpu``; the backend defaults to nccl on the
card and gloo on the CPU (several ranks on one card need ``--backend
gloo``: NCCL refuses two ranks on one device).

:func:`spawn` starts the ranks (``torch.multiprocessing``, spawn method)
and returns what each returned; :func:`train_case`, :func:`dp_check`,
:func:`tp_check` and :func:`camera_check` are the checks that the CPU
tests and ``chip_smoke.py`` run: a case is a dict naming a preset, its
overrides and a synthetic global batch made from a seed, so every rank
makes the same one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import math
import queue
import socket
import time
import traceback
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from transcar_tpu_torch.core.config import get_preset, parse_overrides
from transcar_tpu_torch.core.device import set_deterministic
from transcar_tpu_torch.data.synthetic import fake_batch, fake_lidar_batch
from transcar_tpu_torch.parallel.distributed import (host_group, init_group,
                                                     local_batch_slice,
                                                     rank_world)
from transcar_tpu_torch.parallel.mesh import (CameraShardedDetector, Grid,
                                              make_grid)

#: The JAX dry run's tiny config, ``__graft_entry__._tiny_cfg(
#: num_decoder_layers=2, num_query=48, radar_tokens=64)``: the
#: ``transcar_r101`` model with a short head.
TINY_TRANSCAR = ["model.head.num_decoder_layers=2", "model.head.num_query=48",
                 "model.head.num_radar_tokens=64"]
#: The JAX dry run's ``objdgcnn_pillar`` shapes (``__graft_entry__.py``
#: :247-253).
TINY_PILLAR = ["data.max_points=600", "data.max_gt_boxes=4",
               "model.max_voxels=256", "model.bev_hw=[32,32]",
               "model.voxel_size=[3.2,3.2,8.0]", "model.head.num_query=16",
               "model.head.num_decoder_layers=1"]


def case(preset: str, options=(), batch: int = 1, seed: int = 0,
         hw=(64, 96), wire: str = "fp32", dtype: Optional[str] = None,
         dropout: float = 0.0, max_gt: int = 8) -> dict:
    """A check's case: ``preset`` with ``options`` (``k=v`` overrides),
    seeded random weights, and a synthetic global ``batch`` (``hw`` the
    camera images', ``wire`` as ``data/synthetic.fake_batch``) made from
    ``seed``; ``dtype`` casts the model and the batch's floats (float64
    for the CPU comparisons); ``dropout`` is the head's rate."""
    return dict(preset=preset, options=list(options), batch=batch,
                seed=seed, hw=tuple(hw), wire=wire, dtype=dtype,
                dropout=dropout, max_gt=max_gt)


def case_cfg(spec: dict):
    return get_preset(spec["preset"], parse_overrides(spec["options"]))


def case_batch(spec: dict, cfg=None) -> Dict[str, np.ndarray]:
    """The case's global batch (numpy), the same on every rank."""
    cfg = cfg or case_cfg(spec)
    head = cfg.model.head
    rng = np.random.default_rng(spec["seed"])
    if cfg.model.lidar_encoder:
        batch = fake_lidar_batch(rng, spec["batch"], cfg.data.max_points,
                                 head.pc_range, max_gt=spec["max_gt"])
    else:
        batch = fake_batch(rng, spec["batch"], head.num_cams, *spec["hw"],
                           head.num_radar_tokens, max_gt=spec["max_gt"],
                           wire=spec["wire"])
        if not head.with_radar_fusion:
            batch.pop("radar_tokens")
    if spec["dtype"]:
        dt = getattr(np, spec["dtype"])
        batch = {k: v.astype(dt) if v.dtype == np.float32
                 and k != "gt_boxes" else v for k, v in batch.items()}
    return batch


def case_model(spec: dict, device, training: bool, cfg=None):
    """The case's model, seeded, with randomized DCN and MSDeformAttn
    offsets (as ``cli/benchmark.py``), in ``spec["dtype"]``."""
    from transcar_tpu_torch.cli.benchmark import randomize_offsets
    from transcar_tpu_torch.models.detector import build_model

    cfg = cfg or case_cfg(spec)
    model = build_model(cfg, device=device, training=training,
                        seed=spec["seed"], dropout=spec["dropout"])
    randomize_offsets(model, torch.Generator().manual_seed(spec["seed"] + 1))
    if spec["dtype"]:
        model = model.to(getattr(torch, spec["dtype"]))
    return model


def local_rows(batch: Dict[str, np.ndarray], grid: Optional[Grid], device
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (all of them without a grid),
    on ``device``."""
    b = len(next(iter(batch.values())))
    rows = (slice(None) if grid is None else
            local_batch_slice(grid.data_rank, grid.data_size, b))
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
            for k, v in batch.items()}


class Run(NamedTuple):
    """What :func:`train_case` returns."""
    state: object                       # train/step.py's TrainState
    losses: list                        # each step's losses, as floats
    launches: Dict[str, int]            # kernel launches of the timed steps
    ms: float                           # wall ms a timed step
    grads: Optional[Dict[str, torch.Tensor]]   # the last step's, or None


def train_case(spec: dict, device, grid: Optional[Grid] = None,
               steps: int = 1, init: Optional[str] = None,
               warmup: int = 0, keep_grads: bool = False) -> Run:
    """``warmup`` + ``steps`` train steps of the case on this rank's rows
    (its part of the grid's step; the whole batch without a grid).
    ``init``: a saved ``state_dict`` to start from.  The launches and the
    wall time (synchronized on the card) are those of the last ``steps``
    steps; ``keep_grads`` keeps a copy of the last step's gradients as
    the update reads them: summed over the data group, before the clip,
    by the name of each parameter the optimizer updates."""
    from transcar_tpu_torch.cli.benchmark import kernel_counts
    from transcar_tpu_torch.train.loop import _sync, step_generator
    from transcar_tpu_torch.train.step import (apply_gradients, gradients,
                                               init_state)

    cfg = case_cfg(spec)
    model = case_model(spec, device, True, cfg)
    if init is not None:
        model.load_state_dict(torch.load(init, map_location=device,
                                         weights_only=True))
    state = init_state(cfg, model, total_steps=10, grid=grid)
    batch = local_rows(case_batch(spec, cfg), grid, device)
    rank = grid.data_rank if grid is not None else 0
    losses, grads = [], None
    for step in range(warmup + steps):
        if step == warmup:
            _sync(device)
            start, t0 = kernel_counts(), time.perf_counter()
        gen = step_generator(spec["seed"], step, device, rank)
        out = gradients(state, batch, gen)
        if keep_grads and step == warmup + steps - 1:
            trained = {id(p) for g in state.optimizer.param_groups
                       for p in g["params"]}
            grads = {n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()
                     if id(p) in trained}
        losses.append({k: float(v)
                       for k, v in apply_gradients(state, out).items()})
    _sync(device)
    ms = 1000.0 * (time.perf_counter() - t0) / steps
    launches = {k: v - start[k] for k, v in kernel_counts().items()
                if v != start[k]}
    return Run(state, losses, launches, ms, grads)


def dp_time(device, spec: dict, warmup: int = 1, steps: int = 3) -> dict:
    """A rank's data-parallel steps of the case, timed: ms a step (the
    loss pulls to the host included), kernel launches a step, the peak
    device memory of this rank, and the ms of one sum of the gradients
    over the data group (the flat all-reduce of every step)."""
    from transcar_tpu_torch.parallel.distributed import all_reduce_
    from transcar_tpu_torch.train.loop import _sync

    grid = make_grid()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, losses, launches, ms, _ = train_case(spec, device, grid, steps,
                                                warmup=warmup)
    grads = [p.grad for g in state.optimizer.param_groups
             for p in g["params"]]
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(3):
        all_reduce_(grads, grid.data_group)
    _sync(device)
    return {"ms": ms, "launches": {k: v / steps for k, v in
                                   launches.items()},
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None),
            "allreduce_ms": 1000.0 * (time.perf_counter() - t0) / 3,
            "grad_mib": sum(g.numel() * g.element_size()
                            for g in grads) / 2**20,
            "finite": all(math.isfinite(v) for r in losses
                          for v in r.values())}


def save_reference(spec: dict, path: str, device, steps: int = 1,
                   init: Optional[str] = None) -> list:
    """The one-process step of the case's global batch, saved to ``path``
    (its losses, the last step's gradients before the clip and their
    norm, and the ``state_dict`` after it) for :func:`dp_check`; returns
    the losses."""
    run = train_case(spec, device, None, steps, init, keep_grads=True)
    torch.save({"losses": run.losses,
                "grads": {k: v.cpu() for k, v in run.grads.items()},
                "grad_norm": float(run.state.grad_norm),
                "model": {k: v.cpu() for k, v in
                          run.state.model.state_dict().items()}}, path)
    return run.losses


def worst(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
          names, rtol: float, atol: float) -> tuple:
    """(max |got − want|, max of |got − want| / (atol + rtol · |want|))
    over ``names``: within the tolerance where the second is ≤ 1."""
    abs_err = ratio = 0.0
    for n in names:
        a = got[n].detach().double().cpu()
        b = want[n].detach().double().cpu()
        d = (a - b).abs()
        abs_err = max(abs_err, d.max().item())
        ratio = max(ratio, (d / (atol + rtol * b.abs())).max().item())
    return abs_err, ratio


def grad_error(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
               ) -> tuple:
    """Gradients against reference ones, over the reference's names:
    (‖got − want‖ / ‖want‖ with every tensor in one vector, the largest
    of one tensor's ‖got − want‖ / (‖want‖ of it + 1e-6 · ‖want‖ of
    all)).  The second sees a wrong tensor whose gradient is small beside
    the others'; its floor keeps a gradient that is zero but for
    rounding (a conv bias ahead of a BatchNorm) from counting."""
    diff = {n: (got[n].detach().double().cpu()
                - w.detach().double().cpu()).norm().item()
            for n, w in want.items()}
    norm = {n: w.detach().double().norm().item() for n, w in want.items()}
    total = math.sqrt(sum(v * v for v in norm.values()))
    whole = math.sqrt(sum(v * v for v in diff.values())) / total
    return whole, max(diff[n] / (norm[n] + 1e-6 * total) for n in want)


def loss_error(got: list, want: list) -> float:
    """max over steps and keys of |got − want| / max(|want|, 1e-12)."""
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
               for g, w in zip(got, want) for k in w)


def digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter and buffer, in ``state_dict`` order."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def ranks_agree(model: torch.nn.Module, grid: Grid) -> bool:
    """True when every rank of this rank's data group holds bit for bit
    the same parameters and buffers (each rank's :func:`digest`, gathered
    over a host group)."""
    _, world = rank_world()
    if world == 1:
        return True
    mine = digest(model)
    every = [None] * world
    dist.all_gather_object(every, mine, group=host_group())
    rank = dist.get_rank()
    tp = grid.model_size
    return all(d == mine for i, d in enumerate(every)
               if i % tp == rank % tp)


def dp_check(device, spec: dict, ref_path: str, steps: int = 1,
             init: Optional[str] = None, rtol: float = 1e-4,
             atol: float = 1e-4) -> dict:
    """A rank's data-parallel steps of the case against the one-process
    steps of its global batch (:func:`save_reference`): the global
    losses' relative error, the last step's summed gradients' errors
    (:func:`grad_error`) and their norm's relative error, parameters' and
    BatchNorm statistics' errors (:func:`worst`), whether the ranks agree
    bit for bit, and the kernel launches of this rank.  The parameters
    say little of the gradients: AdamW's first step moves a weight by
    about ± lr whatever its gradient's size."""
    grid = make_grid()
    state, losses, launches, _, grads = train_case(spec, device, grid,
                                                   steps, init,
                                                   keep_grads=True)
    ref = torch.load(ref_path, weights_only=True)
    g_whole, g_worst = grad_error(grads, ref["grads"])
    got = state.model.state_dict()
    params = [n for n, _ in state.model.named_parameters()]
    buffers = [n for n, b in state.model.named_buffers()
               if b.dtype.is_floating_point]
    p_abs, p_ratio = worst(got, ref["model"], params, rtol, atol)
    b_abs, b_ratio = worst(got, ref["model"], buffers, rtol, atol)
    return {"losses": losses, "loss_rel_err": loss_error(losses,
                                                         ref["losses"]),
            "grad_rel_err": g_whole, "grad_worst": g_worst,
            "norm_rel_err": abs(float(state.grad_norm) - ref["grad_norm"])
            / ref["grad_norm"],
            "param_abs": p_abs, "param_ratio": p_ratio,
            "buffer_abs": b_abs, "buffer_ratio": b_ratio,
            "agree": ranks_agree(state.model, grid), "launches": launches,
            "rank": dist.get_rank() if dist.is_initialized() else 0}


def tp_check(device, spec: dict, dp: int, tp: int,
             eval_spec: Optional[dict] = None) -> dict:
    """A rank of a (dp × tp) grid: the case's train step with the head
    split over the model group against the same step with the head
    replicated (same data groups, same draws): the loss's error relative
    to 1 + |loss|, the gradients' errors (:func:`grad_error`, the split
    ones gathered) and their norm's relative error (the clip's), and the
    largest parameter difference (the split parameters gathered).  With
    ``eval_spec``, also that case's eval forward with the head split
    against the replicated forward (largest |Δ| / (1 + |ref|) of the
    head's outputs) and each split fusion attention's kernel call (K2, on
    the card) against its plain version on the same inputs (max |Δ|, and
    that over max |plain|: the model's values reach the hundreds, from
    the radar encoders)."""
    from transcar_tpu_torch.parallel.sharding import (gathered_state,
                                                      split_params)

    grid = make_grid(dp, tp)
    replicated = dataclasses.replace(grid, model_rank=0, model_size=1,
                                     model_group=None)
    s_rep, l_rep, _, _, g_rep = train_case(spec, device, replicated,
                                           keep_grads=True)
    s_tp, l_tp, _, _, g_tp = train_case(spec, device, grid, keep_grads=True)
    full = gathered_state(s_tp.model, grid)
    ref = s_rep.model.state_dict()
    params = [n for n, _ in s_rep.model.named_parameters()]
    p_abs, _ = worst(full, ref, params, 0.0, 1.0)
    g_whole, g_worst = grad_error(gathered_state(s_tp.model, grid, g_tp),
                                  g_rep)
    total, total_rep = l_tp[0]["total"], l_rep[0]["total"]
    out = {"loss": total, "loss_rep": total_rep,
           "loss_err": abs(total - total_rep) / (1 + abs(total_rep)),
           "grad_rel_err": g_whole, "grad_worst": g_worst,
           "norm_rel_err": abs(float(s_tp.grad_norm - s_rep.grad_norm))
           / float(s_rep.grad_norm),
           "param_abs": p_abs, "split": len(split_params(s_tp.model)),
           "agree": ranks_agree(s_tp.model, grid)}
    del s_rep, s_tp
    if eval_spec is not None:
        out.update(tp_eval(device, eval_spec, grid))
    return out


def _head_outputs(model, batch, cfg):
    from transcar_tpu_torch.train.step import forward, normalize_batch_images

    with torch.inference_mode():
        return forward(model, normalize_batch_images(batch, cfg.data))


def tp_eval(device, spec: dict, grid: Grid) -> dict:
    """The case's eval forward, replicated and then with the head split
    (see :func:`tp_check`)."""
    from transcar_tpu_torch.ops import pallas_attention
    from transcar_tpu_torch.ops.attention import attention_core
    from transcar_tpu_torch.parallel import sharding

    cfg = case_cfg(spec)
    model = case_model(spec, device, False, cfg)
    batch = local_rows(case_batch(spec, cfg), None, device)
    ref = _head_outputs(model, batch, cfg)
    sharding.shard_model(model, grid)
    calls = []
    kernel = sharding.masked_attention

    def recorded(qh, kh, vh, keep):
        out = kernel(qh, kh, vh, keep)
        calls.append((qh, kh, vh, keep, out))
        return out

    sharding.masked_attention = recorded
    start = pallas_attention.launches
    try:
        got = _head_outputs(model, batch, cfg)
    finally:
        sharding.masked_attention = kernel
    launches = pallas_attention.launches - start
    err = max(((got[k].double() - ref[k].double()).abs()
               / (1 + ref[k].double().abs())).max().item() for k in ref)
    k2 = []
    for qh, kh, vh, keep, o in calls:
        plain = attention_core(qh, kh, vh, ~keep)
        d = (o - plain).abs().max().item()
        k2.append({"shape": list(qh.shape), "tokens": kh.shape[2],
                   "max_abs_err": d,
                   "rel_err": d / max(plain.abs().max().item(), 1e-30)})
    return {"eval_err": err, "k2_launches": launches, "k2_calls": k2}


def chunked_features(model, images: torch.Tensor, k: int) -> list:
    """The unsharded ``model``'s FPN levels of images [B, N, H, W, 3],
    its backbone and FPN run on ``k`` cameras at a time: the batch each
    camera group of a sharded forward convolves, so the convolutions pick
    the algorithms the sharded ones pick."""
    b, n, h, w, _ = images.shape
    parts = [model._features(images[:, i:i + k].reshape(b * k, h, w, 3),
                             b, k) for i in range(0, n, k)]
    return [torch.cat(levels, dim=1) for levels in zip(*parts)]


def camera_check(spec: dict, device, groups=(2, 3, 6)) -> dict:
    """The case's eval forward unsharded, then camera-sharded over
    ``device`` listed g times for each g of ``groups``.  For the FPN
    levels and for the head's outputs: whether each sharded one equals
    bit for bit the unsharded forward whose backbone and FPN take the
    same cameras at a time (:func:`chunked_features`; ``same_*``), and
    whether it equals the plain unsharded forward bit for bit and its
    largest |Δ| / (1 + |ref|) to it; and the DCN forward (K1) launches
    of each sharded forward."""
    from transcar_tpu_torch.ops import pallas_dcn
    from transcar_tpu_torch.train.step import normalize_batch_images

    cfg = case_cfg(spec)
    model = case_model(spec, device, False, cfg)
    batch = local_rows(case_batch(spec, cfg), None, device)
    with torch.inference_mode():
        normal = normalize_batch_images(batch, cfg.data)
        images = normal["images"]
        feats = CameraShardedDetector(model, [device]).features(images)
    start = pallas_dcn.launches
    ref = _head_outputs(model, batch, cfg)
    out = {"k1": {1: pallas_dcn.launches - start}, "equal": {},
           "rel_err": {}, "fpn_equal": {}, "fpn_rel_err": {},
           "same_fpn": {}, "same_equal": {}}

    def rel(got, want):
        return max(((g.double() - w.double()).abs()
                    / (1 + w.double().abs())).max().item()
                   for g, w in zip(got, want))

    def equal(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    hw = tuple(images.shape[2:4])
    for g in groups:
        with torch.inference_mode():
            same = chunked_features(model, images, images.shape[1] // g)
            same_out = model.head(same, normal["lidar2img"], hw,
                                  normal.get("radar_tokens"))
        sharded = CameraShardedDetector(model, [device] * g)
        with torch.inference_mode():
            got_feats = sharded.features(images)
        out["same_fpn"][g] = equal(got_feats, same)
        out["fpn_equal"][g] = equal(got_feats, feats)
        out["fpn_rel_err"][g] = rel(got_feats, feats)
        start = pallas_dcn.launches
        got = _head_outputs(sharded, batch, cfg)
        out["k1"][g] = pallas_dcn.launches - start
        out["same_equal"][g] = equal([got[k] for k in ref],
                                     [same_out[k] for k in ref])
        out["equal"][g] = equal([got[k] for k in ref], ref.values())
        out["rel_err"][g] = rel([got[k] for k in ref], ref.values())
    return out


def gather_check(device, counts) -> dict:
    """:func:`allgather_eval_outputs` with ``counts[rank]`` rows on each
    rank, row i of rank r holding 100 · r + i in float32, int32 and bool
    leaves; returns what this rank gathered."""
    from transcar_tpu_torch.parallel.distributed import (
        allgather_eval_outputs)

    rank = dist.get_rank()
    n = counts[rank]
    rows = np.arange(n)
    local = {"boxes": np.broadcast_to(
                 (rank * 100 + rows)[:, None, None], (n, 3, 2)
             ).astype(np.float32),
             "labels": (rank * 100 + rows).astype(np.int32),
             "valid": rows % 2 == 0}
    gathered, keep = allgather_eval_outputs(local, n)
    return {"gathered": gathered, "keep": keep}


@contextlib.contextmanager
def head_dropout(rate: float):
    """Within it, ``train/loop.py`` builds its models with the head's
    dropout at ``rate`` (the training default is 0.1): dropout draws
    differ by rank, so a multi-rank run is held to one process with it
    off."""
    from transcar_tpu_torch.train import loop

    build = loop.build_model
    loop.build_model = functools.partial(build, dropout=rate)
    try:
        yield
    finally:
        loop.build_model = build


def cli_train_check(device, argv) -> dict:
    """``cli.train`` with ``argv`` on this rank of the group, the head's
    dropout off (:func:`head_dropout`); returns its final losses, step
    and whether the ranks agree bit for bit."""
    from transcar_tpu_torch.cli import train as cli_train

    with head_dropout(0.0):
        state = cli_train.main(list(argv))
    return {"step": state.step,
            "losses": {k: float(v) for k, v in state.losses.items()},
            "agree": ranks_agree(state.model, state.grid),
            "eval_tokens": (None if state.last_eval is None else
                            list(state.last_eval.detections["tokens"]))}


#: What :func:`run_calls` may run.
CALLS = {"dp_check": dp_check, "dp_time": dp_time, "tp_check": tp_check,
         "gather_check": gather_check, "cli_train_check": cli_train_check}


def run_calls(device, calls) -> list:
    """Several checks on one group of ranks: ``calls`` is a list of (name
    in :data:`CALLS`, args); returns their results in order."""
    return [CALLS[name](device, *args) for name, args in calls]


# --- spawning ranks -----------------------------------------------------------

def free_address() -> str:
    """``localhost:<a free port>`` for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def _rank_entry(rank, world, backend, address, device, threads, fn, args,
                results):
    torch.set_num_threads(threads)
    try:
        set_deterministic(device)      # before the group touches the card
        init_group(rank, world, backend, address)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        results.put((rank, fn(dev, *args), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo", device="cpu",
          threads: int = 1, timeout: float = 900.0) -> list:
    """``fn(device, *args)`` on each of ``world`` new processes, ranks of
    one process group (``backend``; ``device``: the CPU, or the card, then
    rank r takes card r mod count); returns their results in rank order.
    ``fn`` must be importable (a module-level function).  Raises with the
    first failing rank's traceback, or after ``timeout`` seconds, and
    stops every rank it started either way."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = free_address()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, backend, address, str(device),
                               threads, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, failed = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and failed is None:
            try:
                rank, res, err = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    failed = (f"ranks {dead} exited with "
                              f"{[procs[r].exitcode for r in dead]} and no "
                              "result")
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(out)} of {world} "
                                       f"ranks gave no result in {timeout} s")
                continue
            if err is not None:
                failed = f"rank {rank} failed:\n{err}"
            out[rank] = res
        if failed:
            raise RuntimeError(failed)
    finally:
        for p in procs:
            p.join(timeout=1 if failed else 60)
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [out[r] for r in range(world)]


# --- the dry run ---------------------------------------------------------------

def dryrun_rank(device, dp: int, tp: int) -> dict:
    """One rank of :func:`main`'s dry run."""
    grid = make_grid(dp, tp)
    out = {"mesh": {"data": dp, **({"model": tp} if tp > 1 else {})}}
    spec = case("transcar_r101", TINY_TRANSCAR, batch=dp, wire="u8_aug",
                dropout=0.1)
    if tp > 1:
        res = tp_check(device, spec, dp, tp)
        if not res["loss_err"] <= 1e-4:
            raise AssertionError(f"TP loss {res['loss']} != replicated "
                                 f"loss {res['loss_rep']}")
        if not res["param_abs"] < 1e-3:
            raise AssertionError(f"TP updated params diverge: max|Δ|="
                                 f"{res['param_abs']}")
        out.update(res)
        total = res["loss"]
    else:
        losses = train_case(spec, device, grid).losses
        total = losses[0]["total"]
    if not math.isfinite(total):
        raise AssertionError(f"non-finite loss: {total}")
    out["total"] = total
    lspec = case("objdgcnn_pillar", TINY_PILLAR, batch=dp, seed=2,
                 max_gt=4)
    llosses = train_case(lspec, device, grid).losses
    ltotal = llosses[0]["total"]
    if not math.isfinite(ltotal):
        raise AssertionError(f"non-finite LiDAR loss: {ltotal}")
    out["lidar_total"] = ltotal
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"),
                    help="nccl on the card, gloo on the CPU by default")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False (use --device cpu for a CPU run)")
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    n = args.n
    dp, tp = (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)
    res = spawn(dryrun_rank, n, dp, tp, backend=backend, device=device,
                threads=max(1, (torch.get_num_threads() // n)))[0]
    if tp > 1:
        print(f"tp-vs-replicated: loss Δ={res['loss_err']:.2e}, "
              f"param max|Δ|={res['param_abs']:.2e}")
    print(f"lidar pillar sharded train step ok: loss "
          f"{res['lidar_total']:.4f}")
    print(f"dryrun_multichip({n}) ok on mesh {res['mesh']} ({backend}): "
          f"total loss {res['total']:.4f}")
    return res


if __name__ == "__main__":
    main()
