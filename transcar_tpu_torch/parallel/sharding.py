"""Tensor parallelism of the head (``transcar_tpu/parallel/sharding.py``).

The rule table is the JAX package's ``_spec_for``, applied to the port's
parameter names (:func:`jax_keys` gives a parameter's path in the flax
tree): Megatron pairs, the first GEMM of a pair split on its output
features and the second on its input features.  It matches the
attention projections (``wq``/``wk``/``wv`` and their biases split by
heads, ``wo`` on its input) and every ``*linear1`` / ``*linear2``.  As in
JAX a parameter is split only where the dim divides the group's size.

Layouts: ``wq`` … ``wo`` are [in, out] as in JAX (``models/common.py``),
while ``*linear1`` / ``*linear2`` are ``nn.Linear`` weights, [out, in]:
"split the output features" is dim 1 of the first and dim 0 of the
second (:func:`split_dims` turns the JAX dim into the port's).

GSPMD inserts the collectives that keep a split program equal to the
replicated one; here they are written out (Megatron's):

  * a column-parallel GEMM takes its input through :func:`copy_to_group`
    (forward identity, backward all-reduce);
  * a row-parallel GEMM's partial products meet in
    :func:`reduce_from_group` (forward all-reduce, backward identity),
    and its bias (``bo``, ``linear2``'s) is added once, after it;
  * where the name rule splits a GEMM whose split output feeds code that
    needs every feature, the output is all-gathered (:func:`gather_last`,
    backward the slice) and the next GEMM of the pair takes its slice
    (:func:`scatter_last`, backward an all-gather): an ``MLP``'s
    ``linear1`` ahead of a LayerNorm (the ``cls_branch``/``final_cls``
    stacks) or as its last layer (the radar and position encoders).

A rank's attention runs on its heads, K2 included (at inference, the
fusion attention runs K2 on H / size heads).  Dropout on a split tensor
draws the mask of the whole tensor from the group's shared generator and
keeps its slice (``models/common.hidden_dropout``,
``ops/attention.attention_core``), so the split step equals the
replicated one, dropout on.

Every collective is an ``all_reduce`` (an all-gather is a sum of
zero-padded slices), so gloo serves CUDA tensors too.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.models.common import FFN, MLP, TorchMHA
from transcar_tpu_torch.models.head import TransCARHead
from transcar_tpu_torch.ops.attention import (attention_core, merge_heads,
                                              split_heads)
from transcar_tpu_torch.ops.pallas_attention import masked_attention
from transcar_tpu_torch.parallel.distributed import summed

MODEL = "model"


def spec_for(path_keys) -> tuple:
    """The JAX ``_spec_for`` (``transcar_tpu/parallel/sharding.py:24``)
    as a tuple of axis names per dim: Megatron pairs, the first GEMM of
    each pair splits output features, the second input features."""
    keys = tuple(path_keys)
    leaf = keys[-1]
    parent = keys[-2] if len(keys) > 1 else ""
    if leaf in ("wq", "wk", "wv"):
        return (None, MODEL)
    if leaf in ("bq", "bk", "bv"):
        return (MODEL,)
    if leaf == "wo":
        return (MODEL, None)
    if parent.endswith("linear1"):
        return (None, MODEL) if leaf == "kernel" else (MODEL,)
    if parent.endswith("linear2") and leaf == "kernel":
        return (MODEL, None)
    return ()


def jax_keys(name: str, module: nn.Module) -> tuple:
    """The flax path of the port's parameter ``name`` (dotted, owned by
    ``module``): ``train/convert.py``'s renames read backwards (a
    Linear's or a conv's ``weight`` is ``kernel``, a norm's ``scale``)."""
    keys = name.split(".")
    if keys[-1] == "weight":
        kernel = isinstance(module, (nn.Linear, nn.Conv2d))
        keys[-1] = "kernel" if kernel else "scale"
    return tuple(keys)


def split_dims(model: nn.Module, size: int) -> Dict[str, int]:
    """Parameter name → the dim (the port's layout) that a model group of
    ``size`` ranks splits, for every parameter the rule table splits and
    whose dim divides ``size``."""
    out = {}
    for mod_name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            spec = spec_for(jax_keys(name, mod))
            if MODEL not in spec:
                continue
            dim = spec.index(MODEL)
            if isinstance(mod, nn.Linear) and pname == "weight":
                dim = 1 - dim                       # [out, in] = kernelᵀ
            if p.ndim > dim and p.shape[dim] % size == 0:
                out[name] = dim
    return out


# --- collectives of a model group ---------------------------------------------

def _gather(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    k = x.shape[-1]
    full = x.new_zeros(*x.shape[:-1], k * size)
    full[..., rank * k:(rank + 1) * k] = x
    dist.all_reduce(full, group=group)
    return full


def _slice(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    k = x.shape[-1] // size
    return x[..., rank * k:(rank + 1) * k].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return summed(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        return _gather(x, group, rank, size)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.rank, ctx.size), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.size = group, rank, size
        return _slice(x, rank, size)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.rank, ctx.size), None, None, None


def copy_to_group(x, grid):
    """Forward identity, backward the sum of the model group's
    gradients."""
    return _Copy.apply(x, grid.model_group)


def reduce_from_group(x, grid):
    """Forward the sum of the model group's partial products, backward
    identity."""
    return _Reduce.apply(x, grid.model_group)


def gather_last(x, grid):
    """The model group's slices of the last dim, in rank order."""
    return _Gather.apply(x, grid.model_group, grid.model_rank,
                         grid.model_size)


def scatter_last(x, grid):
    """This rank's slice of the last dim of a replicated tensor."""
    return _Scatter.apply(x, grid.model_group, grid.model_rank,
                          grid.model_size)


# --- the split modules --------------------------------------------------------

class ColumnParallelLinear(nn.Linear):
    """``nn.Linear`` holding this rank's rows of the weight (output
    features) and of the bias; ``gather`` all-gathers the output."""

    def forward(self, x):
        y = F.linear(copy_to_group(x, self.grid), self.weight, self.bias)
        return gather_last(y, self.grid) if self.gather else y


class RowParallelLinear(nn.Linear):
    """``nn.Linear`` holding this rank's columns of the weight (input
    features) and the whole bias; a replicated input is sliced first."""

    def forward(self, x):
        if not self.parallel_input:
            x = scatter_last(x, self.grid)
        y = reduce_from_group(F.linear(x, self.weight), self.grid)
        return y if self.bias is None else y + self.bias


class TensorParallelMHA(TorchMHA):
    """``TorchMHA`` on this rank's heads (``num_heads`` of ``heads[1]``
    from ``heads[0]``): q/k/v projections split by heads, ``wo`` on its
    input rows, ``bo`` added after the sum."""

    def forward(self, q, k, v, mask=None, use_pallas: bool = False):
        p, h = self.params(), self.num_heads
        q, k, v = (copy_to_group(t, self.grid) for t in (q, k, v))
        qh = split_heads(q @ p["wq"] + p["bq"], h)
        kh = split_heads(k @ p["wk"] + p["bk"], h)
        vh = split_heads(v @ p["wv"] + p["bv"], h)
        if use_pallas and mask is not None and not self.training:
            core = masked_attention(qh.float(), kh.float(), vh.float(),
                                    ~mask).to(q.dtype)
        else:
            core = attention_core(
                qh, kh, vh, mask,
                dropout=self.dropout if self.training else 0.0,
                heads=self.heads)
        out = reduce_from_group(merge_heads(core) @ p["wo"], self.grid)
        return out + p["bo"]


def _shard_(module: nn.Module, name: str, dim: int, grid) -> None:
    p = getattr(module, name)
    n = p.shape[dim] // grid.model_size
    with torch.no_grad():
        p.data = p.data.narrow(dim, grid.model_rank * n, n).clone()
    p.tp_dim = dim


def _column(lin: nn.Linear, grid, gather: bool) -> None:
    width = lin.out_features
    _shard_(lin, "weight", 0, grid)
    if lin.bias is not None:
        _shard_(lin, "bias", 0, grid)
    lin.__class__ = ColumnParallelLinear
    lin.grid, lin.gather = grid, gather
    n = width // grid.model_size
    lin.out_features = n
    if not gather:      # hidden_dropout reads which columns these are
        lin.columns = (grid.model_rank * n, (grid.model_rank + 1) * n, width)


def _row(lin: nn.Linear, grid, parallel_input: bool) -> None:
    _shard_(lin, "weight", 1, grid)
    lin.__class__ = RowParallelLinear
    lin.grid, lin.parallel_input = grid, parallel_input
    lin.in_features //= grid.model_size


def shard_model(model: nn.Module, grid) -> List[str]:
    """Split ``model``'s matmuls over ``grid``'s model group as the rule
    table says, in place: each rank keeps its slices (``p.tp_dim`` marks
    a split parameter) and the modules take their split forms.  Returns
    the names of the split parameters; raises for a split parameter of a
    module with no split form here.  Call it before the optimizer is
    built."""
    if grid.model_size == 1:
        return []
    dims = split_dims(model, grid.model_size)
    size = grid.model_size
    done = set()

    def owned(prefix, names):
        return [prefix + n for n in names if prefix + n in dims]

    for mod_name, mod in list(model.named_modules()):
        pre = mod_name + "." if mod_name else ""
        if isinstance(mod, TorchMHA):
            names = owned(pre, ("wq", "bq", "wk", "bk", "wv", "bv", "wo"))
            if not names:
                continue
            if len(names) != 7 or mod.num_heads % size:
                raise ValueError(f"{mod_name}: {mod.num_heads} heads over "
                                 f"{size} ranks")
            for n in ("wq", "wk", "wv"):
                _shard_(mod, n, 1, grid)
            for n in ("bq", "bk", "bv", "wo"):
                _shard_(mod, n, 0, grid)
            h = mod.num_heads // size
            mod.__class__ = TensorParallelMHA
            mod.grid, mod.heads = grid, (grid.model_rank * h, mod.num_heads)
            mod.num_heads = h
            done.update(names)
        else:
            pairs = []
            if isinstance(mod, FFN):
                pairs = [("linear1", "linear2", False)]
            elif isinstance(mod, MLP) and mod.n >= 2:
                gather = mod.n == 2 or hasattr(mod, "ln1")
                pairs = [("linear1", "linear2" if mod.n > 2 else None,
                          gather)]
            elif isinstance(mod, TransCARHead):
                pairs = [(f"fusion{i}_linear1", f"fusion{i}_linear2", False)
                         for i in range(mod.cfg.num_fusion_layers)
                         if hasattr(mod, f"fusion{i}_linear1")]
            for first, second, gather in pairs:
                names = owned(pre + first + ".", ("weight", "bias"))
                if second:
                    names += owned(pre + second + ".", ("weight",))
                if not names:
                    continue
                _column(getattr(mod, first), grid, gather)
                if second:
                    _row(getattr(mod, second), grid, not gather)
                done.update(names)
    left = sorted(set(dims) - done)
    if left:
        raise NotImplementedError(f"no split form for {left[:5]}")
    return sorted(done)


def gathered_state(model: nn.Module, grid,
                   tensors: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a split model (every split parameter
    all-gathered along its dim), as the replicated model holds it;
    ``tensors``: tensors named and shaped as parameters (their
    gradients, say) to gather instead."""
    out = {}
    params = dict(model.named_parameters())
    for name, t in (model.state_dict() if tensors is None
                    else tensors).items():
        dim = getattr(params.get(name), "tp_dim", None)
        if dim is None:
            out[name] = t
            continue
        moved = t.detach().movedim(dim, -1)
        full = _gather(moved, grid.model_group, grid.model_rank,
                       grid.model_size)
        out[name] = full.movedim(-1, dim).contiguous()
    return out


def clip_grad_norm_(params: Iterable[nn.Parameter], max_norm: float,
                    grid) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` of a split model: a split
    parameter's norm is that of its whole gradient (its slices' squared
    norms summed over the model group, in one all-reduce); the clip
    coefficient max_norm / (norm + 1e-6), at most 1, as torch's."""
    params = [p for p in params if p.grad is not None]
    norms = [torch.linalg.vector_norm(p.grad) for p in params]
    split = [i for i, p in enumerate(params)
             if getattr(p, "tp_dim", None) is not None]
    if split:
        sq = summed(torch.stack([norms[i] ** 2 for i in split]),
                  grid.model_group)
        for j, i in enumerate(split):
            norms[i] = sq[j].sqrt()
    total = torch.linalg.vector_norm(torch.stack(norms))
    coef = (max_norm / (total + 1e-6)).clamp(max=1.0)
    for p in params:
        p.grad.mul_(coef)
    return total


def split_params(model: nn.Module) -> Tuple[str, ...]:
    """Names of ``model``'s split parameters."""
    return tuple(n for n, p in model.named_parameters()
                 if getattr(p, "tp_dim", None) is not None)
