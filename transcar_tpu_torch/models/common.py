"""Shared model building blocks (``transcar_tpu/models/common.py``).

Conventions:
  * The backbone keeps activations as NCHW tensors in channels-last
    memory (cuDNN's fast layout); ``permute(0, 2, 3, 1)`` of such a tensor
    is the NHWC view the JAX package and the DCN kernel use, for free.
  * Parameters are float32; a conv casts its weights to the activation
    dtype (the flax ``nn.Conv(dtype=...)`` analog), so the backbone runs
    in bfloat16 when its input is bfloat16.
  * Head matmuls are full float32 (``Precision.HIGHEST`` in JAX): a flax
    ``Dense`` is an ``nn.Linear`` here, under :func:`disable_tf32`.
  * Parameter names follow the flax tree, so ``train/convert.py`` maps
    one onto the other by a generic walk.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from transcar_tpu_torch.ops.attention import multihead_attention
from transcar_tpu_torch.ops.int8 import dynamic_int8_conv, prepare_weight
from transcar_tpu_torch.ops.pallas_attention import masked_mha
from transcar_tpu_torch.parallel.distributed import global_sum

LN_EPS = 1e-5
#: Share of the old running statistics a BatchNorm train step keeps (flax
#: momentum 0.9, the JAX ``train_bn`` and ``MaskedBN``; torch momentum 0.1).
BN_MOMENTUM = 0.9
#: ``BackboneConfig.quantize`` values: the float path and int8 serving.
QUANTIZE_MODES = ("none", "int8")


def cached_copy(module: nn.Module, name: str, params: Sequence[torch.Tensor],
                dtype: torch.dtype, build):
    """``build()`` (a kernel's layout of ``params`` in ``dtype``), kept on
    ``module`` under ``name`` and rebuilt when a parameter changes (in
    place, which bumps its ``_version``, or moved or replaced), when
    ``dtype`` does or when the inference mode does.  Under tracing
    (``torch.export``) the tensors have no storage to key a cache on: the
    layout is the one :func:`derived_weights_held` holds as the module's
    state, and a traced call without it raises (a layout built in the
    graph would be rebuilt at each call of the program)."""
    if torch.compiler.is_compiling():
        held = module.__dict__.get(_HELD, {}).get(name)
        if held is None:
            raise RuntimeError(
                f"{type(module).__name__}.{name}: traced without its held "
                f"layout; run one eager forward, then trace inside "
                f"derived_weights_held(model)")
        return held()
    key = (tuple((id(w), w._version, w.data_ptr(), w.device) for w in params),
           dtype, torch.is_inference_mode_enabled())
    hit = module.__dict__.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, build())
        module.__dict__[name] = hit
        module.__dict__.setdefault(_CACHED, set()).add(name)
    return hit[1]


_CACHED = "_cached_copy_names"      # the names cached_copy keeps on a module
_HELD = "_held_copies"              # name → rebuild from held buffers


def _dense_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in storage of its own, dense in the order of ``t``'s
    strides (a K-major view of a wider weight stays K-major)."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    dense = t.permute(order).clone(memory_format=torch.contiguous_format)
    return dense.permute([order.index(d) for d in range(t.dim())])


@contextlib.contextmanager
def derived_weights_held(model: nn.Module):
    """Within the block, each kernel layout that :func:`cached_copy` keeps
    on a module of ``model`` (what its last forward built: K-major
    weights, int8 codes and scales, folded affines) is also a
    non-persistent buffer of that module, in storage of its own, and a
    traced :func:`cached_copy` returns those buffers: ``torch.export``
    lifts them into the program's state, computed once, so the program
    builds none of them at a call.  They are the eager caches' values bit
    for bit.  The buffers are removed at the end of the block.  Yields the
    number of tensors held."""
    added = []
    for mod in model.modules():
        for name in sorted(mod.__dict__.get(_CACHED, ())):
            leaves, spec = tree_flatten(mod.__dict__[name][1])
            slots = []              # (buffer name, None) or (None, leaf)
            for i, leaf in enumerate(leaves):
                if isinstance(leaf, torch.Tensor):
                    buf = f"{name}_held{i}"
                    mod.register_buffer(buf, _dense_copy(leaf),
                                        persistent=False)
                    added.append((mod, buf))
                    slots.append((buf, None))
                else:
                    slots.append((None, leaf))
            mod.__dict__.setdefault(_HELD, {})[name] = functools.partial(
                _from_buffers, mod, slots, spec)
    try:
        yield len(added)
    finally:
        for mod, buf in added:
            del mod._buffers[buf]
        for mod in model.modules():
            mod.__dict__.pop(_HELD, None)


def _from_buffers(mod: nn.Module, slots: list, spec):
    return tree_unflatten([leaf if buf is None else getattr(mod, buf)
                           for buf, leaf in slots], spec)


def disable_tf32() -> None:
    """Full float32 matmuls and convolutions: TF32 keeps ~10 mantissa
    bits, and cuDNN allows it for float32 convolutions by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class TorchMHA(nn.Module):
    """Parameters of torch ``nn.MultiheadAttention`` after the in_proj
    split, in the JAX layout (``w*`` are [in, out]); see ops/attention.py.

    ``use_pallas`` with a mask routes through the masked-attention kernel
    wrapper (ops/pallas_attention.py) at inference, as the JAX module
    routes to its Pallas kernel only when deterministic; in training the
    plain formulation runs, with ``dropout`` on the attention
    probabilities (the kernel has no backward)."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        for name in ("q", "k", "v", "o"):
            self.register_parameter(
                "w" + name, nn.Parameter(torch.empty(embed_dims, embed_dims)))
            self.register_parameter(
                "b" + name, nn.Parameter(torch.zeros(embed_dims)))

    def params(self) -> dict:
        return {n: getattr(self, n) for n in
                ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}

    def forward(self, q, k, v, mask=None, use_pallas: bool = False):
        """mask: optional bool [B, Q, T], True = MASKED (torch attn_mask)."""
        if use_pallas and mask is not None and not self.training:
            return masked_mha(q, k, v, self.params(), self.num_heads, ~mask)
        return multihead_attention(
            q, k, v, self.params(), self.num_heads, mask=mask,
            dropout=self.dropout if self.training else 0.0)


class MLP(nn.Module):
    """Linear stack with optional LayerNorm + activation between layers
    (names ``linear{i}`` / ``ln{i}`` as in flax)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 layer_norm: bool = False, final_activation: bool = False):
        super().__init__()
        self.n = len(features)
        self.layer_norm = layer_norm
        self.final_activation = final_activation
        dims = [in_features, *features]
        for i in range(self.n):
            setattr(self, f"linear{i}", nn.Linear(dims[i], dims[i + 1]))
            if layer_norm and (i < self.n - 1 or final_activation):
                setattr(self, f"ln{i}", nn.LayerNorm(dims[i + 1], eps=LN_EPS))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"linear{i}")(x)
            if i < self.n - 1 or self.final_activation:
                if self.layer_norm:
                    x = getattr(self, f"ln{i}")(x)
                x = F.relu(x)
        return x


class FFN(nn.Module):
    """mmcv FFN: Linear → ReLU → Dropout → Linear → Dropout + residual
    (dropout only in training)."""

    def __init__(self, embed_dims: int, hidden_dims: int,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = nn.Linear(embed_dims, hidden_dims)
        self.linear2 = nn.Linear(hidden_dims, embed_dims)

    def forward(self, x):
        y = hidden_dropout(F.relu(self.linear1(x)), self.dropout,
                           self.training, self.linear1)
        return x + F.dropout(self.linear2(y), self.dropout, self.training)


def hidden_dropout(x: torch.Tensor, p: float, training: bool,
                   linear: nn.Module) -> torch.Tensor:
    """``F.dropout`` of an activation of ``linear``'s output features.
    A column-parallel ``linear`` (``parallel/sharding.py``) gives this
    rank's slice of them (its ``columns``: first, stop, width): the mask
    is drawn for the whole width and sliced, so a tensor-parallel model
    drops what the replicated one drops from the same generator."""
    cols = getattr(linear, "columns", None)
    if cols is None or not training or p == 0.0:
        return F.dropout(x, p, training)
    first, stop, width = cols
    mask = F.dropout(x.new_ones(*x.shape[:-1], width), p, True)
    return x * mask[..., first:stop]


def bn_affine(gamma, beta, mean, var, eps: float = 1e-5):
    """Folded FrozenBN affine, y = x·scale + bias, in the statistics'
    dtype (float32)."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


class FrozenBN(nn.Module):
    """BatchNorm with frozen statistics and affine params: a per-channel
    scale and bias, folded in float32 and cast to the activation dtype
    (as the JAX module does).  NCHW."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def affine(self):
        """The folded (scale, bias) the kernels take."""
        return bn_affine(self.weight, self.bias, self.running_mean,
                         self.running_var, self.eps)

    def forward(self, x):
        scale, bias = self.affine()
        shape = (1, -1, 1, 1)
        return (x * scale.to(x.dtype).view(shape)
                + bias.to(x.dtype).view(shape))


class BatchNorm(nn.Module):
    """Trainable BatchNorm (the JAX package's ``train_bn``, ``MaskedBN``
    and ``ConvBN(norm="batch")``, the LiDAR track's
    ``norm_cfg=dict(type='BN')``); ``channel_dim`` is the channel axis (1
    for NCHW, −1 for channels last).

    In eval mode the running statistics normalize.  In train mode the
    batch's do, taken in at least float32 over every axis but the
    channel's, as flax's ``BatchNorm`` takes them: the mean and the
    *biased* variance E[x²] − E[x]² clamped at 0 (flax's
    ``use_fast_variance``; ``F.batch_norm`` would store the unbiased
    variance), and the running statistics keep :data:`BN_MOMENTUM` of
    their value and take the rest from the batch's, in place.  With a
    ``mask`` (the VFE's ``MaskedBN``: True where a row counts,
    broadcastable to ``x`` without its channel axis) the statistics are
    the two-pass masked mean and variance over n = max(rows counted, 1).
    Either way ``(x − mean) · (rsqrt(var + eps) · weight) + bias`` is
    computed in at least float32 and cast back to the input dtype.
    (``MaskedBN`` casts its input to float32 outright: the same for the
    float32 points the VFE takes.)"""

    def __init__(self, features: int, eps: float = 1e-5,
                 channel_dim: int = 1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.group = None       # a data group of 2+ ranks: sum over it
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask=None):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = [1] * x.ndim
        shape[self.channel_dim] = -1
        if self.training:
            mean, var = self._batch_stats(xf, mask, shape)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def _batch_stats(self, xf, mask, shape):
        """(mean, biased variance) over every axis but the channel's."""
        dims = [d for d in range(xf.ndim) if d != self.channel_dim % xf.ndim]
        if self.group is not None:
            return self._global_stats(xf, mask, shape, dims)
        if mask is None:
            mean = xf.mean(dims)
            return mean, ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
        m = mask.to(xf.dtype).unsqueeze(self.channel_dim).expand_as(xf)
        n = (m.sum() / xf.shape[self.channel_dim]).clamp(min=1.0)
        mean = (xf * m).sum(dims) / n
        return mean, (m * (xf - mean.view(shape)) ** 2).sum(dims) / n

    def _global_stats(self, xf, mask, shape, dims):
        """:meth:`_batch_stats` over a data ``group``: the sums and counts
        are those of every rank's rows (``parallel/distributed.
        global_sum``, under autograd), so each rank normalizes with the
        global batch's statistics, as the JAX step over a data mesh
        does."""
        c = xf.shape[self.channel_dim]
        if mask is None:
            n = xf.new_full((1,), xf.numel() // c)
            sums = global_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                         n]), self.group)
            mean, n = sums[:c] / sums[-1], sums[-1]
            return mean, (sums[c:2 * c] / n - mean * mean).clamp(min=0.0)
        m = mask.to(xf.dtype).unsqueeze(self.channel_dim).expand_as(xf)
        sums = global_sum(torch.cat([(xf * m).sum(dims), m.sum()[None]]),
                          self.group)
        n = (sums[-1] / c).clamp(min=1.0)
        mean = sums[:c] / n
        return mean, global_sum((m * (xf - mean.view(shape)) ** 2).sum(dims),
                                self.group) / n


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype (weights are cast)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvBN(nn.Module):
    """Conv (no bias) + BN (+ ReLU), NCHW; names ``conv`` / ``bn``.
    ``norm="frozen"`` is the camera trunk's :class:`FrozenBN` (bf16
    arithmetic in a bf16 backbone), ``norm="batch"`` the LiDAR track's
    trainable :class:`BatchNorm` (float32 arithmetic).

    ``quantize="int8"`` (the int8 serving mode, ``ops/int8.py``) runs the
    conv as a dynamic int8 convolution dequantized into the input's dtype,
    from the same ``conv.weight`` (so the ``state_dict`` and checkpoints
    are the float path's); the weight's codes and scales, and FrozenBN's
    folded affine, are cached per parameter or buffer version
    (:func:`cached_copy`).  FrozenBN and ReLU run in the conv's epilogue
    with the eager path's roundings (the counterpart of XLA's fusion in
    the JAX package); a trainable BN runs after it.

    :meth:`pair` threads the int8 quantize between convs: ``codes`` is
    ``x`` already quantized (one quantize for two convs of one input),
    ``amax`` its ``max|x|`` taken by the producing conv's epilogue (then
    only the codes pass runs); it returns ``(y, max|y|)``, the max a 0-d
    float32 tensor where ``want_amax`` and the int8 epilogue took it, else
    None.  The float path ignores ``codes`` and ``amax``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, relu: bool = True, norm: str = "frozen",
                 quantize: str = "none"):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                           bias=False)
        if norm not in ("frozen", "batch"):
            raise ValueError(f"unknown norm {norm!r}")
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize {quantize!r}")
        self.bn = FrozenBN(cout) if norm == "frozen" else BatchNorm(cout)
        self.relu = relu
        self.quantize = quantize

    def _int8_conv(self, x, codes, amax, want_amax):
        conv = self.conv
        if conv.bias is not None:
            raise ValueError("int8 ConvBN takes a conv without a bias (the "
                             "bias lives in the BN)")
        w = conv.weight
        wq = cached_copy(self, "_int8", [w], torch.int8,
                         lambda: prepare_weight(w))
        frozen = isinstance(self.bn, FrozenBN)
        affine = None
        if frozen:
            bn = self.bn
            affine = cached_copy(
                self, "_int8_affine",
                [bn.weight, bn.bias, bn.running_mean, bn.running_var],
                torch.float32, lambda: tuple(t.contiguous()
                                             for t in bn.affine()))
        out = dynamic_int8_conv(
            x, w, stride=conv.stride[0], padding=conv.padding[0],
            dilation=conv.dilation[0], out_dtype=x.dtype, weight_q=wq,
            affine=affine, relu=self.relu and frozen, codes=codes, amax=amax,
            want_amax=want_amax and frozen)
        if frozen:
            return out if want_amax else (out, None)
        out = self.bn(out)
        return (F.relu(out) if self.relu else out), None

    def pair(self, x, *, codes=None, amax=None, want_amax: bool = False):
        if self.quantize == "int8":
            return self._int8_conv(x, codes, amax, want_amax)
        y = self.bn(self.conv(x))
        return (F.relu(y) if self.relu else y), None

    def forward(self, x, *, codes=None, amax=None):
        return self.pair(x, codes=codes, amax=amax)[0]
