"""Masked fusion-attention kernel for Hopper (``csrc/masked_attention.cu``).

Replaces ``transcar_tpu/ops/pallas_attention.py::masked_mha_pallas`` (the
Pallas TPU ``_kernel``): softmax(QKᵀ/√hd under a keep-mask) · V per
(batch, head), float32 in and out (the head's numerics are
``Precision.HIGHEST`` by policy, so no single TF32 product anywhere).  As
in JAX, the Q/K/V/O projections stay outside the kernel as
``torch.matmul``.

What bounds it on the H100: the flagship's three fusion layers each do
900 queries × 1500 radar tokens × 8 heads × hd 32, 1.38 GFLOP and a
1.35 MB uint8 mask.  As float32 FMAs that is 20.6 µs at 67 TFLOP/s; the
kernel takes both products on the tensor cores in three TF32 products
(lo·hi + hi·lo + hi·hi of x = hi + lo), 4.15 GFLOP, 8.4 µs at 495 TFLOP/s.
At hd 32 every product is small (m64n32k8), so what paces it is latency:
the split of each chunk's K and V, the copies and the softmax between
the products, not the tensor cores.

What the design does about it (FlashAttention-2's layout on ``wgmma``
m64n32k8 TF32): a block is four warpgroups over the same 64 query rows
of one (batch, head); each takes every fourth 32-token chunk through its
own ``cp.async`` ring and its own barrier, so that the four drift apart
and overlap one another's latencies, and their softmax states merge in
shared memory at the end (120 blocks at the flagship, 480 at batch 4).
Q is split once into shared-memory tiles (the A operand of S = QKᵀ);
each chunk's K and V are split into K-major TF32 tiles (V transposed),
S and P stay in registers under an online softmax, and P's accumulator
is P·V's A fragment with the tokens relabelled.  The [Q, T] logits never
reach device memory; every chunk is computed whatever its keep density.
The kernel reads the [B, H, L, 32] views of ``split_heads`` in place and
writes a [B, Q, H, 32] buffer, so ``merge_heads`` of its output is a
view: no copy kernels around it.

A masked logit is ``finfo(float32).min / 2`` as in JAX and tokens past T
drop out, so a fully-masked row is the uniform average of v over the T
tokens, as in the plain version; the head gates it away.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from transcar_tpu_torch.ops import counts, kernel_lib
from transcar_tpu_torch.ops.attention import (attention_core, merge_heads,
                                              split_heads)

#: Kernel launches since the count was last set to 0.
launches = 0
#: Of those, the launches of the tensor-core (``wgmma``) kernel; it is
#: K2's only kernel, so every launch counts here too.
mma_launches = 0

HEAD_DIM = 32
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (ctypes.c_float, _P)


def kernel_strides(*heads: torch.Tensor) -> list:
    """The (batch, head, row) element strides of [B, H, L, 32] views, in
    the order the C entry takes them; raises unless the head dim has unit
    stride and every row starts 16 bytes aligned."""
    out = []
    for x in heads:
        s = x.stride()
        if s[3] != 1:
            raise ValueError(f"attention kernel: the head dim must have "
                             f"unit stride, got strides {s}")
        if x.data_ptr() % 16 or s[0] % 4 or s[1] % 4 or s[2] % 4:
            raise ValueError(f"attention kernel: rows must be 16-byte "
                             f"aligned, got strides {s} at "
                             f"{x.data_ptr():#x}")
        out += s[:3]
    return out


def keep_rows(keep: torch.Tensor) -> torch.Tensor:
    """keep bool [B, Q, T] as the kernel reads it: contiguous uint8 rows a
    multiple of 4 bytes long (the kernel copies them in 4-byte pieces);
    rows of T % 4 != 0 tokens are padded with zeros (one pass)."""
    keep = keep.contiguous().view(torch.uint8)
    pad = -keep.shape[-1] % 4
    return F.pad(keep, (0, pad)) if pad else keep


def _masked_attention_cpu(qh, kh, vh, keep):
    out = _empty_out(qh)
    return out.copy_(attention_core(qh, kh, vh, ~keep))


def _masked_attention_fake(qh, kh, vh, keep):
    return _empty_out(qh)


#: The attention core as a registered op,
#: ``torch.ops.transcar.masked_attention(qh, kh, vh, keep)``: qh [B, H, Q,
#: hd], kh/vh [B, H, T, hd] float32, keep bool [B, Q, T] (True = token
#: visible) → [B, H, Q, hd], a view of a [B, Q, H, hd] buffer.  A CUDA
#: tensor launches the kernel (:func:`kernel`) or raises; a CPU tensor
#: takes the plain version (``ops/attention.py``), returned in the same
#: layout, as the fake gives it, so the exported program's strides are the
#: eager ones.
masked_attention = kernel_lib.register_op(
    "masked_attention(Tensor qh, Tensor kh, Tensor vh, Tensor keep) "
    "-> Tensor", cuda=lambda *a: kernel(*a), cpu=_masked_attention_cpu,
    fake=_masked_attention_fake)


@register_flop_formula(torch.ops.transcar.masked_attention)
def _masked_attention_flops(q_shape, k_shape, v_shape, keep_shape, *,
                            out_shape=None, **kwargs) -> float:
    b, h, nq, hd = q_shape
    return counts.masked_attention(b, h, nq, k_shape[2], hd)


def _empty_out(qh: torch.Tensor) -> torch.Tensor:
    """The [B, H, Q, hd] output as a view of a fresh [B, Q, H, hd]
    float32 buffer."""
    b, h, nq, hd = qh.shape
    return qh.new_empty((b, nq, h, hd), dtype=torch.float32).transpose(1, 2)


def kernel(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
           keep: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors (see :data:`masked_attention`): it takes
    views with a unit-stride head dim as they are (``split_heads``)."""
    global launches, mma_launches
    b, h, nq, hd = qh.shape
    t = kh.shape[2]
    dev = qh.device
    if (qh.dtype != torch.float32 or kh.dtype != torch.float32
            or vh.dtype != torch.float32):
        raise TypeError("attention kernel takes float32 q, k and v")
    if kh.shape != (b, h, t, hd) or vh.shape != kh.shape:
        raise ValueError(f"k {tuple(kh.shape)} / v {tuple(vh.shape)} must "
                         f"be [{b}, {h}, T, {hd}]")
    if keep.shape != (b, nq, t) or keep.dtype != torch.bool:
        raise ValueError(f"keep {tuple(keep.shape)} {keep.dtype} must be "
                         f"bool [{b}, {nq}, {t}]")
    if hd != HEAD_DIM:
        raise ValueError(f"attention kernel is built for head dim "
                         f"{HEAD_DIM}, got {hd}")
    if nq < 1 or t < 1:
        raise ValueError(f"attention kernel needs Q >= 1 and T >= 1, got "
                         f"Q {nq}, T {t}")
    if (dev.type != "cuda" or kh.device != dev or vh.device != dev
            or keep.device != dev):
        raise ValueError("attention kernel: all tensors must be on one "
                         "CUDA device")
    out = _empty_out(qh)
    keep = keep_rows(keep)
    strides = kernel_strides(qh, kh, vh, out) + list(keep.stride()[:2])
    fn = kernel_lib.function("masked_attention_wgmma_f32", *ENTRY_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), keep.data_ptr(),
                out.data_ptr(), (ctypes.c_longlong * 14)(*strides), b, h, nq,
                t, keep.shape[-1], hd, 1.0 / math.sqrt(hd), stream)
    kernel_lib.check(rc, "masked_attention_wgmma_f32")
    launches += 1
    mma_launches += 1
    return out


def masked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               params: dict, num_heads: int,
               keep_mask: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``ops.attention.multihead_attention`` with a keep-mask
    (same signature as the JAX ``masked_mha_pallas``).

    q: [B, Q, E]; k, v: [B, T, E]; keep_mask: bool [B, Q, T], True = token
    visible.  Returns [B, Q, E].
    """
    qh = split_heads(q @ params["wq"] + params["bq"], num_heads)
    kh = split_heads(k @ params["wk"] + params["bk"], num_heads)
    vh = split_heads(v @ params["wv"] + params["bv"], num_heads)
    out = merge_heads(masked_attention(qh.float(), kh.float(), vh.float(),
                                       keep_mask))
    return out.to(q.dtype) @ params["wo"] + params["bo"]
