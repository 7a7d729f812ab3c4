"""Masked fusion-attention kernel for Hopper (``csrc/masked_attention.cu``).

Replaces ``transcar_tpu/ops/pallas_attention.py::masked_mha_pallas`` (the
Pallas TPU ``_kernel``): softmax(QKᵀ/√hd under a keep-mask) · V per
(batch·head, query tile), float32 with no TF32 and no bf16 anywhere (the
head's numerics are ``Precision.HIGHEST`` by policy).  As in JAX, the
Q/K/V/O projections stay outside the kernel as ``torch.matmul``.

What bounds it on the H100: the flagship's three fusion layers each do
900 queries × 1500 radar tokens × 8 heads × hd 32, about 1.4 GFLOP and a
1.35 MB uint8 mask, which is far too little work to fill 132 SMs for
long: it is latency bound, not FLOP or byte bound.

What the design does about it: one block per (batch·head, 32-query
tile), 232 blocks at the flagship shape, so every SM has work.  Each lane
owns one query; the block's four warps split every 64-token chunk of K/V
(staged in shared memory, since a head's whole K+V is 384 KB) and run an
online softmax (running max and sum) over their quarter, and the four
partial states merge once at the end.  The [Q, T] logits never reach
device memory, and K/V and the mask are read once per block.  A masked
logit is ``finfo(float32).min / 2`` as in JAX, so a fully-masked row stays
finite; its value is unspecified and the head gates it away.
"""
from __future__ import annotations

import ctypes
import math

import torch

from transcar_tpu_torch.ops import kernel_lib
from transcar_tpu_torch.ops.attention import (attention_core, merge_heads,
                                              split_heads)

#: Kernel launches since the count was last set to 0.
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def masked_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """The attention core: qh [B, H, Q, hd], kh/vh [B, H, T, hd] float32,
    keep bool [B, Q, T] (True = token visible) → [B, H, Q, hd].

    A CPU tensor takes the plain version (``ops/attention.py``); a CUDA
    tensor launches the kernel or raises.
    """
    if qh.device.type == "cpu":
        return attention_core(qh, kh, vh, ~keep)
    global launches
    b, h, nq, hd = qh.shape
    t = kh.shape[2]
    if not all(a.dtype == torch.float32 for a in (qh, kh, vh)):
        raise TypeError("attention kernel takes float32 q, k and v")
    if kh.shape != (b, h, t, hd) or vh.shape != kh.shape:
        raise ValueError(f"k {tuple(kh.shape)} / v {tuple(vh.shape)} must "
                         f"be [{b}, {h}, T, {hd}]")
    if keep.shape != (b, nq, t) or keep.dtype != torch.bool:
        raise ValueError(f"keep {tuple(keep.shape)} {keep.dtype} must be "
                         f"bool [{b}, {nq}, {t}]")
    if hd != 32:
        raise ValueError(f"attention kernel is built for head dim 32, "
                         f"got {hd}")
    if not all(a.is_cuda and a.device == qh.device for a in (qh, kh, vh, keep)):
        raise ValueError("attention kernel: all tensors must be on one "
                         "CUDA device")
    qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
    keep = keep.contiguous().view(torch.uint8)
    out = torch.empty_like(qh)
    fn = kernel_lib.function("masked_attention_f32", _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, ctypes.c_float, _P)
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), keep.data_ptr(),
                out.data_ptr(), b * h, h, nq, t, hd, 1.0 / math.sqrt(hd),
                stream)
    kernel_lib.check(rc, "masked_attention_f32")
    launches += 1
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
