"""Multi-head attention with boolean masking (``transcar_tpu/ops/attention.py``).

A *safe* masked softmax over the full static shape: a masked logit is set
to ``finfo(float32).min / 2``, so a fully-masked query row produces finite
values (uniform attention) that callers gate away with "row has ≥ 1
visible token".  ``dropout`` drops attention probabilities (torch
``nn.MultiheadAttention`` semantics) and is given only in training.

Weight convention as in the JAX package: ``wq``/``wk``/``wv``/``wo`` are
``[in, out]`` (y = x @ W + b), the transpose of ``nn.Linear.weight``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = float(torch.finfo(torch.float32).min) / 2


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, E] → [B, H, L, E/H]."""
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, hd] → [B, L, H·hd]."""
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def attention_core(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   dropout: float = 0.0,
                   heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """softmax(QKᵀ/√hd) · V per head.

    qh: [B, H, Q, hd]; kh, vh: [B, H, T, hd]; mask: optional bool
    [B, Q, T], True = position MASKED (torch ``attn_mask``); dropout: the
    rate applied to the attention probabilities.  ``heads`` = (first,
    total) says that these H heads are heads first .. first + H of
    ``total`` (tensor parallelism): the dropout mask is drawn for all
    ``total`` and sliced, so the split model drops what the whole one
    does.
    """
    logits = qh @ kh.transpose(-1, -2) / math.sqrt(qh.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if dropout > 0.0:
        if heads is None:
            probs = F.dropout(probs, dropout)
        else:
            first, total = heads
            b, h, q, t = probs.shape
            keep = F.dropout(probs.new_ones(b, total, q, t), dropout)
            probs = probs * keep[:, first:first + h]
    return probs @ vh


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        params: dict, num_heads: int,
                        mask: Optional[torch.Tensor] = None,
                        dropout: float = 0.0) -> torch.Tensor:
    """Torch-semantics multi-head attention: q [B, Q, E], k/v [B, T, E]
    → [B, Q, E] (out-projected)."""
    qh = split_heads(q @ params["wq"] + params["bq"], num_heads)
    kh = split_heads(k @ params["wk"] + params["bk"], num_heads)
    vh = split_heads(v @ params["wv"] + params["bv"], num_heads)
    out = merge_heads(attention_core(qh, kh, vh, mask, dropout))
    return out @ params["wo"] + params["bo"]
