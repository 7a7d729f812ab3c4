"""DETR3D query decoder layer (``transcar_tpu/models/detr3d.py``):
self-attn → 3D-reference cross-attn → FFN, post-norm.  In training,
dropout (``dropout``, 0.1 in the reference) acts on the attention
probabilities, the self-attention and cross-attention outputs and the
FFN, as in the JAX modules."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.core.boxes import denorm_points, inverse_sigmoid
from transcar_tpu_torch.core.geometry import project_points_to_cams
from transcar_tpu_torch.models.common import FFN, LN_EPS, MLP, TorchMHA
from transcar_tpu_torch.ops.sampling import sample_multiview_multilevel


class Detr3DCrossAttention(nn.Module):
    """Project 3D reference points into every camera, sample the FPN
    levels there, and fuse with learned per-(cam, point, level) weights."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 num_points: int = 1, num_levels: int = 4,
                 pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0,
                                                51.2, 51.2, 3.0),
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.num_cams, self.num_points = num_cams, num_points
        self.num_levels, self.pc_range = num_levels, pc_range
        self.attention_weights = nn.Linear(
            embed_dims, num_cams * num_points * num_levels)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.position_encoder = MLP(3, (embed_dims, embed_dims),
                                    layer_norm=True, final_activation=True)

    def forward(self, query, query_pos, ref_points01, mlvl_feats, lidar2img,
                img_hw):
        """query/query_pos: [B, Q, E]; ref_points01: [B, Q, 3] in [0, 1];
        mlvl_feats: list of [B, N, H, W, E]; lidar2img: [B, N, 4, 4]."""
        b, nq, _ = query.shape
        weights = self.attention_weights(query + query_pos).reshape(
            b, nq, self.num_cams, self.num_points, self.num_levels)
        ref_m = denorm_points(ref_points01, self.pc_range)
        uv01, vis = project_points_to_cams(ref_m, lidar2img, img_hw)
        sampled = sample_multiview_multilevel(mlvl_feats, uv01)
        sampled = sampled[:, :, :, None]                      # [B,Q,N,P,L,E]
        vis_w = vis.transpose(1, 2)[:, :, :, None, None]      # [B,Q,N,1,1]
        w = torch.sigmoid(weights) * vis_w.to(weights.dtype)
        dt = torch.promote_types(sampled.dtype, w.dtype)   # as jnp.einsum
        fused = torch.einsum("bqnple,bqnpl->bqe", sampled.to(dt), w.to(dt))
        pos_feat = self.position_encoder(inverse_sigmoid(ref_points01))
        out = F.dropout(self.output_proj(fused), self.dropout, self.training)
        return out + query + pos_feat


class Detr3DDecoderLayer(nn.Module):
    """One DetrTransformerDecoderLayer: mmcv MultiheadAttention residual
    semantics (pos added to q and k, not v; the residual is the pre-pos
    query), then LayerNorm after each of the three sublayers."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 ffn_dims: int = 512, num_cams: int = 6, num_points: int = 1,
                 num_levels: int = 4,
                 pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0,
                                                51.2, 51.2, 3.0),
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = TorchMHA(embed_dims, num_heads, dropout)
        self.norm1 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.cross_attn = Detr3DCrossAttention(embed_dims, num_cams,
                                               num_points, num_levels,
                                               pc_range, dropout)
        self.norm2 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.ffn = FFN(embed_dims, ffn_dims, dropout)
        self.norm3 = nn.LayerNorm(embed_dims, eps=LN_EPS)

    def forward(self, query, query_pos, ref_points01, mlvl_feats, lidar2img,
                img_hw):
        q = query + query_pos
        attn = F.dropout(self.self_attn(q, q, query), self.dropout,
                         self.training)
        query = self.norm1(query + attn)
        query = self.norm2(self.cross_attn(query, query_pos, ref_points01,
                                           mlvl_feats, lidar2img, img_hw))
        return self.norm3(self.ffn(query))
