"""ObjDGCNN: LiDAR pillars or voxels → BEV deformable-DETR detector
(``transcar_tpu/models/dgcnn.py``).

Parity targets, as in the JAX package:
  * ``ObjDGCNN`` (models/detectors/obj_dgcnn.py): voxelize → VFE →
    scatter (or the sparse encoder) → SECOND → FPN → head.
  * ``DGCNN3DHead`` (models/dense_heads/dgcnn3d_head.py): BEV sine
    positional encodings over all-valid masks, a 2-layer deformable-DETR
    encoder and a 6-layer decoder with 2D reference points, xy-only
    denormalization of the outputs.
  * ``DGCNNAttn`` (models/utils/dgcnn_attn.py): cdist affinity → top-K=16
    neighbours — the reference takes the K *largest* distances, kept —
    edge features cat(neighbour, centre) → two 1×1 conv-BN-ReLU stages
    with a max over the neighbours.
  * ``Deformable3DDetrTransformerDecoder`` (models/utils/detr.py:67-100):
    refinement keeps only the first 2 dims of the 10-dim reg output, and
    the reference points pass on detached.

The head runs in float32 with no TF32 (``common.disable_tf32``); every
deformable attention, the encoder's 2 and the decoder's 6, goes through
the kernel wrapper (``ops/pallas_msdeform.py``: K7 forward, K8 and K9
backward) unless its ``impl`` is set to "xla", the plain version on any
device.  In train mode every BatchNorm takes batch statistics (the VFE's
masked to real pillars, the sparse encoder's to active sites) and
``dropout`` applies where the JAX modules place it: after each
MSDeformAttention and DGCNNAttn, and twice in each FFN.

Two LiDAR encoders, as in JAX: ``"pillar"`` (PillarFeatureNet, scatter,
SECOND (3, 5, 5) / (2, 2, 2) / (64, 128, 256)) and ``"voxel"``
(HardSimpleVFE, the sparse 3D middle encoder of
``models/sparse_encoder.py``, SECOND (5, 5) / (1, 2) / (128, 256) on its
256-channel BEV).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.core.boxes import inverse_sigmoid
from transcar_tpu_torch.core.device import const
from transcar_tpu_torch.models.common import FFN, LN_EPS, MLP, BatchNorm
from transcar_tpu_torch.models.second import BNFPN, SECOND
from transcar_tpu_torch.models.sparse_encoder import SparseEncoder
from transcar_tpu_torch.ops import pallas_msdeform
from transcar_tpu_torch.ops.msdeform import ms_deform_attn_core
from transcar_tpu_torch.ops.voxelize import hard_voxelize, pillar_scatter


def sine_positional_encoding(h: int, w: int, num_feats: int = 128,
                             temperature: float = 10000.0,
                             offset: float = -0.5,
                             scale: float = 2 * math.pi,
                             device=None,
                             dtype=torch.float32) -> torch.Tensor:
    """mmdet SinePositionalEncoding(normalize=True, offset=-0.5) over an
    all-valid mask → [H, W, 2·num_feats] in ``dtype``: the normalized
    coordinates in float32 and the frequencies and sines in ``dtype``, as
    the JAX function computes them (float64 only under ``jax_enable_x64``,
    which the CPU parity tests use)."""
    eps = 1e-6
    # the cumulative sums of an all-valid mask: 1..h down, 1..w across
    # (exact in float32; a float cumsum has no deterministic CUDA kernel)
    y = torch.arange(1.0, h + 1.0, device=device)[:, None].expand(h, w)
    x = torch.arange(1.0, w + 1.0, device=device)[None, :].expand(h, w)
    y = (y + offset) / (y[-1:, :] + eps) * scale
    x = (x + offset) / (x[:, -1:] + eps) * scale
    exps = (2 * (torch.arange(num_feats, device=device) // 2)).to(dtype)
    dim_t = temperature ** (exps / num_feats)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                     -1).reshape(h, w, num_feats)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                     -1).reshape(h, w, num_feats)
    return torch.cat([py, px], -1)


class MSDeformAttention(nn.Module):
    """mmcv MultiScaleDeformableAttention: its parameter layout
    (``sampling_offsets``, ``attention_weights``, ``value_proj``,
    ``output_proj``) and math.  ``impl``: "pallas" takes the kernel
    wrapper (K7 forward and K8 / K9 backward on the card, the plain
    version on the CPU), "xla" the plain version anywhere;
    ``query_chunk`` bounds the plain version's intermediates and does not
    reach the kernels."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 dropout: float = 0.1, query_chunk: int = 0,
                 impl: str = "pallas"):
        super().__init__()
        if impl not in ("pallas", "xla"):
            raise ValueError(f"unknown msdeform impl {impl!r}")
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.dropout = num_points, dropout
        self.query_chunk, self.impl = query_chunk, impl
        hlp = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, hlp * 2)
        self.attention_weights = nn.Linear(embed_dims, hlp)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def offset_bias(self) -> torch.Tensor:
        """mmcv's init of the offset bias: heads spread on a circle,
        scaled by the point index."""
        h, l, p = self.num_heads, self.num_levels, self.num_points
        thetas = torch.arange(h, dtype=torch.float32) * (2 * math.pi / h)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        grid = grid[:, None, None, :].repeat(1, l, p, 1)
        grid = grid * torch.arange(1, p + 1, dtype=torch.float32)[
            None, None, :, None]
        return grid.reshape(-1)

    def forward(self, query, query_pos, value,
                spatial_shapes: Sequence[Tuple[int, int]], reference_points):
        """query: [B, Q, E]; value: [B, S, E]; reference_points:
        [B, Q, L, 2] in [0, 1]."""
        h, l, p = self.num_heads, self.num_levels, self.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos
        b, q, e = query.shape
        offsets = self.sampling_offsets(query).reshape(b, q, h, l, p, 2)
        weights = self.attention_weights(query).reshape(b, q, h, l * p)
        weights = weights.softmax(-1).reshape(b, q, h, l, p)
        val = self.value_proj(value).reshape(b, -1, h, e // h)
        normalizer = const([[wl, hl] for hl, wl in spatial_shapes],
                           query.device)
        loc = (reference_points[:, :, None, :, None, :]
               + offsets / normalizer[None, None, None, :, None, :])
        if self.impl == "pallas":
            out = pallas_msdeform.ms_deform_attn(val, spatial_shapes, loc,
                                                 weights, self.query_chunk)
        else:
            out = ms_deform_attn_core(val, spatial_shapes, loc, weights,
                                      self.query_chunk)
        out = F.dropout(self.output_proj(out), self.dropout, self.training)
        return identity + out


class DGCNNAttn(nn.Module):
    """Graph self-attention replacement (dgcnn_attn.py:40-96)."""

    def __init__(self, embed_dims: int = 256, k: int = 16,
                 dropout: float = 0.1):
        super().__init__()
        self.k, self.dropout = k, dropout
        for name in ("conv1", "conv2"):
            setattr(self, name, nn.Linear(2 * embed_dims, embed_dims,
                                          bias=False))
            setattr(self, name + "_bn", BatchNorm(embed_dims,
                                                  channel_dim=-1))

    def _edge_feats(self, x):
        # affinity as the JAX module computes it, by broadcasting (not
        # torch.cdist, whose matmul path rounds differently and can change
        # which neighbours top-k selects); topk keeps the K LARGEST
        d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
        aff = d2.clamp(min=0.0).sqrt()
        _, idx = torch.topk(aff, min(self.k, x.shape[1]), dim=-1)  # [B,N,K]
        # neighbour ROWS gathered directly ([B, N, K, C]; ``F.embedding``,
        # whose backward sums each row's gradients by a sort of the row
        # indices); ties may order differently from lax.top_k, but only
        # the set meets the max below
        b, n, c = x.shape
        batch = torch.arange(b, device=x.device)[:, None, None] * n
        neigh = F.embedding(idx + batch, x.reshape(b * n, c))
        center = x[:, :, None, :].expand_as(neigh)
        return torch.cat([neigh, center], -1)

    def _conv_bn_relu(self, x, name):
        return F.relu(getattr(self, name + "_bn")(getattr(self, name)(x)))

    def forward(self, query, query_pos):
        residual = query
        if query_pos is not None:
            query = query + query_pos
        e1 = self._conv_bn_relu(self._edge_feats(query), "conv1").amax(2)
        e2 = self._conv_bn_relu(self._edge_feats(e1), "conv2").amax(2)
        return residual + F.dropout(e1 + e2, self.dropout, self.training)


class PillarFeatureNet(nn.Module):
    """mmdet3d PillarFeatureNet (legacy=False): raw 5-dim point features
    + 3 cluster-centre offsets + 2 pillar-centre offsets → Linear-BN-ReLU
    → max over points."""

    def __init__(self, in_channels: int = 5, feat_channels: int = 64,
                 voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2,
                                                51.2, 3.0)):
        super().__init__()
        self.voxel_size, self.pc_range = voxel_size, pc_range
        self.pfn0 = nn.Linear(in_channels + 5, feat_channels, bias=False)
        # eps 1e-3 as the VFE's MaskedBN, whose batch statistics exclude
        # padding pillars (zero-padded points of real pillars count)
        self.pfn0_bn = BatchNorm(feat_channels, eps=1e-3, channel_dim=-1)

    def forward(self, voxels, coords, counts):
        """voxels: [P, M, F]; coords: [P, 3] (z, y, x); counts: [P]."""
        m = voxels.shape[1]
        cnt = counts.clamp(min=1)[:, None, None].to(voxels.dtype)
        mean = voxels[..., :3].sum(1, keepdim=True) / cnt
        f_cluster = voxels[..., :3] - mean
        vx, vy = self.voxel_size
        cx = coords[:, 2:3].to(voxels.dtype) * vx + vx / 2 + self.pc_range[0]
        cy = coords[:, 1:2].to(voxels.dtype) * vy + vy / 2 + self.pc_range[1]
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy], -1)
        feats = torch.cat([voxels, f_cluster, f_center], -1)
        mask = (torch.arange(m, device=voxels.device)[None, :]
                < counts[:, None])[..., None]
        feats = feats * mask.to(feats.dtype)
        x = F.relu(self.pfn0_bn(self.pfn0(feats), (counts > 0)[:, None]))
        x = torch.where(mask, x, float("-inf")).amax(1)
        return torch.where(counts[:, None] > 0, x, 0.0)


class DGCNN3DHead(nn.Module):
    """Deformable-DETR head over BEV features."""

    def __init__(self, cfg, num_encoder_layers: int = 2,
                 num_points: int = 4, encoder_query_chunk: int = 16384,
                 dropout: float = 0.1):
        """cfg: a ``HeadConfig``; encoder_query_chunk bounds the plain
        version's intermediates at the encoder's token-count Q (0 = one
        pass; the kernel takes every query in one launch); dropout: the
        rate of every dropout site in training."""
        super().__init__()
        self.cfg = cfg
        e, l = cfg.embed_dims, cfg.num_levels
        self.num_encoder_layers = num_encoder_layers
        self.level_embeds = nn.Parameter(torch.zeros(l, e))
        for i in range(num_encoder_layers):
            setattr(self, f"encoder{i}_attn", MSDeformAttention(
                e, cfg.num_heads, l, num_points, dropout=dropout,
                query_chunk=encoder_query_chunk))
            setattr(self, f"encoder{i}_norm1", nn.LayerNorm(e, eps=LN_EPS))
            setattr(self, f"encoder{i}_ffn", FFN(e, cfg.ffn_dims, dropout))
            setattr(self, f"encoder{i}_norm2", nn.LayerNorm(e, eps=LN_EPS))
        self.query_embedding = nn.Parameter(torch.zeros(cfg.num_query, 2 * e))
        self.reference_points = nn.Linear(e, 2)
        for i in range(cfg.num_decoder_layers):
            setattr(self, f"decoder{i}_self_attn",
                    DGCNNAttn(e, dropout=dropout))
            setattr(self, f"decoder{i}_norm1", nn.LayerNorm(e, eps=LN_EPS))
            setattr(self, f"decoder{i}_cross_attn", MSDeformAttention(
                e, cfg.num_heads, l, num_points, dropout=dropout))
            setattr(self, f"decoder{i}_norm2", nn.LayerNorm(e, eps=LN_EPS))
            setattr(self, f"decoder{i}_ffn", FFN(e, cfg.ffn_dims, dropout))
            setattr(self, f"decoder{i}_norm3", nn.LayerNorm(e, eps=LN_EPS))
            setattr(self, f"cls_branch{i}", MLP(e, (e, e, cfg.num_classes),
                                                layer_norm=True))
            setattr(self, f"reg_branch{i}", MLP(e, (e, e, cfg.code_size)))

    def forward(self, mlvl_feats):
        """mlvl_feats: L float32 tensors [B, H_l, W_l, E] → dict of
        all_cls_scores [layers, B, Q, classes] and all_bbox_preds
        [layers, B, Q, code_size]."""
        c = self.cfg
        e = c.embed_dims
        b = mlvl_feats[0].shape[0]
        l = len(mlvl_feats)
        dev = mlvl_feats[0].device
        shapes = [(f.shape[1], f.shape[2]) for f in mlvl_feats]
        lo = const(c.pc_range[:2], dev)
        hi = const(c.pc_range[3:5], dev)

        tokens, pos, refs = [], [], []
        for li, (f, (hl, wl)) in enumerate(zip(mlvl_feats, shapes)):
            tokens.append(f.reshape(b, hl * wl, e))
            pe = sine_positional_encoding(hl, wl, e // 2, device=dev,
                                          dtype=self.level_embeds.dtype)
            pos.append((pe.reshape(1, -1, e) + self.level_embeds[li])
                       .expand(b, -1, -1))
            # encoder reference points: the level's normalized cell centres
            ry = (torch.arange(hl, dtype=torch.float32, device=dev) + 0.5) / hl
            rx = (torch.arange(wl, dtype=torch.float32, device=dev) + 0.5) / wl
            gy, gx = torch.meshgrid(ry, rx, indexing="ij")
            refs.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        x = torch.cat(tokens, 1)                                # [B, S, E]
        pos_embed = torch.cat(pos, 1)
        enc_ref = torch.cat(refs, 0)[None, :, None, :].expand(b, -1, l, 2)

        for i in range(self.num_encoder_layers):
            x = getattr(self, f"encoder{i}_attn")(x, pos_embed, x, shapes,
                                                  enc_ref)
            x = getattr(self, f"encoder{i}_norm1")(x)
            x = getattr(self, f"encoder{i}_ffn")(x)
            x = getattr(self, f"encoder{i}_norm2")(x)
        memory = x

        query_pos = self.query_embedding[:, :e].expand(b, -1, -1)
        query = self.query_embedding[:, e:].expand(b, -1, -1)
        ref = torch.sigmoid(self.reference_points(query_pos))

        out_cls, out_coord = [], []
        for i in range(c.num_decoder_layers):
            query = getattr(self, f"decoder{i}_self_attn")(query, query_pos)
            query = getattr(self, f"decoder{i}_norm1")(query)
            ref_in = ref[:, :, None, :].expand(-1, -1, l, 2)
            query = getattr(self, f"decoder{i}_cross_attn")(
                query, query_pos, memory, shapes, ref_in)
            query = getattr(self, f"decoder{i}_norm2")(query)
            query = getattr(self, f"decoder{i}_ffn")(query)
            query = getattr(self, f"decoder{i}_norm3")(query)

            tmp = getattr(self, f"reg_branch{i}")(query)
            xy = torch.sigmoid(tmp[..., 0:2] + inverse_sigmoid(ref))
            out_coord.append(torch.cat([xy * (hi - lo) + lo, tmp[..., 2:]],
                                       -1))
            out_cls.append(getattr(self, f"cls_branch{i}")(query))
            ref = xy.detach()
        return {"all_cls_scores": torch.stack(out_cls),
                "all_bbox_preds": torch.stack(out_coord)}


class ObjDGCNN(nn.Module):
    """LiDAR detector: pillars or voxels → SECOND → FPN → DGCNN head.

    ``encoder="pillar"``: PillarFeatureNet + scatter (the pillar config).
    ``encoder="voxel"``: HardSimpleVFE (the per-voxel mean of its points)
    + the sparse 3D encoder on ``sparse_shape`` in ``sparse_impl``
    ("gather" | "dense"), float32, or for "dense" its convs in
    ``compute_dtype`` (the voxel config).  The BEV convolutions run in
    ``compute_dtype`` (bfloat16 on the presets; None = float32) and the
    head in float32; ``dropout`` is the head's rate in training.
    """

    def __init__(self, cfg, encoder: str = "pillar",
                 voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0),
                 max_points: int = 20, max_voxels: int = 30000,
                 bev_hw: Tuple[int, int] = (512, 512),
                 compute_dtype: Optional[str] = "bfloat16",
                 dropout: float = 0.1,
                 sparse_shape: Tuple[int, int, int] = (41, 1024, 1024),
                 sparse_impl: str = "gather"):
        """cfg: a ``HeadConfig``."""
        super().__init__()
        self.cfg, self.encoder = cfg, encoder
        self.voxel_size, self.max_points = voxel_size, max_points
        self.max_voxels, self.bev_hw = max_voxels, bev_hw
        self.compute_dtype = compute_dtype
        if encoder == "pillar":
            self.vfe = PillarFeatureNet(5, 64, voxel_size[:2], cfg.pc_range)
            self.backbone = SECOND(64)
            bev_channels = (64, 128, 256)
        elif encoder == "voxel":
            self.middle_encoder = SparseEncoder(
                5, sparse_shape, impl=sparse_impl,
                compute_dtype=compute_dtype)
            self.backbone = SECOND(256, (5, 5), (1, 2), (128, 256))
            bev_channels = (128, 256)
        else:
            raise ValueError(f"unknown encoder {encoder!r}")
        self.neck = BNFPN(bev_channels, cfg.embed_dims, cfg.num_levels)
        self.head = DGCNN3DHead(cfg, dropout=dropout)

    def bev_features(self, points, num_points):
        """Voxelize, encode and scatter: the FPN levels as float32
        [B, H_l, W_l, E] (rounded to float32 as in JAX, then in the head's
        dtype: a float64 model, as the CPU parity tests build, promotes
        them as flax's ``Dense`` does)."""
        b = points.shape[0]
        if self.encoder == "voxel":
            canvas = self.middle_encoder(*self.voxel_features(
                points, num_points))                        # [B, H', W', 256]
        else:
            voxels, coords, counts, nv = hard_voxelize(
                points, num_points, self.voxel_size, self.cfg.pc_range,
                self.max_points, self.max_voxels)
            pv, m, f = voxels.shape[1:]
            feats = self.vfe(voxels.reshape(b * pv, m, f),
                             coords.reshape(b * pv, 3),
                             counts.reshape(b * pv))
            canvas = pillar_scatter(feats.reshape(b, pv, -1), coords, nv,
                                    self.bev_hw)             # [B, H, W, 64]
        dt = getattr(torch, self.compute_dtype or "float32")
        x = canvas.to(dt).permute(0, 3, 1, 2)          # NCHW, channels last
        feats = self.neck(self.backbone(x))
        head_dt = self.head.level_embeds.dtype
        return [f.permute(0, 2, 3, 1).float().to(head_dt) for f in feats]

    def voxel_features(self, points, num_points):
        """Hard voxelization and HardSimpleVFE (the mean of a voxel's
        points): the middle encoder's inputs, features [B, V, 5], coords
        [B, V, 3] (z, y, x) and the voxel count [B]."""
        voxels, coords, counts, nv = hard_voxelize(
            points, num_points, self.voxel_size, self.cfg.pc_range,
            self.max_points, self.max_voxels)
        denom = counts.clamp(min=1)[..., None].to(voxels.dtype)
        return voxels.sum(2) / denom, coords, nv

    def forward(self, points, num_points):
        """points: [B, N_max, 5]; num_points: [B] → the head's dict."""
        return self.head(self.bev_features(points, num_points))
