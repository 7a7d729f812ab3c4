"""TransCAR head: DETR3D camera decoding + radar-fusion layers
(``transcar_tpu/models/head.py``; structure and reference citations
there).

Training behaviour as in the JAX head: the reference points are detached
after every decoder layer (iterative refinement, detr3d_transformer.py
:195-203); ``stop_camera_grad`` (fusion-only training) runs the camera
decoder without a graph and detaches its outputs at the fusion input; in
training the fusion layers drop out (rate ``dropout``) their attention
probabilities, attention outputs (gated by "≥ 1 visible token") and FFN,
and take the plain attention formulation.

``strict_reference_compat`` keeps the reference's quirks verbatim: fusion
layer 1 adds NORMALIZED z as its base (the z-denorm no-op), the mask
circles use the −sin/−cos heading convention, and radar padding rows
carry the 500.0 sentinel (placed by the input pipeline, far outside every
circle).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.core.boxes import inverse_sigmoid
from transcar_tpu_torch.core.device import const
from transcar_tpu_torch.models.common import (LN_EPS, MLP, TorchMHA,
                                              hidden_dropout)
from transcar_tpu_torch.models.detr3d import Detr3DDecoderLayer


class TransCARHead(nn.Module):
    def __init__(self, cfg, dropout: float = 0.1):
        """cfg: a ``HeadConfig``; dropout: the training dropout rate."""
        super().__init__()
        self.cfg = c = cfg
        self.dropout = dropout
        e = c.embed_dims
        self.query_embedding = nn.Parameter(torch.empty(c.num_query, 2 * e))
        self.reference_points = nn.Linear(e, 3)
        for i in range(c.num_decoder_layers):
            setattr(self, f"decoder_layer{i}", Detr3DDecoderLayer(
                embed_dims=e, num_heads=c.num_heads, ffn_dims=c.ffn_dims,
                num_cams=c.num_cams, num_points=c.num_points,
                num_levels=c.num_levels, pc_range=c.pc_range,
                dropout=dropout))
            setattr(self, f"cls_branch{i}",
                    MLP(e, (e, e, c.num_classes), layer_norm=True))
            setattr(self, f"reg_branch{i}", MLP(e, (e, e, c.code_size)))
        if c.with_radar_fusion:
            self.radar_pos_encoder = MLP(3, (e, e), layer_norm=True,
                                         final_activation=True)
            self.radar_feat_encoder = MLP(c.radar_feat_dim, (64, 128, e),
                                          final_activation=True)
            for i in range(c.num_fusion_layers):
                setattr(self, f"fusion{i}_attn",
                        TorchMHA(e, c.num_heads, dropout))
                setattr(self, f"fusion{i}_linear1", nn.Linear(e, c.ffn_dims))
                setattr(self, f"fusion{i}_linear2", nn.Linear(c.ffn_dims, e))
                setattr(self, f"fusion{i}_norm2", nn.LayerNorm(e, eps=LN_EPS))
                setattr(self, f"fusion{i}_norm3", nn.LayerNorm(e, eps=LN_EPS))
                setattr(self, f"final_cls{i}",
                        MLP(e, (e, e, c.num_classes), layer_norm=True))
                setattr(self, f"final_reg{i}", MLP(e, (e, e, c.code_size)))

    def _range(self, device):
        return (const(self.cfg.pc_range[:3], device),
                const(self.cfg.pc_range[3:], device))

    def forward(self, mlvl_feats, lidar2img, img_hw, radar_tokens=None,
                stop_camera_grad: bool = False):
        """Args:
          mlvl_feats: list of [B, N, H_l, W_l, E] FPN levels (float32).
          lidar2img: [B, N, 4, 4].
          img_hw: (H, W) of the padded input image.
          radar_tokens: [B, T, 36] featurized radar (required with fusion).
          stop_camera_grad: build no camera backward (fusion-only
            training); the fusion stage's gradients are unchanged.
        Returns:
          dict(all_cls_scores [L, B, Q, num_classes],
               all_bbox_preds [L, B, Q, code_size]).
        """
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not stop_camera_grad):
            out = self.decode(mlvl_feats, lidar2img, img_hw)
        if not self.cfg.with_radar_fusion:
            return {"all_cls_scores": torch.stack(out[0]),
                    "all_bbox_preds": torch.stack(out[1])}
        _, cam_coord, query, ref = out
        return self.fuse(query, ref, cam_coord[-1], radar_tokens)

    def decode(self, mlvl_feats, lidar2img, img_hw):
        """The DETR3D camera decoder: per-layer class scores and
        denormalized box codes, the last query features and the final
        (detached) reference points in [0, 1]."""
        c = self.cfg
        e = c.embed_dims
        b = mlvl_feats[0].shape[0]
        lo, hi = self._range(mlvl_feats[0].device)
        query_pos = self.query_embedding[:, :e].expand(b, -1, -1)
        query = self.query_embedding[:, e:].expand(b, -1, -1)
        ref = torch.sigmoid(self.reference_points(query_pos))

        cam_cls, cam_coord = [], []
        for lid in range(c.num_decoder_layers):
            query = getattr(self, f"decoder_layer{lid}")(
                query, query_pos, ref, mlvl_feats, lidar2img, img_hw)
            tmp = getattr(self, f"reg_branch{lid}")(query)
            ref_logit = inverse_sigmoid(ref)
            xy = torch.sigmoid(tmp[..., 0:2] + ref_logit[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + ref_logit[..., 2:3])
            cam_coord.append(torch.cat([
                xy * (hi[:2] - lo[:2]) + lo[:2],
                tmp[..., 2:4],
                z * (hi[2] - lo[2]) + lo[2],
                tmp[..., 5:],
            ], dim=-1))
            cam_cls.append(getattr(self, f"cls_branch{lid}")(query))
            # iterative refinement, detached (detr3d_transformer.py:195-203)
            ref = torch.cat([xy, z], dim=-1).detach()
        return cam_cls, cam_coord, query, ref

    def fuse(self, query, ref01, cam_coord_last, radar_tokens):
        """TransCAR fusion stage (detr3d_head.py:538-729).

        query: [B, Q, E] final decoder features; ref01: [B, Q, 3]
        post-decoder reference points in [0, 1]; cam_coord_last: [B, Q, 10]
        last camera layer's denormalized coords (drive the first masks);
        radar_tokens: [B, T, 36].
        """
        c = self.cfg
        lo, hi = self._range(query.device)
        radar_xy = radar_tokens[..., :2].float()
        radar_emb = (self.radar_pos_encoder(radar_tokens[..., :3])
                     + self.radar_feat_encoder(radar_tokens))
        ref_m = ref01 * (hi - lo) + lo
        centers_xy = ref_m[..., 0:2]
        base_z = ref01[..., 2:3] if c.strict_reference_compat else ref_m[..., 2:3]
        tmp_prev = cam_coord_last

        out_cls, out_coord = [], []
        for i in range(c.num_fusion_layers):
            keep = fusion_keep_mask(centers_xy, tmp_prev, radar_xy,
                                    c.fusion_radius_clamps[i])
            attn = getattr(self, f"fusion{i}_attn")(
                query, radar_emb, radar_emb, mask=~keep,
                use_pallas=c.use_pallas_attention)
            gate = keep.any(dim=-1, keepdim=True).to(query.dtype)
            query = getattr(self, f"fusion{i}_norm2")(
                query + self._dropout(attn) * gate)
            linear1 = getattr(self, f"fusion{i}_linear1")
            ffn = getattr(self, f"fusion{i}_linear2")(hidden_dropout(
                F.relu(linear1(query)), self.dropout, self.training,
                linear1))
            query = getattr(self, f"fusion{i}_norm3")(
                query + self._dropout(ffn))

            cls = getattr(self, f"final_cls{i}")(query)
            reg = getattr(self, f"final_reg{i}")(query)
            coord = torch.cat([
                reg[..., 0:2] + centers_xy,
                reg[..., 2:4],
                reg[..., 4:5] + base_z,
                reg[..., 5:],
            ], dim=-1)
            out_cls.append(cls)
            out_coord.append(coord)
            centers_xy = coord[..., 0:2]          # next layer's reference
            base_z = coord[..., 4:5]
            tmp_prev = coord
        return {"all_cls_scores": torch.stack(out_cls),
                "all_bbox_preds": torch.stack(out_coord)}

    def _dropout(self, x):
        return F.dropout(x, self.dropout, self.training)


def fusion_keep_mask(centers_xy, box_coord, radar_xy, clamp):
    """Three-circle visibility mask (detr3d_head.py:549-571).

    centers_xy: [B, Q, 2] metric; box_coord: [B, Q, 10] denormalized box
    code giving (length, heading); radar_xy: [B, T, 2].
    Returns bool [B, Q, T], True = radar token visible to the query.
    """
    length = box_coord[..., 3].exp()
    # the reference negates both sin and cos and applies sin→x, cos→y
    s = -box_coord[..., 6]
    co = -box_coord[..., 7]
    offset = 0.25 * length
    shift = torch.stack([offset * s, offset * co], dim=-1)
    radii = (length * 0.5).clamp(clamp[0], clamp[1])[..., None]

    def dist(a):
        d2 = ((a[:, :, None, :] - radar_xy[:, None, :, :]) ** 2).sum(-1)
        return d2.clamp(min=0.0).sqrt()

    return ((dist(centers_xy) < radii) | (dist(centers_xy + shift) < radii)
            | (dist(centers_xy - shift) < radii))
