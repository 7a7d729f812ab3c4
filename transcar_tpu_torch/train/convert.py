"""Weight bridge: the JAX package's flax parameter tree → this package's
``state_dict``.

The port's submodules are named after the flax tree
(``backbone.layer3_0.conv2.conv_offset``, ``head.fusion0_attn.wq``, ...),
so the bridge is a generic walk with two layout rules and four leaf
renames:

  * a 4-D leaf (conv ``kernel``, DCN ``weight``) [kh, kw, I, O] →
    [O, I, kh, kw];
  * a 2-D ``kernel`` (Dense) [I, O] → ``weight`` [O, I];
  * ``kernel`` and ``scale`` (LayerNorm, FrozenBN) → ``weight``; FrozenBN
    ``mean`` / ``var`` → ``running_mean`` / ``running_var``;
  * everything else passes unchanged (biases, ``query_embedding``, and
    the attention ``wq … bo``, which keep the JAX [in, out] layout).

Flax variables with BatchNorm statistics (``{"params", "batch_stats"}``,
the ObjDGCNN track's trainable BN and MaskedBN keep ``scale``/``bias`` in
``params`` and ``mean``/``var`` in ``batch_stats``) are merged by path
first, so the same renames give ``weight``, ``bias``, ``running_mean``
and ``running_var``.

Published reference ``.pth`` checkpoints (mmdet3d ``Detr3D``
state_dicts) reach the port through :func:`convert_detr3d_checkpoint`,
the port's copy of ``transcar_tpu/train/convert.py`` (reference keys →
the flax tree, numpy), and then :func:`from_jax_params`.  Its layout
rules:

  conv        [O, I, kh, kw] → [kh, kw, I, O]
  linear      [O, I]         → [I, O]
  batchnorm   weight/bias/running_mean/running_var → FrozenBN
                              scale/bias/mean/var
  MHA         in_proj_weight [3E, E] split into wq/wk/wv (transposed),
              out_proj → wo/bo
  Sequential MLPs: torch integer indices → MLP linear{i}/ln{i} slots

Unknown reference keys (the dead ``attention_weights2/3``,
``output_proj2/3``, ``rf_norm1*`` params — detr3d_head.py:135,150,165,
191-195 — plus buffers like ``code_weights``) are skipped and reported.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _merge(a: Mapping, b: Mapping) -> dict:
    """Two trees merged by path (the leaves' paths must not collide)."""
    out = dict(a)
    for key, val in b.items():
        if key in out and isinstance(val, Mapping):
            out[key] = _merge(out[key], val)
        elif key in out:
            raise ValueError(f"leaf {key!r} is in both trees")
        else:
            out[key] = val
    return out


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested mappings of arrays, with or without the
    top-level ``"params"``, or flax variables ``{"params",
    "batch_stats"}``) → ``state_dict`` for ``load_state_dict``: float32,
    or float64 where a leaf is float64."""
    if set(params) == {"params", "batch_stats"}:
        params = _merge(params["params"], params["batch_stats"])
    elif set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + key + ".")
                continue
            arr = np.asarray(val)
            arr = arr.astype(np.promote_types(arr.dtype, np.float32))
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2 and key == "kernel":
                arr = arr.T
            out[prefix + _RENAME.get(key, key)] = torch.tensor(arr)

    walk(params, "")
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (a checkpoint dict or a bare state_dict) →
    numpy arrays by key, any ``module.`` prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "numpy"):
            out[k] = v.detach().cpu().numpy()
    return out


def _conv(w):
    # None propagates (missing key → _Tree.put skips + reports)
    return None if w is None else np.transpose(w, (2, 3, 1, 0))


def _lin(w):
    return None if w is None else np.transpose(w, (1, 0))


class _Tree:
    """Nested-dict builder with used-key tracking."""

    def __init__(self, sd):
        self.sd = sd
        self.params: Dict = {}
        self.used = set()
        self.missing: List[str] = []

    def get(self, key):
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        return self.sd[key]

    def put(self, path: Tuple[str, ...], value):
        if value is None:
            return
        node = self.params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value, np.float32)

    # composite helpers -----------------------------------------------------
    def conv(self, tkey, path, bias=False):
        self.put(path + ("kernel",), _conv(self.get(tkey + ".weight")))
        if bias:
            self.put(path + ("bias",), self.get(tkey + ".bias"))

    def bn(self, tkey, path):
        self.put(path + ("scale",), self.get(tkey + ".weight"))
        self.put(path + ("bias",), self.get(tkey + ".bias"))
        self.put(path + ("mean",), self.get(tkey + ".running_mean"))
        self.put(path + ("var",), self.get(tkey + ".running_var"))

    def convbn(self, tconv, tbn, path, bias=False):
        self.conv(tconv, path + ("conv",), bias=bias)
        self.bn(tbn, path + ("bn",))

    def linear(self, tkey, path):
        self.put(path + ("kernel",), _lin(self.get(tkey + ".weight")))
        self.put(path + ("bias",), self.get(tkey + ".bias"))

    def layernorm(self, tkey, path):
        self.put(path + ("scale",), self.get(tkey + ".weight"))
        self.put(path + ("bias",), self.get(tkey + ".bias"))

    def mha(self, tkey, path):
        w = self.get(tkey + ".in_proj_weight")
        b = self.get(tkey + ".in_proj_bias")
        if w is None:
            return
        e = w.shape[1]
        for i, n in enumerate("qkv"):
            self.put(path + (f"w{n}",), _lin(w[i * e:(i + 1) * e]))
            self.put(path + (f"b{n}",), b[i * e:(i + 1) * e])
        self.linear(tkey + ".out_proj", path)
        # rename the out_proj slots laid down by linear()
        node = self.params
        for p in path[:-1]:
            node = node[p]
        leaf = node[path[-1]]
        leaf["wo"] = leaf.pop("kernel")
        leaf["bo"] = leaf.pop("bias")

    def mlp(self, tkey, path, torch_idx, ln_idx=()):
        """Sequential → MLP: torch_idx are Linear slots, ln_idx LayerNorms."""
        for i, t in enumerate(torch_idx):
            self.linear(f"{tkey}.{t}", path + (f"linear{i}",))
        for i, t in enumerate(ln_idx):
            self.layernorm(f"{tkey}.{t}", path + (f"ln{i}",))


def convert_detr3d_checkpoint(sd: Dict[str, np.ndarray],
                              num_decoder_layers: int = 6,
                              num_fusion_layers: int = 3,
                              resnet_blocks=(3, 4, 23, 3),
                              with_dcn=(False, False, True, True),
                              backbone: str = "resnet101",
                              with_radar_fusion: bool = True):
    """Convert a reference state_dict → (flax params dict, report dict)."""
    t = _Tree(sd)

    if backbone.startswith("resnet"):
        from transcar_tpu_torch.models.resnet import RESNET_DEPTHS
        depth = int(backbone[len("resnet"):])
        _convert_resnet(t, RESNET_DEPTHS.get(depth, resnet_blocks),
                        with_dcn)
    elif backbone == "vovnet99":
        _convert_vovnet(t)

    _convert_fpn(t, sd)
    _convert_head(t, num_decoder_layers, with_radar_fusion,
                  num_fusion_layers)

    unused = sorted(k for k in sd if k not in t.used)
    report = {"missing": t.missing, "unused": unused}
    return t.params, report


def _convert_resnet(t: _Tree, blocks, with_dcn):
    p = "img_backbone"
    t.convbn(f"{p}.conv1", f"{p}.bn1", ("backbone", "stem"))
    for s, nb in enumerate(blocks):
        for b in range(nb):
            tp = f"{p}.layer{s + 1}.{b}"
            fp = ("backbone", f"layer{s + 1}_{b}")
            t.convbn(f"{tp}.conv1", f"{tp}.bn1", fp + ("conv1",))
            if with_dcn[s]:
                t.put(fp + ("conv2", "weight"),
                      _conv(t.get(f"{tp}.conv2.weight")))
                t.conv(f"{tp}.conv2.conv_offset",
                       fp + ("conv2", "conv_offset"), bias=True)
                t.bn(f"{tp}.bn2", fp + ("bn2",))
            else:
                t.convbn(f"{tp}.conv2", f"{tp}.bn2", fp + ("conv2",))
            t.convbn(f"{tp}.conv3", f"{tp}.bn3", fp + ("conv3",))
            if b == 0:
                t.convbn(f"{tp}.downsample.0", f"{tp}.downsample.1",
                         fp + ("downsample",))


def _convert_vovnet(t: _Tree):
    from transcar_tpu_torch.models.vovnet import V99_SPEC

    p = "img_backbone"
    for i in (1, 2, 3):
        t.convbn(f"{p}.stem.stem_{i}/conv", f"{p}.stem.stem_{i}/norm",
                 ("backbone", f"stem{i}"))
    for si in range(4):
        stage = si + 2
        for b in range(V99_SPEC["block_per_stage"][si]):
            mod = f"{p}.stage{stage}.OSA{stage}_{b + 1}"
            fp = ("backbone", f"stage{stage}_block{b}")
            for l in range(V99_SPEC["layer_per_block"]):
                t.convbn(f"{mod}.layers.{l}.OSA{stage}_{b + 1}_{l}/conv",
                         f"{mod}.layers.{l}.OSA{stage}_{b + 1}_{l}/norm",
                         fp + (f"conv{l}",))
            t.convbn(f"{mod}.concat.OSA{stage}_{b + 1}_concat/conv",
                     f"{mod}.concat.OSA{stage}_{b + 1}_concat/norm",
                     fp + ("concat",))
            t.conv(f"{mod}.ese.fc", fp + ("ese", "fc"), bias=True)


def _convert_fpn(t: _Tree, sd):
    p = "img_neck"
    n_lat = len([k for k in sd
                 if k.startswith(f"{p}.lateral_convs") and "weight" in k])
    n_fpn = len([k for k in sd
                 if k.startswith(f"{p}.fpn_convs") and "weight" in k])
    # flax lateral names carry the absolute input index (start_level offset)
    n_used = n_lat
    start = None
    # infer start level from the first lateral's input channels vs known sets
    for i in range(n_lat):
        t.conv(f"{p}.lateral_convs.{i}.conv", ("neck", f"lateral{i}"),
               bias=True)
    for i in range(n_fpn):
        if i < n_used:
            t.conv(f"{p}.fpn_convs.{i}.conv", ("neck", f"fpn{i}"), bias=True)
        else:
            t.conv(f"{p}.fpn_convs.{i}.conv", ("neck", f"extra{i - n_used}"),
                   bias=True)
    return start


def _convert_head(t: _Tree, num_layers, with_radar_fusion, num_fusion):
    h = "pts_bbox_head"
    t.put(("head", "query_embedding"), t.get(f"{h}.query_embedding.weight"))
    t.linear(f"{h}.transformer.reference_points",
             ("head", "reference_points"))
    for l in range(num_layers):
        dl = f"{h}.transformer.decoder.layers.{l}"
        fp = ("head", f"decoder_layer{l}")
        t.mha(f"{dl}.attentions.0.attn", fp + ("self_attn",))
        ca = f"{dl}.attentions.1"
        t.linear(f"{ca}.attention_weights",
                 fp + ("cross_attn", "attention_weights"))
        t.linear(f"{ca}.output_proj", fp + ("cross_attn", "output_proj"))
        t.mlp(f"{ca}.position_encoder",
              fp + ("cross_attn", "position_encoder"),
              torch_idx=(0, 3), ln_idx=(1, 4))
        t.linear(f"{dl}.ffns.0.layers.0.0", fp + ("ffn", "linear1"))
        t.linear(f"{dl}.ffns.0.layers.1", fp + ("ffn", "linear2"))
        for ni in range(3):
            t.layernorm(f"{dl}.norms.{ni}", fp + (f"norm{ni + 1}",))
        t.mlp(f"{h}.cls_branches.{l}", ("head", f"cls_branch{l}"),
              torch_idx=(0, 3, 6), ln_idx=(1, 4))
        t.mlp(f"{h}.reg_branches.{l}", ("head", f"reg_branch{l}"),
              torch_idx=(0, 2, 4))

    if not with_radar_fusion:
        return
    t.mlp(f"{h}.radar_position_encoder", ("head", "radar_pos_encoder"),
          torch_idx=(0, 3), ln_idx=(1, 4))
    t.mlp(f"{h}.radar_feat_encoder", ("head", "radar_feat_encoder"),
          torch_idx=(0, 2, 4))
    for i in range(num_fusion):
        sfx = "" if i == 0 else ("2", "3")[i - 1]
        usfx = "" if i == 0 else ("_2", "_3")[i - 1]
        t.mha(f"{h}.rf_multihead_attn{sfx}", ("head", f"fusion{i}_attn"))
        t.linear(f"{h}.rf_linear1{usfx}", ("head", f"fusion{i}_linear1"))
        t.linear(f"{h}.rf_linear2{usfx}", ("head", f"fusion{i}_linear2"))
        t.layernorm(f"{h}.rf_norm2{usfx}", ("head", f"fusion{i}_norm2"))
        t.layernorm(f"{h}.rf_norm3{usfx}", ("head", f"fusion{i}_norm3"))
        t.mlp(f"{h}.final_cls{sfx}", ("head", f"final_cls{i}"),
              torch_idx=(0, 3, 6), ln_idx=(1, 4))
        t.mlp(f"{h}.final_reg{sfx}", ("head", f"final_reg{i}"),
              torch_idx=(0, 2, 4))
