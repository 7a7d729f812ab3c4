"""Sparse middle encoder of the voxel ObjDGCNN
(``transcar_tpu/models/sparse_encoder.py``).

Parity target: mmdet3d ``SparseEncoder`` as configured by
configs/obj_dgcnn/voxel.py:34-43: 5 input channels, sparse shape
(41, 1024, 1024) (z, y, x), encoder channels ((16, 16, 32), (32, 32, 64),
(64, 64, 128), (128, 128)), a 256-channel BEV for SECOND.  As in the JAX
package:

  * each block is a 3×3×3 conv (submanifold, or stride 2 where a stage
    ends, but the last), a BatchNorm whose batch statistics run over the
    batch's active sites only (``common.BatchNorm`` with a mask, eps
    1e-3) and a ReLU masked to the active sites;
  * the last stage's sites are scattered into a dense [Z', H', W'] grid
    and z folds into the channels (channel z·C + c), then a 1×1
    (``out_conv``, a Linear) and a BatchNorm (``out_bn``) give the BEV.

Two formulations with one parameter tree, behind ``impl``:

  * ``"gather"`` (the preset's): the static-buffer sparse ops of
    ``ops/sparse.py`` in float32, the whole batch at once; each stage's
    site set builds its lookup table and rule book once.  A downsample
    keeps at most V sites (V = the input's buffer rows);
  * ``"dense"``: the sites scattered once into the dense grid [B, Z, Y,
    X, C], then every block a masked ``F.conv3d`` (padding 1, stride 1
    or 2) in ``compute_dtype`` (cuDNN, where JAX runs three z-shifted 2D
    convs, a TPU workaround); a downsample's site set is the stride-2
    max pool of the mask, with no cap, spconv's semantics.

A forward keeps, in ``downsample_sites``, the sites each stride-2 conv
marks and keeps, as device tensors (the model's own count of what a cap
drops, read by ``cli/benchmark``'s audit).

Parameter names follow the flax tree (``conv_input.weight`` [27, Cin,
Cout] in ``ops/sparse`` offset order, ``conv_input.bn.*``,
``stage{s}_conv{c}.*``, ``out_conv``, ``out_bn``), so
``train/convert.from_jax_params`` carries them unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transcar_tpu_torch.models.common import BatchNorm
from transcar_tpu_torch.ops import sparse
from transcar_tpu_torch.ops.sparse import Sites


#: Channels of each stage's convs (configs/obj_dgcnn/voxel.py:34-43); a
#: stride-2 conv ends every stage but the last.
ENCODER_CHANNELS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))


class SparseConvBlock(nn.Module):
    """Submanifold or strided sparse conv on the static site buffers +
    masked BatchNorm over the batch's active sites + ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.weight = nn.Parameter(torch.empty(27, in_channels,
                                               out_channels))
        self.bn = BatchNorm(out_channels, eps=1e-3, channel_dim=-1)

    def _bn_relu(self, x, mask):
        x = self.bn(x, mask)
        return F.relu(x) * mask[..., None].to(x.dtype)

    def forward(self, feats: torch.Tensor, sites: Sites,
                out_max: int = 0):
        """feats [B, V, Cin] on ``sites`` → ([B, V', Cout], the output's
        site set: ``sites`` itself, or the downsampled set of out_max
        rows)."""
        if self.downsample:
            out = sparse.down_sites(sites, out_max)
            feats = sparse.gather_conv(
                feats, sparse.down_rules(sites, out), self.weight, out.valid,
                lambda src=sites, dst=out: sparse.up_rules(src, dst))
            sites = out
        else:
            feats = sparse.gather_conv(feats, sites.subm_rules, self.weight,
                                       sites.valid, sites.subm_inverse)
        return self._bn_relu(feats, sites.valid), sites


class DenseSparseConvBlock(SparseConvBlock):
    """The same block on the dense grid: inactive cells hold zeros (the
    gather path's zero-row misses), the output is masked back to the
    active set and the BatchNorm's statistics run over active cells only.
    The conv computes in ``compute_dtype`` (None: the input's), and its
    output stays in it; the BatchNorm computes in float32."""

    def __init__(self, in_channels: int, out_channels: int,
                 downsample: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__(in_channels, out_channels, downsample)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        """x [B, Z, Y, X, Cin]; mask [B, Z, Y, X] bool → the same at the
        block's output."""
        dt = getattr(torch, self.compute_dtype) if self.compute_dtype \
            else x.dtype
        cin, cout = self.weight.shape[1:]
        # [27, Cin, Cout], dz slowest → [Cout, Cin, 3, 3, 3] (a
        # cross-correlation, as the gather path's taps)
        w = self.weight.to(dt).reshape(3, 3, 3, cin, cout).permute(
            4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        stride = 2 if self.downsample else 1
        x = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), w, stride=stride,
                     padding=1).permute(0, 2, 3, 4, 1)
        if self.downsample:
            mask = F.max_pool3d(mask[:, None].float(), 3, 2, 1)[:, 0] > 0
        x = x * mask[..., None].to(x.dtype)
        return self._bn_relu(x, mask), mask


class SparseEncoder(nn.Module):
    """Batched voxel features → dense BEV maps [B, H', W', bev_channels]
    (float32)."""

    def __init__(self, in_channels: int = 5,
                 sparse_shape: Tuple[int, int, int] = (41, 1024, 1024),
                 encoder_channels: Tuple[Tuple[int, ...], ...] = (
                     ENCODER_CHANNELS),
                 bev_channels: int = 256, impl: str = "gather",
                 compute_dtype: Optional[str] = None):
        """impl: "gather" | "dense"; compute_dtype: the dense impl's conv
        dtype (the gather impl computes in float32)."""
        super().__init__()
        if impl not in ("gather", "dense"):
            raise ValueError(f"unknown sparse impl {impl!r}")
        self.sparse_shape, self.impl = tuple(sparse_shape), impl
        self.compute_dtype = compute_dtype if impl == "dense" else None
        #: per stride-2 conv of the last forward: ([B] sites marked, [B]
        #: sites kept); the dense impl has no cap, so both are its mask's
        self.downsample_sites = []
        kw = {"compute_dtype": compute_dtype} if impl == "dense" else {}
        block = DenseSparseConvBlock if impl == "dense" else SparseConvBlock
        self.names = ["conv_input"]
        self.conv_input = block(in_channels, encoder_channels[0][0], **kw)
        cin = encoder_channels[0][0]
        for si, chans in enumerate(encoder_channels):
            for ci, ch in enumerate(chans):
                down = (ci == len(chans) - 1
                        and si != len(encoder_channels) - 1)
                name = f"stage{si}_conv{ci}"
                setattr(self, name, block(cin, ch, downsample=down, **kw))
                self.names.append(name)
                cin = ch
        grid = self.sparse_shape
        for _ in range(len(encoder_channels) - 1):
            grid = tuple((g + 1) // 2 for g in grid)
        self.out_conv = nn.Linear(grid[0] * cin, bev_channels)
        self.out_bn = BatchNorm(bev_channels, eps=1e-3, channel_dim=-1)

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
        """feats [B, V, C]; coords [B, V, 3] int32 (z, y, x); count [B]."""
        downs = self.downsample_sites = []
        if self.impl == "dense":
            x, mask = self._scatter(feats, coords, count, self.sparse_shape)
            if self.compute_dtype:
                # the first conv casts anyway: the full-grid canvas
                # streams at half the bytes
                x = x.to(getattr(torch, self.compute_dtype))
            for name in self.names:
                block = getattr(self, name)
                x, mask = block(x, mask)
                if block.downsample:
                    n = mask.flatten(1).sum(1)
                    downs.append((n, n))
            dense = x
        else:
            sites = Sites(coords, count, self.sparse_shape)
            for name in self.names:
                block = getattr(self, name)
                feats, sites = block(feats, sites, out_max=feats.shape[1])
                if block.downsample:
                    downs.append((sites.count + sites.dropped, sites.count))
            dense, _ = self._scatter(feats, sites.coords, sites.count,
                                     sites.grid)
        # fold z into the channels: [B, Z', H', W', C] → [B, H', W', Z'·C]
        b, z, h, w, c = dense.shape
        bev = dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, z * c)
        bev = self.out_bn(self.out_conv(bev.to(self.out_conv.weight.dtype)))
        return F.relu(bev)

    @staticmethod
    def _scatter(feats, coords, count, grid):
        """Sites → the dense grid [B, Z, Y, X, C] and its mask; each row
        past count goes to a scratch cell of its own, dropped afterwards
        (every write there is zero; one shared cell would serialize a
        deterministic-mode scatter on its repeats)."""
        b, v, c = feats.shape
        cells = grid[0] * grid[1] * grid[2]
        real = b * cells
        valid = sparse.valid_rows(count, v)
        lin = sparse._linearize(coords, grid, valid)
        dev = lin.device
        lin = torch.where(lin == sparse.MISS,
                          real + torch.arange(b * v, device=dev).view(b, v),
                          lin + torch.arange(b, device=dev)[:, None] * cells)
        canvas = feats.new_zeros(real + b * v, c)
        canvas[lin.reshape(-1)] = torch.where(
            valid[..., None], feats, 0.0).reshape(-1, c)
        mask = torch.zeros(real + b * v, dtype=torch.bool, device=dev)
        mask[lin.reshape(-1)] = valid.reshape(-1)
        return (canvas[:real].view(b, *grid, c),
                mask[:real].view(b, *grid))
