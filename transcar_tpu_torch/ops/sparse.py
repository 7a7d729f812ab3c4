"""Sparse 3D convolution on static buffers (``transcar_tpu/ops/sparse.py``).

The reference's voxel ObjDGCNN runs spconv's submanifold and strided
sparse convolutions (configs/obj_dgcnn/voxel.py:34-43).  As in the JAX
package, the active sites of a batch live in fixed buffers (features
[B, V, C], (z, y, x) coords [B, V, 3], a count per sample: the output of
``ops/voxelize.hard_voxelize``), and neighbours are found through a dense
lookup table of the grid, so every shape is static and the forward never
waits for the host.  Written out over the batch where JAX maps one sample
at a time:

  * the batch folds into the keys: a site's key is ``b·G + lin`` (G the
    grid's cell count, lin its linear id, z slowest), and one table of
    ``B·G + 1`` int32 entries maps a key to the site's row in the
    flattened [B·V] buffers; empty cells and the last slot, which takes
    every miss, hold B·V, the index of a zero row;
  * a site set (:class:`Sites`) builds its table, and the rows of its
    sites' 27 neighbours (the submanifold rule book), once, and every
    conv on that set shares them: the subm convs of a stage and the
    gather of the downsample that ends it;
  * a conv gathers the 27 neighbour rows of every output site with one
    ``index_select`` ([V', 27·Cin]) and contracts them with the weight in
    one ``mm`` ([27·Cin, Cout]): two launches where JAX runs 27 gathers
    and 27 dots (the sum runs in another order, within float32
    rounding);
  * the strided conv's output sites are every o with o·2 + t = i for an
    active i and t ∈ [-1, 1]³ (per dimension floor((i ± 1) / 2) by
    parity), deduplicated on a mark grid and compacted by a cumulative
    sum in ascending linear id: output slot j holds the (j+1)-th marked
    cell, found by ``searchsorted`` on the sum.  The first ``out_max``
    are kept, as in JAX; the output set also holds how many the cap
    dropped (``Sites.dropped``);
  * a conv's backward is gathers too (:class:`GatherConv`), as the JAX
    package's transposed gathers are: d_feats gathers d_out by the
    inverse rule book, the output row that reads each input site at each
    tap (a submanifold conv's is its own rule book mirrored, tap 26 − k:
    the neighbours of one site set are symmetric; a strided conv's comes
    from the output set's table), and contracts it with the transposed
    weights; d_W = tapsᵀ · d_out.  No ``index_add_`` adds float rows in
    the order its threads arrive, so the step repeats bit for bit.

Outputs are masked to their valid rows, and unused output coords are 0.
No function here reads a value back to the host (no ``nonzero``,
``unique``, boolean-mask indexing or ``.item()``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

MISS = 2 ** 30   # linear id of an invalid or out-of-grid site

Grid = Tuple[int, int, int]


def _cells(grid: Grid) -> int:
    return grid[0] * grid[1] * grid[2]


def _linearize(coords: torch.Tensor, grid: Grid,
               valid: torch.Tensor) -> torch.Tensor:
    """(z, y, x) int coords [..., 3] → linear ids (int64); invalid or
    outside the grid → MISS."""
    gz, gy, gx = grid
    z, y, x = coords.long().unbind(-1)
    inside = ((z >= 0) & (z < gz) & (y >= 0) & (y < gy)
              & (x >= 0) & (x < gx))
    return torch.where(valid & inside, (z * gy + y) * gx + x, MISS)


def _kernel_offsets(device, k: int = 3) -> torch.Tensor:
    """[k³, 3] int64 (dz, dy, dx), dz slowest: the order of a
    [27, Cin, Cout] weight's first axis (made on the device, no host
    copy)."""
    r = torch.arange(k, device=device) - k // 2
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


def _keys(coords: torch.Tensor, grid: Grid,
          valid: torch.Tensor) -> torch.Tensor:
    """Batch-folded keys b·G + lin of coords [B, ..., 3] (int64); a miss
    → B·G, the table's last slot."""
    b, g = coords.shape[0], _cells(grid)
    lin = _linearize(coords, grid, valid)
    batch = torch.arange(b, device=coords.device).view(
        b, *([1] * (lin.ndim - 1)))
    return torch.where(lin == MISS, b * g, lin + batch * g)


def valid_rows(count: torch.Tensor, v: int) -> torch.Tensor:
    """[B, V] bool: row r of sample b holds a site (r < count[b])."""
    return torch.arange(v, device=count.device)[None, :] < count[:, None]


class Sites:
    """The site set of a batch on a grid: coords [B, V, 3] int32 (z, y,
    x) and count [B]; for the output of a downsample, ``dropped`` [B]
    int32, the sites its cap left out.  Its lookup table and rule book
    are built on first use and then shared by every conv on the set."""

    def __init__(self, coords: torch.Tensor, count: torch.Tensor,
                 grid: Grid, dropped: Optional[torch.Tensor] = None):
        self.coords, self.count, self.grid = coords, count, tuple(grid)
        self.dropped = dropped
        self.valid = valid_rows(count, coords.shape[1])
        self._table: Optional[torch.Tensor] = None
        self._rules: Optional[torch.Tensor] = None

    @property
    def table(self) -> torch.Tensor:
        """Dense [B·G + 1] int32 lookup: key b·G + lin → row b·V + r of
        the flattened buffers; B·V (the zero row) for an empty cell and
        in the last slot."""
        if self._table is None:
            b, v = self.coords.shape[:2]
            keys = _keys(self.coords, self.grid, self.valid)
            rows = torch.arange(b * v, device=keys.device,
                                dtype=torch.int32).view(b, v)
            # every write to the last slot (invalid rows) writes B·V; the
            # writes meet by a min (a cell's one row beats the B·V fill),
            # which needs no order, where a deterministic-mode index_put_
            # would walk the last slot's repeats one by one
            dump = b * _cells(self.grid)
            table = torch.full((dump + 1,), b * v, dtype=torch.int32,
                               device=keys.device)
            rows = torch.where(keys < dump, rows, b * v)
            table.scatter_reduce_(0, keys.reshape(-1), rows.reshape(-1),
                                  reduce="amin")
            self._table = table
        return self._table

    def lookup(self, coords: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
        """Rows (int32) of the sites at coords [B, V', 27, 3] of this
        grid, B·V where there is none or ``valid`` [B, V', 1] is False →
        [B·V', 27]."""
        keys = _keys(coords, self.grid, valid)
        return self.table.index_select(0, keys.reshape(-1)).view(-1, 27)

    @property
    def subm_rules(self) -> torch.Tensor:
        """[B·V, 27] rows of each site's neighbours at the kernel
        offsets (B·V for a miss and for every neighbour of an invalid
        row)."""
        if self._rules is None:
            offs = _kernel_offsets(self.coords.device)
            self._rules = self.lookup(self.coords[:, :, None, :] + offs,
                                      self.valid[..., None])
        return self._rules

    def subm_inverse(self) -> torch.Tensor:
        """The submanifold rule book's inverse: the site whose tap k reads
        site r is r's neighbour at −offset_k, tap 26 − k of r's rules."""
        return self.subm_rules.flip(-1)


def down_sites(sites: Sites, out_max: int):
    """Output site set of SparseConv3d(k3, s2, p1) on ``sites``: every o
    with o·2 + t = i for an active i and t ∈ [-1, 1]³, in ascending
    linear id on the halved grid, the first ``out_max`` kept.

    Returns a :class:`Sites` of [B, out_max] rows: unused coords 0, count
    min(#marked, out_max), dropped max(#marked − out_max, 0)."""
    coords, valid = sites.coords, sites.valid
    b, v = coords.shape[:2]
    dev = coords.device
    out_grid = tuple((g + 1) // 2 for g in sites.grid)
    g_out = _cells(out_grid)

    # per dimension o with 2o + t = i, t ∈ [-1, 1], i − t even: i even →
    # {i/2}; i odd → {(i−1)/2, (i+1)/2}; the 8 combinations per site
    parity = coords & 1
    half = torch.stack([(coords - parity) // 2, (coords + parity) // 2],
                       -1)                                   # [B, V, 3, 2]
    shape = (b, v, 2, 2, 2)
    cand = torch.stack([half[:, :, 0].view(b, v, 2, 1, 1).expand(shape),
                        half[:, :, 1].view(b, v, 1, 2, 1).expand(shape),
                        half[:, :, 2].view(b, v, 1, 1, 2).expand(shape)],
                       -1).reshape(b, v * 8, 3)
    keys = _keys(cand, out_grid,
                 valid[:, :, None].expand(b, v, 8).reshape(b, -1))

    # dedup on a mark grid (every write is True; the last slot takes the
    # misses and is left out), compaction by a cumulative sum
    mark = torch.zeros(b * g_out + 1, dtype=torch.bool, device=dev)
    mark.index_fill_(0, keys.reshape(-1), True)
    csum = torch.cumsum(mark[:-1].view(b, g_out), 1, dtype=torch.int32)
    marked = csum[:, -1]
    count = marked.clamp(max=out_max)
    dropped = (marked - out_max).clamp(min=0)

    # slot j holds the first cell whose sum reaches j + 1 (g_out: none)
    want = torch.arange(1, out_max + 1, dtype=torch.int32,
                        device=dev).expand(b, out_max).contiguous()
    lin = torch.searchsorted(csum, want)                    # [B, out_max]
    gz, gy, gx = out_grid
    out_coords = torch.stack([lin // (gy * gx), (lin // gx) % gy, lin % gx],
                             -1)
    out_coords = torch.where((lin < g_out)[..., None], out_coords,
                             0).to(torch.int32)
    return Sites(out_coords, count, out_grid, dropped)


def down_rules(sites: Sites, out: Sites) -> torch.Tensor:
    """[B·out_max, 27] rows of ``sites`` that each output site of the
    strided conv reads (input i = 2o + t at the kernel offsets)."""
    offs = _kernel_offsets(out.coords.device)
    src = out.coords.long()[:, :, None, :] * 2 + offs
    return sites.lookup(src, out.valid[..., None])


def up_rules(sites: Sites, out: Sites) -> torch.Tensor:
    """The strided conv's inverse rule book: [B·V, 27] rows of ``out``
    (the downsampled set) whose tap k reads each site of ``sites``, the o
    with o·2 + t_k = i; B·V' (the zero row) where i − t_k is odd, o is off
    the halved grid or the cap left it out, and for an invalid row."""
    offs = _kernel_offsets(sites.coords.device)
    src = sites.coords.long()[:, :, None, :] - offs              # 2·o
    even = (src % 2 == 0).all(-1)
    return out.lookup(torch.div(src, 2, rounding_mode="floor"),
                      sites.valid[..., None] & even)


def _taps(feats: torch.Tensor, rules: torch.Tensor) -> torch.Tensor:
    """[B·V', 27·C]: the 27 rows of feats [B, V, C] that ``rules``
    [B·V', 27] names (a miss, row B·V, reads zeros)."""
    b, v, c = feats.shape
    rows = torch.cat([feats.reshape(b * v, c), feats.new_zeros(1, c)])
    return rows.index_select(0, rules.reshape(-1)).view(-1, 27 * c)


class GatherConv(torch.autograd.Function):
    """Σ_k feats[rules[:, k]] · W_k, masked to the valid output rows, with
    its backward as gathers: d_feats = Σ_k d_out[inverse[:, k]] · W_kᵀ,
    d_W = tapsᵀ · d_out.  ``inverse`` is a function giving the inverse rule
    book [B·V, 27] (rows of the output; B·V' for none), called only in the
    backward."""

    @staticmethod
    def forward(ctx, feats, weight, rules, valid, inverse):
        b, v, cin = feats.shape
        taps = _taps(feats, rules)
        out = torch.mm(taps, weight.reshape(27 * cin, -1).to(taps.dtype))
        out = out.view(b, valid.shape[1], -1) * valid[..., None].to(out.dtype)
        ctx.save_for_backward(taps, weight, valid)
        ctx.inverse = inverse
        ctx.feats_shape = feats.shape
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        taps, weight, valid = ctx.saved_tensors
        b, v, cin = ctx.feats_shape
        d_out = d_out * valid[..., None].to(d_out.dtype)
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            wt = weight.to(d_out.dtype).transpose(1, 2)           # [27, Cout, Cin]
            d_feats = torch.mm(_taps(d_out, ctx.inverse()),
                               wt.reshape(-1, cin)).view(b, v, cin)
        if ctx.needs_input_grad[1]:
            d_w = torch.mm(taps.t(), d_out.reshape(taps.shape[0], -1))
            d_w = d_w.view(weight.shape).to(weight.dtype)
        return d_feats, d_w, None, None, None


def gather_conv(feats: torch.Tensor, rules: torch.Tensor,
                weight: torch.Tensor, valid: torch.Tensor,
                inverse) -> torch.Tensor:
    """Σ_k feats[rules[:, k]] · W_k: feats [B, V, Cin] (a miss, row B·V,
    reads zeros), rules [B·V', 27], weight [27, Cin, Cout], valid
    [B, V'] → [B, V', Cout] masked to the valid rows; ``inverse`` gives
    the inverse rule book for the backward (:class:`GatherConv`:
    ``sites.subm_inverse`` or ``lambda: up_rules(sites, out)``)."""
    return GatherConv.apply(feats, weight, rules, valid, inverse)


def subm_conv(feats: torch.Tensor, coords: torch.Tensor,
              count: torch.Tensor, weight: torch.Tensor,
              grid: Grid) -> torch.Tensor:
    """Submanifold 3×3×3 conv: [B, V, Cin] → [B, V, Cout] on the same
    sites; weight [27, Cin, Cout]."""
    sites = Sites(coords, count, grid)
    return gather_conv(feats, sites.subm_rules, weight, sites.valid,
                       sites.subm_inverse)


def sparse_conv_down(feats: torch.Tensor, coords: torch.Tensor,
                     count: torch.Tensor, weight: torch.Tensor, grid: Grid,
                     out_max: int):
    """SparseConv3d k=3, stride 2, pad 1 onto the halved grid.

    Returns (out_feats [B, out_max, Cout], out_coords [B, out_max, 3]
    int32, out_count [B] int32, dropped [B] int32)."""
    sites = Sites(coords, count, grid)
    out = down_sites(sites, out_max)
    feats = gather_conv(feats, down_rules(sites, out), weight, out.valid,
                        lambda: up_rules(sites, out))
    return feats, out.coords, out.count, out.dropped
