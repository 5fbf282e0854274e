"""The hash-grid table-gradient scatter and the custom-gradient lookups
whose table gradient it is, in their plain versions only: every scatter is
one ``index_add_`` on a zero table, on the CPU and on the card alike (the
program's hand-written kernel has no place in the reference)."""

from __future__ import annotations

import torch


def scatter_levels_plain(rows: torch.Tensor, vals: torch.Tensor, table_size: int) -> torch.Tensor:
    """Plain version: ``out[l, f, rows[l, i]] += vals[l, f, i]`` into a zero
    [L, F, T] table, one ``index_add_`` on its flat view; rows outside
    [0, T) are dropped."""
    levels, f, _ = vals.shape
    r = rows.long()
    keep = (r >= 0) & (r < table_size)  # [L, M]
    base = torch.arange(levels * f, device=rows.device).reshape(levels, f, 1) * table_size
    flat = base + torch.where(keep, r, 0)[:, None, :]
    out = torch.zeros(levels * f * table_size, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, flat.reshape(-1), torch.where(keep[:, None, :], vals, 0.0).reshape(-1))
    return out.reshape(levels, f, table_size)


def scatter_add_plain(idx: torch.Tensor, updates: torch.Tensor, table_size: int) -> torch.Tensor:
    """Plain version of the row-major L = 1 case: [M, 2] at rows [M] → [T, 2]."""
    return scatter_levels_plain(idx[None], updates.t()[None], table_size)[0].t().contiguous()


def scatter_add_plain_t(idx: torch.Tensor, updates_ft: torch.Tensor, table_size: int) -> torch.Tensor:
    """Plain version of the plane-major L = 1 case: [F, M] → [F, T]."""
    return scatter_levels_plain(idx[None], updates_ft[None], table_size)[0]


def scatter_levels(rows: torch.Tensor, vals: torch.Tensor, table_size: int) -> torch.Tensor:
    """rows [L, M], vals [L, 2, M] → [L, 2, T] gradient tables:
    ``out[l, f, rows[l, i]] += vals[l, f, i]``, rows outside [0, T)
    dropped."""
    return scatter_levels_plain(rows, vals, table_size)


def scatter_add_tablegrad(idx: torch.Tensor, updates: torch.Tensor, table_size: int) -> torch.Tensor:
    """``updates`` [M, 2] at rows ``idx`` [M] → [T, 2] gradient table."""
    return scatter_add_plain(idx, updates, table_size)


def scatter_add_tablegrad_t(idx: torch.Tensor, updates_ft: torch.Tensor, table_size: int) -> torch.Tensor:
    """Plane-major: ``updates_ft`` [2, M] at rows ``idx`` [M] → [2, T]."""
    return scatter_add_plain_t(idx, updates_ft, table_size)


# ---------------------------------------------------------------------------
# stochastic-corner interpolated lookups (proposal fields)


def _sample_corner(idx: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """corner ~ Categorical(w/Σw) per sample by inverse CDF →
    (rows [N], Σw [N]).  idx, w: [8, N]; u: [N] uniforms."""
    wsum = torch.sum(w, dim=0)
    cdf = torch.cumsum(w, dim=0)
    c_star = torch.sum(cdf < (u * wsum)[None, :], dim=0)
    c_star = torch.clamp(c_star, 0, w.shape[0] - 1)
    rows = torch.gather(idx, 0, c_star[None, :])[0]
    return rows, wsum


class _TakeInterpStoch(torch.autograd.Function):
    """Exact interpolated forward; backward scatters ``g·Σw`` to ONE corner
    drawn from Categorical(w/Σw).  The ``w`` cotangent is zero (positions
    carry no gradient where this is used)."""

    @staticmethod
    def forward(ctx, t2, idx, w, u):
        ctx.save_for_backward(idx, w, u)
        ctx.table_size = t2.shape[1]
        return torch.sum(w[None] * t2[:, idx], dim=1)

    @staticmethod
    def backward(ctx, g):
        idx, w, u = ctx.saved_tensors
        rows, wsum = _sample_corner(idx, w, u)
        dt = scatter_add_tablegrad_t(rows, g * wsum[None, :], ctx.table_size)
        return dt, None, None, None


class _TakeInterpStochFp(torch.autograd.Function):
    """ONE importance-sampled corner in the forward AND the backward:
    out = Σw · t2[:, idx_c*]; the backward scatters ``g·Σw`` to the same
    corner.  Unbiased dither of the trilinear lookup."""

    @staticmethod
    def forward(ctx, t2, idx, w, u):
        rows, wsum = _sample_corner(idx, w, u)
        ctx.save_for_backward(rows, wsum)
        ctx.table_size = t2.shape[1]
        return t2[:, rows] * wsum[None].to(t2.dtype)

    @staticmethod
    def backward(ctx, g):
        rows, wsum = ctx.saved_tensors
        dt = scatter_add_tablegrad_t(rows, g * wsum[None, :].to(g.dtype), ctx.table_size)
        return dt, None, None, None


def take_interp_stoch(t2, idx, w, u):
    """t2 [F, T]; idx, w [8, N]; u [N] → [F, N] (exact forward)."""
    return _TakeInterpStoch.apply(t2, idx, w, u)


def take_interp_stoch_fp(t2, idx, w, u):
    """t2 [F, T]; idx, w [8, N]; u [N] → [F, N] (sampled forward)."""
    return _TakeInterpStochFp.apply(t2, idx, w, u)


# ---------------------------------------------------------------------------
# custom-gradient gathers whose backward is K1 (JAX ``take_rows``,
# ``take_level_flat``, ``take_level``): exact gathers, table gradient by
# ``scatter_add_tablegrad(_t)``


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_size = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat_g = g.reshape(-1, g.shape[-1]).contiguous()
        return scatter_add_tablegrad(idx.reshape(-1), flat_g, ctx.table_size), None


class _TakeLevelFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t_flat, idx, table_size):
        ctx.save_for_backward(idx)
        ctx.table_size = table_size
        f = t_flat.shape[0] // table_size
        return torch.stack([t_flat[idx + fi * table_size] for fi in range(f)], dim=0)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gf = g.reshape(g.shape[0], -1)
        return scatter_add_tablegrad_t(idx.reshape(-1), gf, ctx.table_size).reshape(-1), None, None


class _TakeLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t2, idx):
        ctx.save_for_backward(idx)
        ctx.table_size = t2.shape[1]
        return t2[:, idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gf = g.reshape(g.shape[0], -1)
        return scatter_add_tablegrad_t(idx.reshape(-1), gf, ctx.table_size), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: table [T, 2], idx [...] int32 → [..., 2]; the table
    gradient is one ``scatter_add_tablegrad``."""
    return _TakeRows.apply(table, idx)


def take_level_flat(t_flat: torch.Tensor, idx: torch.Tensor, table_size: int) -> torch.Tensor:
    """One level's gather from its flat plane-major view: t_flat [2·T],
    idx [8, N] int32 → [2, 8, N]; the gradient [2·T] is one
    ``scatter_add_tablegrad_t``."""
    return _TakeLevelFlat.apply(t_flat, idx, table_size)


def take_level(t2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One level's gather: t2 [2, T], idx [8, N] int32 → [2, 8, N]; the
    gradient [2, T] is one ``scatter_add_tablegrad_t``."""
    return _TakeLevel.apply(t2, idx)
