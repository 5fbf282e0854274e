"""K1 — the hash-grid table-gradient scatter — the custom-gradient lookups
of the proposal fields, and the gathers ``take_rows``, ``take_level_flat``
and ``take_level`` whose table gradient is K1.

Counterpart of ``neusky_tpu/ops/hashgrid_pallas.py``.  The TPU kernel
``_scatter_kernel`` becomes the hand-written CUDA kernel in
``csrc/hashgrid_scatter.cu`` (see its header for the design and its bound),
built with ``nvcc`` for ``sm_90a`` at first use and bound with ctypes.  It
computes the JAX ``_scatter_levels``: all L levels of one encode in one
launch (:func:`scatter_levels`); ``scatter_add_tablegrad(_t)`` are its
L = 1 case.

Dispatch rule: a CPU tensor takes the plain version (``index_add_`` on a
zero table); a CUDA tensor launches the kernel or raises — there is no
fallback.  ``launches[KERNEL_NAME]`` counts kernel launches (the port's
counter ``hashgrid_scatter_levels``, ``utils/profiling.py``), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from neusky_torch.ops import cuda_build
from neusky_torch.utils import profiling

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "hashgrid_scatter.cu"

KERNEL_NAME = "hashgrid_scatter_levels"
launches = profiling.totals  # launches[KERNEL_NAME]

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Build output, keyed by the source's hash so an edit rebuilds."""
    return cuda_build.library_path(SOURCE, "hashgrid_scatter")


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile K1 (no-op if the library for this source exists).  Returns
    (library path, compiler messages — ``-Xptxas -v`` register/spill
    report when ``verbose``)."""
    return cuda_build.build(SOURCE, "hashgrid_scatter", verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.hashgrid_scatter_levels
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# the kernel's wrappers and its plain version


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


def _check(rows: torch.Tensor, vals: torch.Tensor, want_rows, want_vals, table_size: int) -> None:
    """Refuse what the kernel does not take, before anything is allocated:
    it never falls back."""
    if rows.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"K1 takes int32 indices and float32 values, got {rows.dtype} and {vals.dtype}")
    if tuple(rows.shape) != want_rows or tuple(vals.shape) != want_vals:
        raise ValueError(f"K1 shapes: rows {list(want_rows)}, values {list(want_vals)}; "
                         f"got {list(rows.shape)}, {list(vals.shape)}")
    if not (rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError("K1 takes contiguous tensors")
    if rows.device.type != "cuda" or vals.device.type != "cuda" or rows.device != vals.device:
        raise ValueError(f"K1 needs both tensors on one CUDA device, got {rows.device} and {vals.device}")
    levels = rows.shape[0] if rows.dim() == 2 else 1
    if max(rows.numel(), levels * 2 * table_size) >= 2**31:
        raise ValueError(f"K1 indexes with 32 bits: rows {list(rows.shape)}, T={table_size}")


def _run(rows, vals, out, table_size: int, vals_strides, out_strides) -> torch.Tensor:
    """Launch K1 on checked tensors: rows [L, M], output slabs of 2T floats
    (zeroed by the library); strides are (feature, row) in elements."""
    levels, m = rows.shape
    if levels * m == 0:
        return out.zero_()
    lib = _load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        err = lib.hashgrid_scatter_levels(
            rows.data_ptr(), vals.data_ptr(), out.data_ptr(), levels, m, table_size,
            *vals_strides, *out_strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    profiling.count(KERNEL_NAME)
    return out


def _launch_levels(rows: torch.Tensor, vals: torch.Tensor, table_size: int) -> torch.Tensor:
    levels, m = rows.shape if rows.dim() == 2 else (0, 0)
    _check(rows, vals, (levels, m), (levels, 2, m), table_size)
    out = torch.empty((levels, 2, table_size), dtype=torch.float32, device=vals.device)
    return _run(rows, vals, out, table_size, (m, 1), (table_size, 1))


def _launch(idx: torch.Tensor, upd: torch.Tensor, table_size: int, transposed: bool) -> torch.Tensor:
    """The L = 1 case: idx [M], updates [2, M] (``transposed``) or [M, 2]."""
    m = idx.shape[0] if idx.dim() == 1 else -1
    _check(idx, upd, (m,), (2, m) if transposed else (m, 2), table_size)
    shape = (2, table_size) if transposed else (table_size, 2)
    out = torch.empty(shape, dtype=torch.float32, device=upd.device)
    strides, out_strides = ((m, 1), (table_size, 1)) if transposed else ((1, 2), (1, 2))
    return _run(idx[None], upd, out, table_size, strides, out_strides)


def scatter_levels(rows: torch.Tensor, vals: torch.Tensor, table_size: int) -> torch.Tensor:
    """rows [L, M] int32, vals [L, 2, M] → [L, 2, T] gradient tables:
    ``out[l, f, rows[l, i]] += vals[l, f, i]``, rows outside [0, T)
    dropped.  One launch for all levels."""
    if rows.device.type == "cpu" and vals.device.type == "cpu":
        return scatter_levels_plain(rows, vals, table_size)
    return _launch_levels(rows, vals.contiguous(), table_size)


def scatter_add_tablegrad(idx: torch.Tensor, updates: torch.Tensor, table_size: int) -> torch.Tensor:
    """``updates`` [M, 2] at rows ``idx`` [M] → [T, 2] gradient table."""
    if updates.device.type == "cpu" and idx.device.type == "cpu":
        return scatter_add_plain(idx, updates, table_size)
    return _launch(idx, updates, table_size, transposed=False)


def scatter_add_tablegrad_t(idx: torch.Tensor, updates_ft: torch.Tensor, table_size: int) -> torch.Tensor:
    """Plane-major: ``updates_ft`` [2, M] at rows ``idx`` [M] → [2, T]."""
    if updates_ft.device.type == "cpu" and idx.device.type == "cpu":
        return scatter_add_plain_t(idx, updates_ft, table_size)
    return _launch(idx, updates_ft.contiguous(), table_size, transposed=True)


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
    gradient is one ``scatter_add_tablegrad`` (K1 on the card)."""
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
