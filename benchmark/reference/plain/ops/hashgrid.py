"""Multi-resolution hash-grid encoding (mirror of
``neusky_tpu/ops/hashgrid.py``).

Tables are ``[L, F, T]``.  Every call that the JAX vectorized branch covers
goes through the all-level ops (``_EncodeAll*``, ``_encode_all_plain``):
corner indices and weights of all levels at once as ``[L, 8, N]`` from
positions ``xt`` [3, N], one gather, one interpolation.  The custom-gradient
ops are ``torch.autograd.Function``s whose only saved state is the
positions (plus the salt or ``u``; indices and weights are recomputed in
backward) and whose table gradient is ONE call of ``_scatter_levels`` —
the one scatter dispatch: the plain version for a CPU tensor, kernel K1
(all levels in one launch) for a CUDA tensor.  The per-level Functions
remain for the two calls with no all-level twin in JAX (``stoch_dxt`` with
a salt, ``bf16_gather``); their backward calls ``_scatter_levels`` with
L = 1.

uint32 arithmetic (the Instant-NGP prime hash and ``_cheap_hash_u``) is
emulated in int64 with ``& 0xFFFFFFFF``; multiplies by constants ≥ 2^31 go
through :func:`_mul_u32`, which splits the constant into 16-bit halves so no
intermediate exceeds 2^49.  Results are bit-identical to the JAX uint32 ops.

The salted hash keys each point by its lane, its index in the encode call.
A salt made by :func:`salt_with_lanes` carries the lanes explicitly: a rank
of a mesh that encodes its share of JAX's global call hashes the global
lanes, so its table gradients are JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.plain.device import device_constant
from benchmark.reference.plain.ops.hashgrid_plain import (
    _sample_corner,
    scatter_levels,
    take_interp_stoch,
    take_interp_stoch_fp,
)

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x · c`` for int64 ``x`` in [0, 2^32) and a Python
    constant ``c`` in [0, 2^32): x·c_lo and x·c_hi stay below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _take_ft(t2: torch.Tensor, idx: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Axis-1 corner gather from a level table ``t2 [F, T]``."""
    if bf16:
        t2 = t2.to(torch.bfloat16)
    return t2[:, idx]


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_res: int = 16
    max_res: int = 2048
    use_hash: bool = True
    smoothstep: bool = False
    vectorized: bool = False
    """No effect in the port: every call the JAX vectorized branch covers
    takes the all-level ops, which JAX holds to the per-level ops
    (``tests/test_encodings.py::TestVectorizedLevels``).  On the TPU it was
    a layout choice for XLA."""
    layout_barrier: bool = True
    """No effect in the port (an XLA layout hint in the JAX package)."""
    bf16_gather: bool = False

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp((np.log(self.max_res) - np.log(self.base_res)) / (self.num_levels - 1))
        )

    def resolutions(self) -> Tuple[int, ...]:
        g = self.growth_factor
        return tuple(int(np.floor(self.base_res * (g**lvl))) for lvl in range(self.num_levels))


_CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.int64)


class HashGridEncoding:
    """``init(generator, device) -> table``; ``__call__(table, x)``.
    ``x`` lives in [0, 1]^3; the table is [L, F, T]."""

    def __init__(self, config: HashGridConfig):
        self.config = config
        res = config.resolutions()
        self._resolutions = np.asarray(res, dtype=np.int64)
        self._dense = np.array(
            [(not config.use_hash) or ((r + 1) ** 3 <= config.table_size) for r in res]
        )
        self._corner_cache: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._level_cache: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    @property
    def out_dim(self) -> int:
        return self.config.out_dim

    def init(self, generator: Optional[torch.Generator], device, dtype=torch.float32) -> torch.Tensor:
        """tcnn-style init: uniform in [-1e-4, 1e-4], shape [L, F, T]."""
        c = self.config
        shape = (c.num_levels, c.features_per_level, c.table_size)
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return u * 2e-4 - 1e-4

    def _corners(self, device):
        if device not in self._corner_cache:
            corners = torch.as_tensor(_CORNERS, device=device)  # [8, 3]
            self._corner_cache[device] = (corners, corners[:, :, None] == 1)
        return self._corner_cache[device]

    def _level_iw(self, xt: torch.Tensor, lvl: int, need_dw: bool):
        """One level's corner indices / weights: xt [3, N] →
        (idx [8, N] int32, W [8, N], dW [3, 8, N] | None)."""
        c = self.config
        res = int(self._resolutions[lvl])
        resf = float(res)
        scaled = xt * resf
        floor = torch.floor(scaled)
        frac = scaled - floor
        base = floor.to(torch.int64)
        corners, cb = self._corners(xt.device)
        coords = base[None, :, :] + corners[:, :, None]  # [8, 3, N]

        if self._dense[lvl]:
            rp1 = res + 1
            cc = torch.clamp(coords, max=res)
            idx = cc[:, 0] + cc[:, 1] * rp1 + cc[:, 2] * (rp1 * rp1)
            idx = torch.clamp(idx, max=c.table_size - 1)
        else:
            cu = coords & _U32
            hashed = (
                _mul_u32(cu[:, 0], _PRIMES[0])
                ^ _mul_u32(cu[:, 1], _PRIMES[1])
                ^ _mul_u32(cu[:, 2], _PRIMES[2])
            )
            idx = hashed & (c.table_size - 1)
        idx = idx.to(torch.int32)

        if c.smoothstep:
            u = frac * frac * (3.0 - 2.0 * frac)
            du = 6.0 * frac * (1.0 - frac) * resf
        else:
            u = frac
            du = None
        omega = torch.where(cb, u[None], 1.0 - u[None])  # [8, 3, N]
        W = omega[:, 0] * omega[:, 1] * omega[:, 2]
        if not need_dw:
            return idx, W, None
        sign = torch.where(cb, 1.0, -1.0).to(xt.dtype)  # [8, 3, 1]
        dWs = []
        for a in range(3):
            others = [b for b in range(3) if b != a]
            prod_others = omega[:, others[0]] * omega[:, others[1]]
            if du is None:
                d = sign[:, a] * resf * prod_others
            else:
                d = sign[:, a] * du[None, a] * prod_others
            dWs.append(d)
        return idx, W, torch.stack(dWs, dim=0)

    def _levels(self, device):
        """Per-level constants on ``device``: resolutions [L, 1, 1] (float32),
        dense resolutions [L, 1, 1, 1] (0 on hashed levels) and the dense
        mask [L, 1, 1]."""
        if device not in self._level_cache:
            res_dense = np.where(self._dense, self._resolutions, 0)
            self._level_cache[device] = (
                torch.as_tensor(self._resolutions, dtype=torch.float32, device=device)[:, None, None],
                torch.as_tensor(res_dense, device=device)[:, None, None, None],
                torch.as_tensor(self._dense, device=device)[:, None, None],
            )
        return self._level_cache[device]

    def _all_iw(self, xt: torch.Tensor, need_dw: bool):
        """All levels' corner indices / weights in one graph: xt [3, N] →
        (idx [L, 8, N] int32, W [L, 8, N], dW [L, 3, 8, N] | None).  Row
        ``lvl`` is bit for bit ``_level_iw(xt, lvl)``: the dense and hashed
        indices are both computed and selected by the static dense mask,
        the dense arithmetic clamped to 0 on hashed levels (as JAX does)."""
        c = self.config
        resf, res_safe, dense = self._levels(xt.device)
        resf = resf.to(xt.dtype)
        scaled = xt[None] * resf  # [L, 3, N]
        floor = torch.floor(scaled)
        frac = scaled - floor
        base = floor.to(torch.int64)
        corners, cb = self._corners(xt.device)
        coords = base[:, None] + corners[None, :, :, None]  # [L, 8, 3, N]

        cc = torch.minimum(coords, res_safe)
        rp1 = res_safe[:, :, 0] + 1  # [L, 1, 1]
        idx_dense = cc[:, :, 0] + cc[:, :, 1] * rp1 + cc[:, :, 2] * (rp1 * rp1)
        idx_dense = torch.clamp(idx_dense, max=c.table_size - 1)
        cu = coords & _U32
        hashed = (
            _mul_u32(cu[:, :, 0], _PRIMES[0])
            ^ _mul_u32(cu[:, :, 1], _PRIMES[1])
            ^ _mul_u32(cu[:, :, 2], _PRIMES[2])
        )
        idx = torch.where(dense, idx_dense, hashed & (c.table_size - 1)).to(torch.int32)

        if c.smoothstep:
            u = frac * frac * (3.0 - 2.0 * frac)
            du = 6.0 * frac * (1.0 - frac) * resf  # [L, 3, N]
        else:
            u = frac
            du = None
        omega = torch.where(cb[None], u[:, None], 1.0 - u[:, None])  # [L, 8, 3, N]
        W = omega[:, :, 0] * omega[:, :, 1] * omega[:, :, 2]
        if not need_dw:
            return idx, W, None
        sign = torch.where(cb, 1.0, -1.0).to(xt.dtype)[None]  # [1, 8, 3, 1]
        dWs = []
        for a in range(3):
            others = [b for b in range(3) if b != a]
            prod_others = omega[:, :, others[0]] * omega[:, :, others[1]]
            if du is None:
                d = sign[:, :, a] * resf * prod_others
            else:
                d = sign[:, :, a] * du[:, None, a] * prod_others
            dWs.append(d)
        return idx, W, torch.stack(dWs, dim=1)

    @staticmethod
    def _assemble(per_level, n: int) -> torch.Tensor:
        """L tensors [F, N] → [N, L*F] (feature-within-level order)."""
        return torch.stack(per_level, dim=0).permute(2, 0, 1).reshape(n, -1)

    def __call__(
        self,
        table: torch.Tensor,
        x: torch.Tensor,
        custom_take: bool = False,
        stoch_u: Optional[torch.Tensor] = None,
        stoch_salt: Optional[torch.Tensor] = None,
        stoch_fwd: bool = False,
        stoch_dxt: bool = False,
    ) -> torch.Tensor:
        """Encode positions x [N, 3] in [0, 1] → [N, L*F].  Same switches as
        the JAX ``__call__``: ``stoch_u`` (proposal fields, [N] uniforms,
        golden-ratio shifted per level) the stochastic-corner table gradient
        (with ``stoch_fwd`` the sampled forward too); ``custom_take`` with
        ``stoch_salt`` the stochastic-corner table gradient with exact
        forward and position cotangent; ``custom_take`` alone the exact
        custom-gradient encode; otherwise plain autograd.  All of them take
        the all-level ops, except ``stoch_dxt`` with a salt and
        ``bf16_gather``, which JAX has per level only."""
        xt = x.t()
        sdxt = custom_take and stoch_u is None and stoch_salt is not None and stoch_dxt
        if sdxt or self.config.bf16_gather:
            return self._encode_per_level(table, xt, custom_take, stoch_u, stoch_salt, stoch_fwd, stoch_dxt)
        if stoch_u is not None:
            op = _EncodeAllStochFp if stoch_fwd else _EncodeAllStochU
            return op.apply(self, table, xt, stoch_u)
        if custom_take and stoch_salt is not None:
            return _EncodeAllStoch.apply(self, table, xt, stoch_salt)
        if custom_take:
            return _EncodeAll.apply(self, table, xt)
        return _encode_all_plain(self, table, xt)

    def _encode_per_level(self, table, xt, custom_take, stoch_u, stoch_salt, stoch_fwd, stoch_dxt):
        """The JAX per-level ``__call__`` loop, one op per level."""
        levels = table.unbind(0)
        outs = []
        for lvl in range(self.config.num_levels):
            t2 = levels[lvl]
            if stoch_u is not None:
                idx, W, _ = self._level_iw(xt, lvl, need_dw=False)
                u_l = torch.remainder(stoch_u + (0.6180339887 * lvl) % 1.0, 1.0)
                take = take_interp_stoch_fp if stoch_fwd else take_interp_stoch
                outs.append(take(t2, idx, W.to(table.dtype), u_l))
            elif custom_take and stoch_salt is not None:
                outs.append(_LevelEncodeStoch.apply(self, lvl, t2, xt, stoch_salt, stoch_dxt))
            elif custom_take:
                outs.append(_LevelEncode.apply(self, lvl, t2, xt))
            else:
                outs.append(_interp(self, lvl, t2, xt))
        return self._assemble(outs, xt.shape[1])

    def encode_with_dx(
        self,
        table: torch.Tensor,
        x: torch.Tensor,
        custom_take: bool = True,
        stoch_salt: Optional[torch.Tensor] = None,
    ):
        """Encode + closed-form position derivative:
        x [N, 3] → (out [N, L*F], dout_dx [N, 3, L*F]).  With ``stoch_salt``
        the table gradient samples one uniform corner per (sample, level)
        (``_EncodeAllDxStoch``); forward and d/dx stay exact.
        ``custom_take`` takes the all-level ops (per level with
        ``bf16_gather``); without it, plain autograd per level."""
        xt = x.t()
        if custom_take and not self.config.bf16_gather:
            if stoch_salt is not None:
                return _EncodeAllDxStoch.apply(self, table, xt, stoch_salt)
            return _EncodeAllDx.apply(self, table, xt)
        n = xt.shape[1]
        levels = table.unbind(0)
        outs = []
        douts = [[], [], []]
        for lvl in range(self.config.num_levels):
            t2 = levels[lvl]
            if custom_take:
                if stoch_salt is not None:
                    o, *ds = _LevelEncodeDxStoch.apply(self, lvl, t2, xt, stoch_salt)
                else:
                    o, *ds = _LevelEncodeDx.apply(self, lvl, t2, xt)
            else:
                o, *ds = _interp_with_dx(self, lvl, t2, xt, self.config.bf16_gather)
            outs.append(o)
            for a in range(3):
                douts[a].append(ds[a])
        out = self._assemble(outs, n)
        dout = torch.stack([self._assemble(d, n) for d in douts], dim=1)
        return out, dout


def _scatter_levels(rows: torch.Tensor, vals: torch.Tensor, t: int) -> torch.Tensor:
    """rows [L, M], vals [L, F, M] → [L, F, T] gradient tables (rows outside
    [0, T) dropped).  The one scatter dispatch: plain ``index_add_`` for a
    CPU tensor, K1 — one launch for all levels — for a CUDA tensor."""
    return scatter_levels(rows, vals, t)


def _scatter_level(rows: torch.Tensor, vals: torch.Tensor, t: int) -> torch.Tensor:
    """One level's table gradient, the L = 1 case: rows [M], vals [F, M] → [F, T]."""
    return _scatter_levels(rows[None], vals[None], t)[0]


def _hash_mix(x: torch.Tensor, salt) -> torch.Tensor:
    """The Wang-style uint32 mix of ``_cheap_hash_u`` after the lane/level
    offset, → uniforms in [0, 1)."""
    x = x ^ (salt & _U32)
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def salt_with_lanes(salt: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """A salt that hashes point i of an encode call as lane ``lanes[i]``
    (int64, [N]) in place of i: ``[salt, *lanes]``, int64 [N + 1]."""
    return torch.cat([salt.reshape(1).to(torch.int64), lanes.to(torch.int64)])


def _salt_and_lanes(n: int, salt):
    """(uint32 salt, int64 lanes [N]) of a salt: a plain salt (int64
    tensor of shape [], or int) hashes lanes 0..N-1."""
    if not isinstance(salt, torch.Tensor) or salt.dim() == 0:
        device = salt.device if isinstance(salt, torch.Tensor) else None
        return salt, torch.arange(n, dtype=torch.int64, device=device)
    if salt.shape[0] != n + 1:
        raise ValueError(f"salt carries {salt.shape[0] - 1} lanes for {n} points")
    return salt[0], salt[1:]


def _cheap_hash_u(n: int, lvl: int, salt: torch.Tensor) -> torch.Tensor:
    """[N] uniforms in [0, 1) from (lane index, level, salt): the JAX
    Wang-style uint32 mix, bit for bit.  ``salt`` is an int64 tensor (or
    int) holding a uint32 value, or one of :func:`salt_with_lanes`."""
    salt, x = _salt_and_lanes(n, salt)
    x = (_mul_u32(x, 0x9E3779B9) + ((lvl * 0x85EBCA6B) & _U32)) & _U32
    return _hash_mix(x, salt)


def _interp(enc, lvl, t2, xt):
    """One level's trilinear lookup: t2 [F, T], xt [3, N] → [F, N]."""
    idx, W, _ = enc._level_iw(xt, lvl, need_dw=False)
    feats = _take_ft(t2, idx, enc.config.bf16_gather)
    return torch.sum(W.to(feats.dtype)[None] * feats, dim=1).to(t2.dtype)


def _interp_with_dx(enc, lvl, t2, xt, bf16: bool):
    """One level's lookup and its d/dx → (out, d0, d1, d2), each [F, N]."""
    idx, W, dW = enc._level_iw(xt, lvl, need_dw=True)
    feats = _take_ft(t2, idx, bf16)
    w, dw = W.to(feats.dtype), dW.to(feats.dtype)
    out = torch.sum(w[None] * feats, dim=1).to(t2.dtype)
    return (out,) + tuple(torch.sum(dw[a][None] * feats, dim=1).to(t2.dtype) for a in range(3))


def _exact_dxt(enc, lvl, t2, xt, idx, dW, g):
    """Exact position cotangent Σ_c dW[a,c,n] · Σ_f g[f,n] · feats[f,c,n]."""
    feats = _take_ft(t2, idx, enc.config.bf16_gather)
    gf = torch.sum(g[:, None, :] * feats.to(g.dtype), dim=0)  # [8, N]
    return torch.sum(dW.to(g.dtype) * gf[None], dim=1)  # [3, N]


class _LevelEncode(torch.autograd.Function):
    """One level's interpolated encode: t2 [F, T], xt [3, N] → [F, N];
    exact table gradient and TRUE position cotangent."""

    @staticmethod
    def forward(ctx, enc, lvl, t2, xt):
        ctx.enc, ctx.lvl = enc, lvl
        ctx.save_for_backward(t2, xt)
        return _interp(enc, lvl, t2, xt)

    @staticmethod
    def backward(ctx, g):
        t2, xt = ctx.saved_tensors
        enc, lvl = ctx.enc, ctx.lvl
        idx, W, dW = enc._level_iw(xt, lvl, need_dw=True)
        w_upd = W.to(g.dtype)[None] * g[:, None, :]  # [F, 8, N]
        d = _scatter_level(idx.reshape(-1), w_upd.reshape(g.shape[0], -1), t2.shape[1])
        dxt = _exact_dxt(enc, lvl, t2, xt, idx, dW, g) if ctx.needs_input_grad[3] else None
        return None, None, d, dxt


class _LevelEncodeDx(torch.autograd.Function):
    """Encode + analytic d/dx → (out, d0, d1, d2), each [F, N]; exact
    table gradient from all four cotangents, zero position cotangent."""

    @staticmethod
    def forward(ctx, enc, lvl, t2, xt):
        ctx.enc, ctx.lvl, ctx.table_size = enc, lvl, t2.shape[1]
        ctx.save_for_backward(xt)
        return _interp_with_dx(enc, lvl, t2, xt, enc.config.bf16_gather)

    @staticmethod
    def backward(ctx, g_out, g0, g1, g2):
        (xt,) = ctx.saved_tensors
        idx, W, dW = ctx.enc._level_iw(xt, ctx.lvl, need_dw=True)
        upd = W.to(g_out.dtype)[None] * g_out[:, None, :]
        dw = dW.to(g_out.dtype)
        for a, ga in enumerate((g0, g1, g2)):
            upd = upd + dw[a][None] * ga[:, None, :]
        d = _scatter_level(idx.reshape(-1), upd.reshape(g_out.shape[0], -1), ctx.table_size)
        return None, None, d, None


class _LevelEncodeStoch(torch.autograd.Function):
    """= ``_LevelEncode`` forward; the table gradient scatters ONE corner
    per sample drawn ~ Categorical(W) with value g·ΣW.  The position
    cotangent stays exact (``_level_encode_stoch``) or, with
    ``sampled_dxt``, samples one uniform corner too (×8 weight, independent
    hash stream lvl + 131: ``_level_encode_stoch_sdxt``)."""

    @staticmethod
    def forward(ctx, enc, lvl, t2, xt, salt, sampled_dxt):
        ctx.enc, ctx.lvl, ctx.sampled_dxt = enc, lvl, sampled_dxt
        ctx.save_for_backward(t2, xt, salt)
        return _interp(enc, lvl, t2, xt)

    @staticmethod
    def backward(ctx, g):
        t2, xt, salt = ctx.saved_tensors
        enc, lvl = ctx.enc, ctx.lvl
        idx, W, dW = enc._level_iw(xt, lvl, need_dw=True)
        n = xt.shape[1]
        rows, wsum = _sample_corner(idx, W.to(g.dtype), _cheap_hash_u(n, lvl, salt))
        d = _scatter_level(rows, g * wsum[None, :], t2.shape[1])
        dxt = None
        if ctx.needs_input_grad[3] and not ctx.sampled_dxt:
            dxt = _exact_dxt(enc, lvl, t2, xt, idx, dW, g)
        elif ctx.needs_input_grad[3]:
            u2 = _cheap_hash_u(n, lvl + 131, salt)
            c = torch.clamp((u2 * 8.0).to(torch.int64), max=7)  # [N]
            rows2 = torch.gather(idx, 0, c[None, :])[0]
            feats_c = _take_ft(t2, rows2, enc.config.bf16_gather).to(g.dtype)  # [F, N]
            gf = torch.sum(g * feats_c, dim=0)
            dw_c = torch.gather(dW.to(g.dtype), 1, c[None, None, :].expand(3, 1, n))[:, 0, :]
            dxt = 8.0 * dw_c * gf[None]
        return None, None, d, dxt, None, None


class _LevelEncodeDxStoch(torch.autograd.Function):
    """= ``_LevelEncodeDx`` forward; the backward samples ONE corner
    uniformly (p = 1/8, value ×8): the combined cotangent mixes signs, so
    uniform — not importance — sampling keeps it unbiased."""

    @staticmethod
    def forward(ctx, enc, lvl, t2, xt, salt):
        ctx.enc, ctx.lvl, ctx.table_size = enc, lvl, t2.shape[1]
        ctx.save_for_backward(xt, salt)
        # float32 gather whatever bf16_gather says, as in the JAX op
        return _interp_with_dx(enc, lvl, t2, xt, bf16=False)

    @staticmethod
    def backward(ctx, g_out, g0, g1, g2):
        xt, salt = ctx.saved_tensors
        idx, W, dW = ctx.enc._level_iw(xt, ctx.lvl, need_dw=True)
        u = _cheap_hash_u(xt.shape[1], ctx.lvl, salt)
        c = torch.clamp((u * 8.0).to(torch.int64), max=7)[None, :]  # [1, N]
        rows = torch.gather(idx, 0, c)[0]
        upd = torch.gather(W.to(g_out.dtype), 0, c) * g_out  # [F, N]
        for a, ga in enumerate((g0, g1, g2)):
            upd = upd + torch.gather(dW[a].to(g_out.dtype), 0, c) * ga
        d = _scatter_level(rows, 8.0 * upd, ctx.table_size)
        return None, None, d, None, None


# ---------------------------------------------------------------------------
# the all-level ops (JAX ``_encode_all*``, ``neusky_tpu/ops/hashgrid.py:
# 711-999``): one gather and one interpolation for the whole pyramid; each
# custom-gradient op saves the positions (+ salt or u) only and ends its
# backward in ONE ``_scatter_levels`` call.  Values, cotangents and
# stochastic corner draws equal the per-level ops'.


def _gather_all(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [L, F, T], idx [L, ..., N] → feats [L, F, ..., N]."""
    l, f, _ = table.shape
    flat = idx.reshape(l, 1, -1).long().expand(l, f, -1)
    return torch.gather(table, 2, flat).reshape(l, f, *idx.shape[1:])


def _assemble_all(out_lfn: torch.Tensor) -> torch.Tensor:
    """[L, F, N] → [N, L*F] (the per-level ``_assemble`` order)."""
    l, f, n = out_lfn.shape
    return out_lfn.permute(2, 0, 1).reshape(n, l * f)


def _unassemble_all(g: torch.Tensor, l: int, f: int) -> torch.Tensor:
    """[N, L*F] cotangent → [L, F, N]."""
    return g.reshape(g.shape[0], l, f).permute(1, 2, 0)


def _unassemble_dx(g_d: torch.Tensor, l: int, f: int) -> torch.Tensor:
    """[N, 3, L*F] cotangent → [L, 3, F, N]."""
    return g_d.reshape(g_d.shape[0], 3, l, f).permute(2, 1, 3, 0)


def _cheap_hash_u_all(n: int, l: int, salt: torch.Tensor) -> torch.Tensor:
    """[L, N] uniforms; row lvl bit-identical to ``_cheap_hash_u(n, lvl, salt)``."""
    salt, lanes = _salt_and_lanes(n, salt)
    x = _mul_u32(lanes, 0x9E3779B9)[None, :]
    lvl_off = _mul_u32(torch.arange(l, dtype=torch.int64, device=salt.device), 0x85EBCA6B)[:, None]
    return _hash_mix((x + lvl_off) & _U32, salt)


def _golden_u_all(stoch_u: torch.Tensor, l: int) -> torch.Tensor:
    """[N] base uniforms → [L, N]; row lvl == remainder(u + (φ·lvl % 1), 1)."""
    shifts = device_constant(tuple((0.6180339887 * lvl) % 1.0 for lvl in range(l)), stoch_u.dtype, stoch_u.device)
    return torch.remainder(stoch_u[None, :] + shifts[:, None], 1.0)


def _sample_corner_all(idx: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """corner ~ Categorical(w/Σw) per (level, sample) by inverse CDF:
    idx, w [L, 8, N]; u [L, N] → (rows [L, N], Σw [L, N])."""
    wsum = torch.sum(w, dim=1)
    cdf = torch.cumsum(w, dim=1)
    c_star = torch.sum(cdf < (u * wsum)[:, None, :], dim=1)
    c_star = torch.clamp(c_star, 0, w.shape[1] - 1)
    rows = torch.gather(idx, 1, c_star[:, None, :])[:, 0, :]
    return rows, wsum


def _interp_all(enc, table, xt):
    """Exact all-level lookup → [L, F, N]."""
    idx, W, _ = enc._all_iw(xt, need_dw=False)
    feats = _gather_all(table, idx)  # [L, F, 8, N]
    return torch.sum(W[:, None].to(table.dtype) * feats, dim=2)


def _interp_all_with_dx(table, idx, W, dW):
    """All-level lookup and its d/dx → (out [L, F, N], dout [L, 3, F, N])."""
    feats = _gather_all(table, idx)  # [L, F, 8, N]
    out = torch.sum(W[:, None].to(table.dtype) * feats, dim=2)
    dout = torch.stack([torch.sum(dW[:, a, None].to(table.dtype) * feats, dim=2) for a in range(3)], dim=1)
    return out, dout


def _dx_assemble(dout: torch.Tensor) -> torch.Tensor:
    """[L, 3, F, N] → [N, 3, L*F]."""
    l, _, f, n = dout.shape
    return dout.permute(3, 1, 0, 2).reshape(n, 3, l * f)


def _exact_dxt_all(table, idx, dW, gl):
    """Exact position cotangent Σ_{l,c} dW[l,a,c,n] · Σ_f g[l,f,n] · feats[l,f,c,n] → [3, N]."""
    feats = _gather_all(table, idx)  # [L, F, 8, N]
    gf = torch.sum(gl[:, :, None, :] * feats, dim=1)  # [L, 8, N]
    return torch.sum(dW.to(gl.dtype) * gf[:, None], dim=(0, 2))


def _encode_all_plain(enc, table, xt):
    """All-level encode differentiated by autograd (``custom_take=False``)."""
    return _assemble_all(_interp_all(enc, table, xt))


class _EncodeAll(torch.autograd.Function):
    """All-level encode: table [L, F, T], xt [3, N] → [N, L*F].  Exact
    forward, exact 8-corner table gradient, TRUE position cotangent."""

    @staticmethod
    def forward(ctx, enc, table, xt):
        ctx.enc = enc
        ctx.save_for_backward(table, xt)
        return _assemble_all(_interp_all(enc, table, xt))

    @staticmethod
    def backward(ctx, g):
        table, xt = ctx.saved_tensors
        l, f, t = table.shape
        idx, W, dW = ctx.enc._all_iw(xt, need_dw=True)
        gl = _unassemble_all(g, l, f)  # [L, F, N]
        upd = W[:, None].to(g.dtype) * gl[:, :, None, :]  # [L, F, 8, N]
        dtable = _scatter_levels(idx.reshape(l, -1), upd.reshape(l, f, -1), t)
        dxt = _exact_dxt_all(table, idx, dW, gl) if ctx.needs_input_grad[2] else None
        return None, dtable, dxt


class _EncodeAllStoch(torch.autograd.Function):
    """= ``_EncodeAll`` forward; the backward scatters ONE importance-
    sampled corner per (level, sample), value g·ΣW; the position cotangent
    stays exact."""

    @staticmethod
    def forward(ctx, enc, table, xt, salt):
        ctx.enc = enc
        ctx.save_for_backward(table, xt, salt)
        return _assemble_all(_interp_all(enc, table, xt))

    @staticmethod
    def backward(ctx, g):
        table, xt, salt = ctx.saved_tensors
        l, f, t = table.shape
        idx, W, dW = ctx.enc._all_iw(xt, need_dw=True)
        gl = _unassemble_all(g, l, f)
        rows, wsum = _sample_corner_all(idx, W.to(g.dtype), _cheap_hash_u_all(xt.shape[1], l, salt))
        dtable = _scatter_levels(rows, gl * wsum[:, None, :], t)
        dxt = _exact_dxt_all(table, idx, dW, gl) if ctx.needs_input_grad[2] else None
        return None, dtable, dxt, None


class _EncodeAllStochU(torch.autograd.Function):
    """Exact forward; stochastic-corner table gradient driven by the
    caller's uniforms ``u`` [N] (golden-ratio shifted per level); no
    position cotangent (the proposal fields' bins carry none)."""

    @staticmethod
    def forward(ctx, enc, table, xt, u):
        ctx.enc, ctx.table_shape = enc, table.shape
        ctx.save_for_backward(xt, u)
        return _assemble_all(_interp_all(enc, table, xt))

    @staticmethod
    def backward(ctx, g):
        xt, u = ctx.saved_tensors
        l, f, t = ctx.table_shape
        idx, W, _ = ctx.enc._all_iw(xt, need_dw=False)
        rows, wsum = _sample_corner_all(idx, W.to(g.dtype), _golden_u_all(u, l))
        dtable = _scatter_levels(rows, _unassemble_all(g, l, f) * wsum[:, None, :], t)
        return None, dtable, None, None


class _EncodeAllStochFp(torch.autograd.Function):
    """ONE importance-sampled corner per (level, sample) in the forward AND
    the backward: out = ΣW · table[l, :, row*]; the backward scatters g·ΣW
    to the same corner (recomputed from the positions and ``u``).  No
    position cotangent."""

    @staticmethod
    def forward(ctx, enc, table, xt, u):
        ctx.enc, ctx.table_shape = enc, table.shape
        ctx.save_for_backward(xt, u)
        idx, W, _ = enc._all_iw(xt, need_dw=False)
        rows, wsum = _sample_corner_all(idx, W, _golden_u_all(u, table.shape[0]))
        return _assemble_all(_gather_all(table, rows) * wsum[:, None, :].to(table.dtype))

    @staticmethod
    def backward(ctx, g):
        xt, u = ctx.saved_tensors
        l, f, t = ctx.table_shape
        idx, W, _ = ctx.enc._all_iw(xt, need_dw=False)
        rows, wsum = _sample_corner_all(idx, W.to(g.dtype), _golden_u_all(u, l))
        dtable = _scatter_levels(rows, _unassemble_all(g, l, f) * wsum[:, None, :], t)
        return None, dtable, None, None


class _EncodeAllDx(torch.autograd.Function):
    """All-level encode + analytic d/dx → (out [N, L*F], dout [N, 3, L*F]);
    exact 8-corner table gradient from both cotangents, no position
    cotangent (callers differentiate positions analytically)."""

    @staticmethod
    def forward(ctx, enc, table, xt):
        ctx.enc, ctx.table_shape = enc, table.shape
        ctx.save_for_backward(xt)
        idx, W, dW = enc._all_iw(xt, need_dw=True)
        out, dout = _interp_all_with_dx(table, idx, W, dW)
        return _assemble_all(out), _dx_assemble(dout)

    @staticmethod
    def backward(ctx, g_out, g_d):
        (xt,) = ctx.saved_tensors
        l, f, t = ctx.table_shape
        idx, W, dW = ctx.enc._all_iw(xt, need_dw=True)
        go, gd = _unassemble_all(g_out, l, f), _unassemble_dx(g_d, l, f)
        upd = W[:, None].to(go.dtype) * go[:, :, None, :]  # [L, F, 8, N]
        dw = dW.to(go.dtype)
        for a in range(3):
            upd = upd + dw[:, a, None] * gd[:, a, :, None, :]
        dtable = _scatter_levels(idx.reshape(l, -1), upd.reshape(l, f, -1), t)
        return None, dtable, None


class _EncodeAllDxStoch(torch.autograd.Function):
    """= ``_EncodeAllDx`` forward; the backward samples ONE corner per
    (level, sample) uniformly (p = 1/8, value ×8): the combined cotangent
    mixes signs, so uniform — not importance — sampling keeps it unbiased."""

    @staticmethod
    def forward(ctx, enc, table, xt, salt):
        ctx.enc, ctx.table_shape = enc, table.shape
        ctx.save_for_backward(xt, salt)
        idx, W, dW = enc._all_iw(xt, need_dw=True)
        out, dout = _interp_all_with_dx(table, idx, W, dW)
        return _assemble_all(out), _dx_assemble(dout)

    @staticmethod
    def backward(ctx, g_out, g_d):
        xt, salt = ctx.saved_tensors
        l, f, t = ctx.table_shape
        n = xt.shape[1]
        idx, W, dW = ctx.enc._all_iw(xt, need_dw=True)
        go, gd = _unassemble_all(g_out, l, f), _unassemble_dx(g_d, l, f)
        c = torch.clamp((_cheap_hash_u_all(n, l, salt) * 8.0).to(torch.int64), max=7)[:, None, :]  # [L, 1, N]
        rows = torch.gather(idx, 1, c)[:, 0, :]
        upd = torch.gather(W.to(go.dtype), 1, c) * go  # [L, F, N]
        dw_c = torch.gather(dW.to(go.dtype), 2, c[:, None].expand(l, 3, 1, n))[:, :, 0, :]  # [L, 3, N]
        for a in range(3):
            upd = upd + dw_c[:, a, None, :] * gd[:, a]
        dtable = _scatter_levels(rows, 8.0 * upd, t)
        return None, dtable, None, None
