"""The DDF visibility query's fused FiLM-SIREN forward: one hand-written CUDA
kernel (``csrc/ddf_film_forward.cu``, see its header for the design and its
bound) for the canonical DDF field (NeRF position and direction encodings,
FiLM conditioning at width 256, bf16 FiLM products, an fp32 mapping network
with one shared head, a sigmoid distance head): a query row's encodings, the
mapping network, its frequency and phase heads, the FiLM layers and the
output layer in one launch, writing only ``expected_termination_dist``.

It replaces no TPU kernel (the JAX package leaves the query to XLA); it is
the plain path ``fields/ddf.py`` → ``nets/siren.py::FiLMSiren`` with its
activations kept on chip.  Built with ``nvcc`` for ``sm_90a`` at first use
and bound with ctypes (``ops/cuda_build.py``).

:func:`pack` lays the field's weights out once a query in the order a tile
of rows consumes them: 16 KB chunks of fp32 rows of the mapping kernels and
of the heads' column blocks, and the FiLM kernels rounded to bf16 in
``mma.sync`` fragment order.  :func:`film_forward` launches the kernel on
CUDA tensors or raises: it has no CPU mode and no fallback (the caller
decides where it engages, ``models/neusky.py::NeuSkyModel._fuses_ddf``).
The counter ``ddf.fused_rows`` (``utils/profiling.py``) adds the rows each
launch answers and ``ddf_film_forward`` its launches; a captured launch
re-adds both on every replay.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from neusky_torch.ops import cuda_build
from neusky_torch.utils import profiling

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ddf_film_forward.cu"
KERNEL_NAME = "ddf_film_forward"
FUSED_ROWS = "ddf.fused_rows"  # counter: query rows the kernel answered
launches = profiling.totals  # launches[KERNEL_NAME], launches[FUSED_ROWS] the rows
WIDTH = 256  # the kernel's FiLM and mapping width
ENC_DIM = 15  # [v, NeRF(v)] of a 3-vector at 2 frequencies
_CHUNK_BYTES = 16384

_lib: Optional[ctypes.CDLL] = None


def build(verbose: bool = False):
    """Compile the kernel (no-op if its library exists): (path, messages)."""
    return cuda_build.build(SOURCE, KERNEL_NAME, verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.ddf_film_forward
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class Packed(NamedTuple):
    chunks: torch.Tensor  # uint8 [n · 16 KB], a tile's weight chunks in order
    biases: torch.Tensor  # fp32: mapping [L, 256], heads [2F · 256], FiLM [F, 256], output [256], [1]
    mapping_layers: int
    film_layers: int

    @property
    def n_chunks(self) -> int:
        return self.chunks.numel() // _CHUNK_BYTES


def layer_counts(net) -> tuple:
    """(mapping layers, FiLM layers) of a FiLM-SIREN parameter dict."""
    mp = net["MappingNetwork_0"]
    return (sum(1 for k in mp if k.startswith("kernel_") and k != "kernel_out"),
            sum(1 for k in net if k.startswith("film_kernel_")))


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """fp32 [K, 256] → bf16 (nearest even) ``mma.sync`` m16n8k16 B fragments
    [K/16, 32 n tiles, 32 lanes, 4]: lane 4g + t holds column 8·tile + g at
    rows 2t, 2t + 1, 2t + 8, 2t + 9 of its 16-row tile; K padded to 16."""
    w16 = torch.nn.functional.pad(w, (0, 0, 0, -w.shape[0] % 16)).bfloat16()
    kt = w16.shape[0] // 16
    # k = 16 kt + 8 jh + 2 t + jl, n = 8 nt + g  →  [kt, nt, g, t, jh, jl]
    return w16.reshape(kt, 2, 4, 2, WIDTH // 8, 8).permute(0, 4, 5, 2, 1, 3).contiguous()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


@torch.no_grad()
def pack(net) -> Packed:
    """The FiLM-SIREN's weights in the kernel's order (see the module
    docstring): per tile, the first mapping kernel (padded to 16 rows), the
    others, then for each FiLM layer its kernel's fragments (the first padded
    to a chunk) and its frequency and phase column blocks of ``kernel_out``."""
    mp = net["MappingNetwork_0"]
    nm, nf = layer_counts(net)
    ko = mp["kernel_out"]
    pieces = [torch.nn.functional.pad(mp["kernel_0"], (0, 0, 0, 16 - ENC_DIM))]
    pieces += [mp[f"kernel_{i}"] for i in range(1, nm)]
    for i in range(nf):
        frag = _fragments(net[f"film_kernel_{i}"])
        pieces.append(frag)
        if i == 0:  # one 16-row tile: half a chunk
            pieces.append(frag.new_zeros(frag.shape))
        pieces += [ko[:, i * WIDTH:(i + 1) * WIDTH], ko[:, (nf + i) * WIDTH:(nf + i + 1) * WIDTH]]
    biases = [mp[f"bias_{i}"] for i in range(nm)] + [mp["bias_out"]]
    biases += [net[f"film_bias_{i}"] for i in range(nf)] + [net["out_kernel"].reshape(-1), net["out_bias"].reshape(-1)]
    return Packed(torch.cat([_bytes(p) for p in pieces]), torch.cat(biases).contiguous(), nm, nf)


def takes(rows: torch.Tensor) -> bool:
    """Whether the kernel takes query rows like ``rows``: float32 on a CUDA
    card."""
    return rows.is_cuda and rows.dtype == torch.float32


def _check(origins: torch.Tensor, local_dirs: torch.Tensor, packed: Packed) -> None:
    """Refuse what the kernel does not take, before anything is allocated."""
    m = origins.shape[0]
    for t in (origins, local_dirs):
        if t.dtype != torch.float32 or tuple(t.shape) != (m, 3) or not t.is_contiguous():
            raise ValueError(f"{KERNEL_NAME} takes contiguous float32 [M, 3] rows, got {t.dtype} {list(t.shape)}")
    devices = {origins.device, local_dirs.device, packed.chunks.device, packed.biases.device}
    if len(devices) != 1 or origins.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAME} needs every tensor on one CUDA device, got {devices}")


def film_forward(packed: Packed, origins: torch.Tensor, local_dirs: torch.Tensor, scale: float) -> torch.Tensor:
    """origins, local directions [M, 3] → ``scale`` · sigmoid(FiLM-SIREN)
    [M], no autograd.  ``packed``: :func:`pack` of the field's ``net``,
    made once for many calls."""
    _check(origins, local_dirs, packed)
    m = origins.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=origins.device)
    if m == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    with torch.cuda.device(origins.device):
        err = lib.ddf_film_forward(
            origins.data_ptr(), local_dirs.data_ptr(), packed.chunks.data_ptr(), packed.biases.data_ptr(),
            out.data_ptr(), m, packed.n_chunks, packed.mapping_layers, packed.film_layers, scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {err}")
    profiling.count(KERNEL_NAME)
    profiling.count(FUSED_ROWS, m)
    return out
