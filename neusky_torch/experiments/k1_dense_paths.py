"""Experiment: where to sum the dense hash-grid levels' table gradients on
Hopper — in a cluster's distributed shared memory, in each CTA's own shared
memory, or in L2 — and K1 beside them.

    python -m neusky_torch.experiments.k1_dense_paths

Needs a CUDA card and ``nvcc``.  Builds ``k1_dense_paths.cu`` for
``sm_90a``, prints the SASS of its atomics (``cuobjdump``), then for every
dense level of the canonical scene slice's four encodes (rows from
``_all_iw`` on random positions, one random corner per sample, as
``chip_smoke.py`` phase 2) checks each way against the plain scatter and
prints its CUDA-event time in µs, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from neusky_torch.configs.neusky_config import neusky_model_config
from neusky_torch.ops import cuda_build, hashgrid_cuda as k1
from neusky_torch.ops.hashgrid import HashGridEncoding

SOURCE = Path(__file__).resolve().with_suffix(".cu")
MODES = {"cluster_dsmem": 0, "cta_shared": 1, "l2_red": 2}
HOLD_CYCLES = 20_000_000  # keeps the card busy while a timing loop is queued


def build() -> ctypes.CDLL:
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    out = cuda_build.BUILD_DIR / f"libk1_dense_paths_{tag}.so"
    if not out.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(SOURCE)], check=True)
    sass = subprocess.run([str(Path(cuda_build.nvcc()).with_name("cuobjdump")), "-sass", str(out)],
                          capture_output=True, text=True, check=True).stdout
    for line in sass.splitlines():
        if any(op in line for op in ("ATOM", "RED")):
            print("sass:", line.split(";")[0].strip())
    lib = ctypes.CDLL(str(out))
    lib.k1_dense_path.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.k1_dense_path.restype = ctypes.c_int
    return lib


def time_us(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def dense_levels(n_rays: int = 1024):
    """(site, level, hash config, M) of every dense level on the main path."""
    cfg = neusky_model_config(8, 2)
    prop = cfg.proposal
    sites = [(f"proposal_field_{i}", pf.hash, n_rays * prop.num_proposal_samples[i])
             for i, pf in enumerate(cfg.proposal_fields)]
    sites += [("sdf_field_outputs", cfg.sdf_field.hash, n_rays * prop.num_final_samples),
              ("density_grid_sdf", cfg.sdf_field.hash, cfg.losses.hashgrid_density_grid_resolution ** 3)]
    for name, h, m in sites:
        enc = HashGridEncoding(h)
        for lvl in range(h.num_levels):
            if enc._dense[lvl]:
                yield name, lvl, h, m, int(enc._resolutions[lvl] + 1) ** 3


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lib = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    totals = {}
    for site, lvl, h, m, extent in dense_levels():
        t = h.table_size
        x = torch.rand((3, m), generator=g, device="cuda")
        idx, _, _ = HashGridEncoding(h)._all_iw(x, need_dw=False)
        rows = idx[lvl, torch.randint(0, 8, (m,), generator=g, device="cuda"), torch.arange(m, device="cuda")]
        rows = rows.contiguous()
        vals = torch.randn((2, m), generator=g, device="cuda")
        ref = k1.scatter_levels_plain(rows[None], vals[None], t)[0]
        out = torch.empty((2, t), device="cuda")
        row = dict(site=site, level=lvl, rows=extent, M=m, T=t)
        for mode_name, mode in MODES.items():
            call = lambda: lib.k1_dense_path(rows.data_ptr(), vals.data_ptr(), out.data_ptr(), m, t, extent,
                                             mode, stream())
            err = call()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{mode_name}: cudaError {err}")
            row[f"{mode_name}_err"] = float((out - ref).abs().max())
            row[f"{mode_name}_us"] = time_us(lambda: call())
        row["k1_err"] = float((k1.scatter_levels(rows[None], vals[None], t)[0] - ref).abs().max())
        row["k1_us"] = time_us(lambda: k1.scatter_levels(rows[None], vals[None], t))
        print(json.dumps(row), flush=True)
        for key in [k for k in row if k.endswith("_us")]:
            totals.setdefault(site, {}).setdefault(key, 0.0)
            totals[site][key] += row[key]
    print("per site, sum over its dense levels (µs): " + json.dumps(totals))
    print(smi)


if __name__ == "__main__":
    main()
