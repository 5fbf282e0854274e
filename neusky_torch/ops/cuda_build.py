"""Build the port's hand-written CUDA kernels: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, keyed by the source's hash under
``neusky_torch/_build`` (so an edit rebuilds), at first use.  Each kernel's
wrapper loads its library with ctypes."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def library_path(source: Path, stem: str) -> Path:
    """``_build/lib<stem>_<hash of the source>.so``."""
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}_{tag}.so"


def build(source: Path, stem: str, verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``source`` (no-op if its library exists).  Returns (library
    path, compiler messages — ``-Xptxas -v`` register/spill report when
    ``verbose``)."""
    out = library_path(source, stem)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr
