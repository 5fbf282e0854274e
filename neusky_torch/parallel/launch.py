"""Run a function on n ranks, one process each.

    run_ranks("pkg.module:function", n, kwargs)

starts n processes of ``python -m neusky_torch.parallel.launch``; rank r
calls ``function(rank=r, world_size=n, init_method=..., **kwargs)`` and its
return value (anything ``torch.save`` takes) comes back in rank order.
``init_method`` is a ``file://`` store in a temporary directory of the
call's own, so concurrent calls (test workers) never meet; the function
starts its process group from it (:func:`~neusky_torch.parallel.mesh.
make_mesh`).  Any rank's failure — an exception, an exit code other than
0, or the time limit — stops every rank and raises with that rank's
traceback and the tail of its output.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

_REPO = Path(__file__).resolve().parents[2]


def run_ranks(target: str, world_size: int, kwargs: Optional[dict] = None, *, timeout_s: float = 600.0,
              paths: tuple = ()) -> List:
    """See the module docstring.  ``paths`` go before the repository on each
    rank's ``PYTHONPATH`` (the module of ``target`` must import from
    there)."""
    with tempfile.TemporaryDirectory(prefix="neusky_ranks_") as tmp:
        work = Path(tmp)
        torch.save(dict(kwargs or {}), work / "kwargs.pt")
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [*map(str, paths), str(_REPO), *filter(None, [os.environ.get("PYTHONPATH")])])
        procs = []
        for r in range(world_size):
            with open(work / f"out_{r}.log", "wb") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "neusky_torch.parallel.launch", target, str(r), str(world_size), tmp],
                    stdout=out, stderr=subprocess.STDOUT, env=child_env))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
                if failed is None and time.monotonic() > deadline:
                    failed = next(r for r, p in enumerate(procs) if p.poll() is None)
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if failed is not None:
            err = work / f"error_{failed}.txt"
            log = (work / f"out_{failed}.log").read_bytes()[-4000:].decode(errors="replace")
            why = err.read_text() if err.exists() else f"exit code {procs[failed].returncode} or time limit"
            raise RuntimeError(f"rank {failed} of {world_size} ({target}) failed:\n{why}\n--- its output:\n{log}")
        return [torch.load(work / f"result_{r}.pt", weights_only=False) for r in range(world_size)]


def _main(target: str, rank: int, world_size: int, tmp: str) -> None:
    work = Path(tmp)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        kwargs = torch.load(work / "kwargs.pt", weights_only=False)
        out = fn(rank=rank, world_size=world_size, init_method=f"file://{work / 'store'}", **kwargs)
        torch.save(out, work / f"result_{rank}.tmp")
        os.replace(work / f"result_{rank}.tmp", work / f"result_{rank}.pt")
    except BaseException:
        (work / f"error_{rank}.txt").write_text(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)  # the other ranks may wait in a collective: no clean shutdown
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
