"""Summarise ``train_sanity`` JSONL logs (mirror of
``tools/analyze_run.py``, the port's own copy): a markdown table of train
PSNR, DDF depth PSNR, ``s_val`` and loss at the milestone steps, the
count of ``s_val`` reversals over 25%, the PSNR trend and, with two or
more logs, a side-by-side table at their shared milestones.

Usage:
    python -m neusky_torch.tools.analyze_run run_a.jsonl [run_b.jsonl ...]
"""

from __future__ import annotations

import json
import sys

MILESTONES = (500, 1500, 5000, 10000, 15000, 20000)


def load(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return {r["step"]: r for r in recs}, recs


def summarise(path):
    by_step, recs = load(path)
    name = recs[0].get("ddf_encoding", "?") if recs else "?"
    rows = []
    for m in MILESTONES:
        r = by_step.get(m)
        if r:
            rows.append(
                f"| {m} | {r['psnr']:.2f} | {r['ddf_depth_psnr']:.2f} "
                f"| {r['s_val']:.4f} | {r['total_loss']:.3f} |"
            )
    svals = [r["s_val"] for r in recs]
    psnrs = [r["psnr"] for r in recs]
    # the s_val anneal may tick up a little (stochastic); count real reversals
    reversals = sum(
        1 for a, b in zip(svals, svals[1:]) if b > a * 1.25 and b > 0.01
    )
    print(f"\n### {path}  (ddf_encoding={name}, {len(recs)} records)")
    print("| step | train PSNR | DDF depth PSNR | s_val | loss |")
    print("|---|---|---|---|---|")
    print("\n".join(rows))
    last = recs[-1]
    print(
        f"final: step {last['step']}, PSNR {last['psnr']:.2f}, "
        f"DDF {last['ddf_depth_psnr']:.2f}, s_val {last['s_val']:.5f}"
    )
    print(
        f"s_val reversals>25%: {reversals}; "
        f"PSNR trend {psnrs[0]:.2f} → max {max(psnrs):.2f}"
    )


def compare(paths):
    """Side-by-side A/B at the shared milestone steps (e.g. DDF hash vs
    nerf)."""
    runs = []
    for p in paths:
        by_step, recs = load(p)
        runs.append((recs[0].get("ddf_encoding", p) if recs else p, by_step))
    steps = sorted(set.intersection(*(set(b) for _, b in runs)) & set(MILESTONES))
    if not steps:
        return
    print("\n### A/B comparison (shared milestones)")
    hdr = " | ".join(f"{n} psnr / ddf-psnr" for n, _ in runs)
    print(f"| step | {hdr} |")
    print("|" + "---|" * (len(runs) + 1))
    def fmt(rec, key):
        v = rec.get(key)
        return f"{v:.2f}" if isinstance(v, (int, float)) else "—"

    for s in steps:
        cells = " | ".join(
            f"{fmt(b[s], 'psnr')} / {fmt(b[s], 'ddf_depth_psnr')}" for _, b in runs
        )
        print(f"| {s} | {cells} |")


def main(argv=None) -> None:
    paths = sys.argv[1:] if argv is None else list(argv)
    for p in paths:
        summarise(p)
    if len(paths) > 1:
        compare(paths)


if __name__ == "__main__":
    main()
