"""NeRF-OSR data preparation (mirror of ``tools/prepare_nerfosr.py``):
copy (or download and copy) the cityscapes segmentation masks into the
dataset layout, and validate a scene directory before training.

``copy-masks`` copies each split's ``cityscapes_mask/`` of an unpacked
masks archive into ``<data>/<scene>/final/<split>/cityscapes_mask`` (or
under ``<data>/Data/`` where the raw download nests the scenes);
``download-masks`` fetches and unzips the archive first; ``validate``
checks everything the NeRF-OSR dataparser
(``neusky_torch/data/dataparsers/nerfosr.py``) reads and prints a JSON
report (exit 1 when it finds a problem).

Usage:
    python -m neusky_torch.tools.prepare_nerfosr copy-masks <scene> <masks_src> <data_root>
    python -m neusky_torch.tools.prepare_nerfosr download-masks <scene> <url> <data_root>
    python -m neusky_torch.tools.prepare_nerfosr validate <scene> <data_root>
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

SPLITS = ("train", "validation", "test")


def _scene_dir(data_root: Path, scene: str) -> Path:
    """The dataparser's layout: scenes directly under the data root
    (``<data>/<scene>/final``, ``final_clean`` for trevi); the raw NeRF-OSR
    download nests them under ``Data/``, which is accepted too."""
    sub = "final_clean" if scene == "trevi" else "final"
    direct = data_root / scene / sub
    nested = data_root / "Data" / scene / sub
    return direct if direct.exists() or not nested.exists() else nested


def copy_masks(scene: str, source_base: Path, data_root: Path) -> dict:
    copied = {}
    for split in SPLITS:
        src = source_base / scene / split / "cityscapes_mask"
        if not src.exists():  # some archives name the split "val"
            src = source_base / scene / {"validation": "val"}.get(split, split) / "cityscapes_mask"
        dst = _scene_dir(data_root, scene) / split / "cityscapes_mask"
        if not src.exists():
            copied[split] = "source missing"
            continue
        dst.mkdir(parents=True, exist_ok=True)
        n = 0
        for item in src.iterdir():
            target = dst / item.name
            if item.is_dir():
                if target.exists():
                    shutil.rmtree(target)
                shutil.copytree(item, target)
            else:
                shutil.copy2(item, target)
            n += 1
        copied[split] = n
    return copied


def download_masks(scene: str, url: str, data_root: Path) -> dict:
    """Download and unzip a masks archive (``urllib``), then copy it into
    the layout."""
    import tempfile
    import urllib.request
    from zipfile import ZipFile

    with tempfile.TemporaryDirectory() as td:
        zip_path = Path(td) / url.split("/")[-1].split("?")[0]
        urllib.request.urlretrieve(url, zip_path)
        with ZipFile(zip_path) as z:
            z.extractall(td)
        return copy_masks(scene, Path(td), data_root)


def validate(scene: str, data_root: Path) -> dict:
    """Check the on-disk contract of the NeRF-OSR dataparser: per split the
    images, masks, poses and intrinsics, and the session envmaps."""
    base = _scene_dir(data_root, scene)
    report: dict = {"scene_dir": str(base), "ok": True}

    def fail(msg):
        report.setdefault("problems", []).append(msg)
        report["ok"] = False

    if not base.exists():
        fail(f"missing scene dir {base}")
        return report
    for split in SPLITS:
        d = base / split
        if not d.exists():
            fail(f"missing split dir {d}")
            continue
        rgb = sorted((d / "rgb").glob("*")) if (d / "rgb").exists() else []
        masks = (
            sorted((d / "cityscapes_mask").glob("*"))
            if (d / "cityscapes_mask").exists()
            else []
        )
        pose_dir = d / "pose"
        intr_dir = d / "intrinsics"
        poses = sorted(pose_dir.glob("*.txt")) if pose_dir.exists() else []
        intr = sorted(intr_dir.glob("*.txt")) if intr_dir.exists() else []
        report[split] = {
            "images": len(rgb),
            "masks": len(masks),
            "poses": len(poses),
            "intrinsics": len(intr),
        }
        if not rgb:
            fail(f"{split}: no rgb images")
        if len(masks) < len(rgb):
            fail(f"{split}: {len(rgb) - len(masks)} images without cityscapes masks")
        if len(poses) < len(rgb):
            fail(f"{split}: {len(rgb) - len(poses)} images without pose txt")
        if len(intr) < len(rgb):
            fail(f"{split}: {len(rgb) - len(intr)} images without intrinsics txt")
    env = base / "ENV_MAP_CC"
    if env.exists():
        sessions = [p.name for p in env.iterdir() if p.is_dir()]
        report["envmap_sessions"] = len(sessions)
    else:
        fail("missing ENV_MAP_CC/ (session holdout + relighting eval need it)")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="prepare_nerfosr", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("copy-masks")
    p.add_argument("scene"); p.add_argument("masks_src"); p.add_argument("data_root")
    p = sub.add_parser("download-masks")
    p.add_argument("scene"); p.add_argument("url"); p.add_argument("data_root")
    p = sub.add_parser("validate")
    p.add_argument("scene"); p.add_argument("data_root")
    args = ap.parse_args(argv)

    if args.cmd == "copy-masks":
        out = copy_masks(args.scene, Path(args.masks_src), Path(args.data_root))
    elif args.cmd == "download-masks":
        out = download_masks(args.scene, args.url, Path(args.data_root))
    else:
        out = validate(args.scene, Path(args.data_root))
    print(json.dumps(out, indent=1))
    if isinstance(out, dict) and out.get("ok") is False:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
