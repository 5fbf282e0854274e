"""The port's data path against the JAX package, on the CPU: pose
normalisation, the NeRF-OSR and Blender-synthetic parsers, the dataset's
images and 4-channel masks, the fixture writers, and the PNG decoder
against Pillow.  Parsers and datasets read the JAX package's own
(Pillow-written) fixtures; every comparison is bit for bit."""

import json
import shutil
import struct
import sys
import zlib
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from neusky_torch.data import fixtures as t_fix
from neusky_torch.data.dataparsers import custom_synthetic as t_cs
from neusky_torch.data.dataparsers import nerfosr as t_osr
from neusky_torch.data.dataparsers import pose_utils as t_pose
from neusky_torch.data.dataset import NeuSkyDataset as TDataset
from neusky_torch.utils import viz
from neusky_tpu.data import fixtures as j_fix
from neusky_tpu.data.dataparsers import custom_synthetic as j_cs
from neusky_tpu.data.dataparsers import nerfosr as j_osr
from neusky_tpu.data.dataparsers import pose_utils as j_pose
from neusky_tpu.data.dataset import NeuSkyDataset as JDataset

CAMERA_ARRAYS = ("camera_to_worlds", "fx", "fy", "cx", "cy")


def assert_cameras_equal(t, j):
    for k in CAMERA_ARRAYS:
        got, want = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert (t.width, t.height, t.camera_type) == (j.width, j.height, j.camera_type)


def assert_outputs_equal(t, j, skip=("cameras", "config")):
    assert sorted(t) == sorted(j)
    assert_cameras_equal(t["cameras"], j["cameras"])
    for k in t:
        if k in skip:
            continue
        if isinstance(j[k], np.ndarray):
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
        else:
            assert t[k] == j[k], k


# ---------------------------------------------------------------------------
# pose_utils


def _random_poses(seed: int, n: int = 7) -> np.ndarray:
    g = np.random.default_rng(seed)
    q, _ = np.linalg.qr(g.normal(size=(n, 3, 3)))
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = g.normal(size=(n, 3)) * 2.0
    return poses


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("method,center", [("up", "poses"), ("up", "focus"), ("up", "none"), ("none", "poses")])
def test_auto_orient_and_center_poses_match_jax(seed, method, center):
    poses = _random_poses(seed)
    got, t_tf = t_pose.auto_orient_and_center_poses(poses.copy(), method, center)
    want, j_tf = j_pose.auto_orient_and_center_poses(poses.copy(), method, center)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(t_tf, j_tf)


@pytest.mark.parametrize("a", [[0.2, -0.3, 0.9], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.95, 0.1, 0.0]])
def test_rotation_between_matches_jax(a):
    """General, parallel and opposite vectors (both perpendicular axes)."""
    a = np.asarray(a, np.float32)
    for b in (np.array([0.0, 0.0, 1.0]), -a.astype(np.float64)):
        assert np.array_equal(t_pose.rotation_between(a, b), j_pose.rotation_between(a, b))


def test_unknown_orientation_method_raises():
    with pytest.raises(ValueError):
        t_pose.auto_orient_and_center_poses(_random_poses(0), "pca")


# ---------------------------------------------------------------------------
# NeRF-OSR: parser and dataset on JAX's fixture


def _resize_view(scene_dir: Path, split: str, stem: str, w: int, h: int, cx: float, cy: float):
    """Make one view of a fixture larger (w × h, principal point cx, cy),
    written with Pillow, so crop and pad have work to do."""
    for sub in ("rgb", "cityscapes_mask", "mask"):
        p = scene_dir / split / sub / f"{stem}.png"
        if p.exists():
            img = np.asarray(Image.open(p))
            big = np.pad(img, ((0, h - img.shape[0]), (0, w - img.shape[1]), (0, 0)), mode="edge")
            Image.fromarray(big).save(p)
    k = np.asarray([float(x) for x in (scene_dir / split / "intrinsics" / f"{stem}.txt").read_text().split()])
    k[2], k[6] = cx, cy
    (scene_dir / split / "intrinsics" / f"{stem}.txt").write_text(" ".join(str(x) for x in k))


@pytest.fixture(scope="module")
def osr_root(tmp_path_factory):
    """JAX's NeRF-OSR fixture (2 sessions, 24 × 16), one train and one test
    view enlarged to 30 × 20, and out-of-view-frustum object masks on two
    train views."""
    root = tmp_path_factory.mktemp("osr")
    j_fix.make_nerfosr_fixture(root, num_sessions=2, train_per_session=2, test_per_session=2, width=24, height=16)
    scene_dir = root / "lk2" / "final"
    _resize_view(scene_dir, "train", "session_A_0001", 30, 20, 15.0, 10.0)
    _resize_view(scene_dir, "test", "session_B_0003", 30, 20, 15.0, 10.0)
    ofd = scene_dir / "train" / "out_of_view_frustum_objects_mask"
    ofd.mkdir()
    g = np.random.default_rng(3)
    for stem in ("session_A_0000", "session_B_0002"):
        m = (g.uniform(size=(16, 24)) < 0.2).astype(np.uint8) * 255
        Image.fromarray(np.stack([m] * 3, -1)).save(ofd / f"{stem}.png")
    return root


def _osr_cfgs(root, **kw):
    kw = {"data": str(root), "session_holdout_indices": (0, 0), **kw}
    return t_osr.NeRFOSRDataparserConfig(**kw), j_osr.NeRFOSRDataparserConfig(**kw)


@pytest.mark.parametrize("split", ["train", "validation", "val", "test"])
@pytest.mark.parametrize("resize", ["crop", "pad", "none"])
def test_parse_nerfosr_scene_matches_jax(osr_root, split, resize):
    kw = {"crop": {}, "pad": {"crop_to_equal_size": False, "pad_to_equal_size": True},
          "none": {"crop_to_equal_size": False}}[resize]
    t_cfg, j_cfg = _osr_cfgs(osr_root, **kw)
    got, want = t_osr.parse_nerfosr_scene(t_cfg, split), j_osr.parse_nerfosr_scene(j_cfg, split)
    assert_outputs_equal(got, want)
    assert got["config"] == t_cfg
    if split == "test":
        assert sorted(got["test_eval_mask_dict"]) == [1, 3]
    if split == "train":
        assert sum(m is not None for m in got["out_of_view_frustum_objects_masks"]) == 2
    assert got["width_height"] == {"crop": [24, 16], "pad": [30, 20], "none": got["width_height"]}[resize]


def test_parse_nerfosr_scene_original_masks_match_jax(osr_root):
    t_cfg, j_cfg = _osr_cfgs(osr_root, mask_source="original", mask_out_of_view_frustum_objects=False)
    assert_outputs_equal(t_osr.parse_nerfosr_scene(t_cfg, "test"), j_osr.parse_nerfosr_scene(j_cfg, "test"))


@pytest.mark.parametrize("case", ["holdout_length", "crop_and_pad", "holdout_is_eval", "no_cityscapes"])
def test_parse_nerfosr_scene_errors_match_jax(osr_root, tmp_path, case):
    kw, split = {}, "validation"
    if case == "holdout_length":
        kw = {"session_holdout_indices": (0, 0, 0)}
    elif case == "crop_and_pad":
        kw = {"pad_to_equal_size": True}
    elif case == "holdout_is_eval":  # image 1 of session A has an eval mask
        kw, split = {"session_holdout_indices": (1, 0)}, "test"
    else:
        shutil.copytree(osr_root, tmp_path / "c")
        shutil.rmtree(tmp_path / "c" / "lk2" / "final" / "validation" / "cityscapes_mask")
        kw = {"data": str(tmp_path / "c")}
    t_cfg, j_cfg = _osr_cfgs(osr_root, **kw)
    exc = FileNotFoundError if case == "no_cityscapes" else ValueError
    with pytest.raises(exc) as want:
        j_osr.parse_nerfosr_scene(j_cfg, split)
    with pytest.raises(exc) as got:
        t_osr.parse_nerfosr_scene(t_cfg, split)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("holdout", ["0,1", "0, 1,", (0, 1), [0, 1]])
def test_parse_holdout_arg_matches_jax(holdout):
    assert t_osr.parse_holdout_arg(holdout) == j_osr.parse_holdout_arg(holdout) == (0, 1)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("resize,downscale", [("crop", 1), ("crop", 2), ("pad", 1), ("pad", 2)])
def test_dataset_load_matches_jax(osr_root, split, resize, downscale):
    """Images, the [static, fg, ground, sky] masks (object masks on the
    train split, eval masks on the test split) and the cameras, cropped or
    padded to one size and downscaled."""
    kw = {} if resize == "crop" else {"crop_to_equal_size": False, "pad_to_equal_size": True}
    t_cfg, j_cfg = _osr_cfgs(osr_root, **kw)
    got = TDataset(t_osr.parse_nerfosr_scene(t_cfg, split), split, downscale).load()
    want = JDataset(j_osr.parse_nerfosr_scene(j_cfg, split), split, downscale).load()
    for k in ("images", "masks"):
        assert got[k].dtype == want[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    assert_cameras_equal(got["cameras"], want["cameras"])
    h, w = got["images"].shape[1:3]
    assert (got["cameras"].width, got["cameras"].height) == (w, h)
    for ch in range(4):  # every channel carries both values
        assert 0 < got["masks"][..., ch].mean() < 1, ch


@pytest.mark.parametrize("veg,sidewalk", [(True, True), (False, False)])
def test_build_mask_from_semantics_matches_jax(veg, sidewalk):
    from neusky_torch.data.dataset import build_mask_from_semantics as t_build
    from neusky_tpu.data.dataset import build_mask_from_semantics as j_build

    g = np.random.default_rng(0)
    colours = np.asarray(t_osr.CITYSCAPE_CLASSES["colours"], np.uint8)
    sem = colours[g.integers(0, len(colours), (12, 10))]
    obj = g.uniform(size=(12, 10)).astype(np.float32)
    for kw in ({}, {"object_mask": obj}, {"test_eval_mask": (obj > 0.3).astype(np.float32)}):
        got = t_build(sem, veg, sidewalk, **kw)
        assert np.array_equal(got, j_build(sem, veg, sidewalk, **kw))


# ---------------------------------------------------------------------------
# Blender-synthetic


def _write_ply(path: Path, pts: np.ndarray, binary: bool):
    head = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} 1.0\nelement vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        if binary:
            rec = np.zeros(len(pts), np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
                                               ("green", "u1"), ("blue", "u1")]))
            rec["x"], rec["y"], rec["z"] = pts.T
            rec["red"] = 200
            f.write(rec.tobytes())
        else:
            f.write("".join(f"{x} {y} {z} 200 100 50\n" for x, y, z in pts).encode("ascii"))


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    """JAX's Blender fixture under ``<tmp>/scenes/scene``, with GT albedo
    EXR files for the train split, one GT HDRI in ``<tmp>/hdris`` and a
    binary and an ASCII PLY cloud."""
    base = tmp_path_factory.mktemp("blender")
    root = j_fix.make_blender_fixture(base / "scenes" / "scene", width=24, height=16)
    (root / "train" / "albedo").mkdir()
    for i in range(4):
        (root / "train" / "albedo" / f"{i:04d}.exr").write_bytes(b"")
    (root / "train" / "depth").mkdir()  # incomplete layer: dropped
    (root / "train" / "depth" / "0000.exr").write_bytes(b"")
    (base / "hdris").mkdir()
    (base / "hdris" / "sky_1.exr").write_bytes(b"")
    pts = np.random.default_rng(5).normal(size=(200, 3)).astype(np.float32) * [1.0, 2.0, 0.5] + [0.3, -0.2, 1.0]
    _write_ply(root / "points_bin.ply", pts, True)
    _write_ply(root / "points_ascii.ply", pts, False)
    return root


@pytest.mark.parametrize("split", ["train", "val", "validation", "test"])
@pytest.mark.parametrize("sfm", ["poses", "sfm_binary", "sfm_ascii", "sfm_missing"])
def test_parse_custom_synthetic_scene_matches_jax(blender_root, split, sfm):
    kw = {"data": str(blender_root)}
    if sfm != "poses":
        kw.update(center_method_sfm=True, points3d_filename={"sfm_binary": "points_bin.ply", "sfm_ascii":
                  "points_ascii.ply", "sfm_missing": "absent.ply"}[sfm])
    t_cfg, j_cfg = t_cs.CustomSyntheticDataparserConfig(**kw), j_cs.CustomSyntheticDataparserConfig(**kw)
    got, want = t_cs.parse_custom_synthetic_scene(t_cfg, split), j_cs.parse_custom_synthetic_scene(j_cfg, split)
    assert_outputs_equal(got, want)
    assert got["width_height"] == [24, 16]
    if split in ("train", "test"):  # test has no frames: the train split
        assert "gt_albedo_filenames" in got and "gt_depth_filenames" not in got
        assert [e is not None for e in got["gt_envmap_info"]] == [False, True, False, True]


@pytest.mark.parametrize("name", ["points_bin.ply", "points_ascii.ply", "absent.ply"])
def test_load_ply_points_matches_jax(blender_root, name):
    got, want = t_cs.load_ply_points(blender_root / name), j_cs.load_ply_points(blender_root / name)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)
        center, scale = t_cs.compute_sfm_centering(got)
        j_center, j_scale = j_cs.compute_sfm_centering(want)
        assert np.array_equal(center, j_center) and scale == j_scale


def test_blender_dataset_load_matches_jax(blender_root):
    """No segmentation: all-static masks, no ground, no sky."""
    t_cfg = t_cs.CustomSyntheticDataparserConfig(data=str(blender_root))
    j_cfg = j_cs.CustomSyntheticDataparserConfig(data=str(blender_root))
    got = TDataset(t_cs.parse_custom_synthetic_scene(t_cfg, "train"), "train", 2).load()
    want = JDataset(j_cs.parse_custom_synthetic_scene(j_cfg, "train"), "train", 2).load()
    assert np.array_equal(got["images"], want["images"]) and np.array_equal(got["masks"], want["masks"])
    assert_cameras_equal(got["cameras"], want["cameras"])


# ---------------------------------------------------------------------------
# PNG decoding and the fixture writers


def _row_filters(path) -> Counter:
    chunks = viz._png_chunks(Path(path).read_bytes(), path)
    hdr = viz.png_header(path)
    raw = zlib.decompress(b"".join(d for k, d in chunks if k == b"IDAT"))
    stride = hdr["width"] * viz._PNG_CHANNELS[hdr["colour_type"]] + 1
    return Counter(raw[i * stride] for i in range(hdr["height"]))


def _test_image(h=29, w=41, seed=0) -> np.ndarray:
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5) % 256, (y * 7) % 256, ((x + y) * 3) % 256], -1)
    return (base + g.integers(0, 40, base.shape)).astype(np.uint8)


def test_load_png_matches_pillow_on_every_colour_type(tmp_path):
    """Colour types 0, 2, 3 (indices, as Pillow gives them), 4 and 6,
    written by Pillow with ``optimize=True``: its adaptive filters use all
    five row filters across the files."""
    rgb = _test_image()
    images = {
        "L": Image.fromarray(rgb[..., 0]), "RGB": Image.fromarray(rgb),
        "LA": Image.fromarray(rgb[..., :2], "LA"), "RGBA": Image.fromarray(np.dstack([rgb, rgb[..., :1]])),
        "P": Image.fromarray(rgb).quantize(64),
    }
    filters = Counter()
    for mode, im in images.items():
        p = tmp_path / f"{mode}.png"
        im.save(p, optimize=True)
        want = np.asarray(Image.open(p))
        assert Image.open(p).mode == mode
        got = viz.load_png(p)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want), mode
        assert np.array_equal(viz.load_image(p), want)
        assert viz.image_size(p) == (41, 29)
        filters += _row_filters(p)
    assert set(filters) == {0, 1, 2, 3, 4}, filters


def _patch_ihdr(path: Path, offset: int, value: int):
    """Set one IHDR byte (8 bit depth, 12 interlace) and fix its CRC."""
    data = bytearray(path.read_bytes())
    ihdr = bytearray(data[16:29])
    ihdr[offset] = value
    data[16:29] = ihdr
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr)) & 0xFFFFFFFF)
    path.write_bytes(bytes(data))


def test_load_png_refuses_16_bit_and_interlaced(tmp_path):
    p16 = tmp_path / "deep.png"
    Image.fromarray(_test_image()[..., 0].astype(np.uint16) * 200).save(p16)
    with pytest.raises(ValueError, match=r"deep\.png: 16-bit PNG"):
        viz.load_png(p16)
    pi = tmp_path / "laced.png"
    viz.save_png_u8(pi, _test_image())
    _patch_ihdr(pi, 12, 1)
    with pytest.raises(ValueError, match=r"laced\.png: interlaced"):
        viz.load_png(pi)


def test_load_png_refuses_a_corrupt_chunk(tmp_path):
    p = tmp_path / "bad.png"
    viz.save_png_u8(p, _test_image())
    data = bytearray(p.read_bytes())
    data[45] ^= 0xFF  # inside IDAT's data
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"bad\.png: corrupt PNG chunk"):
        viz.load_png(p)


def test_save_png_u8_round_trips_through_pillow(tmp_path):
    rgb = _test_image()
    for arr in (rgb, rgb[..., 0], np.dstack([rgb, rgb[..., :1]]), rgb[..., :1]):
        p = tmp_path / "x.png"
        viz.save_png_u8(p, arr)
        assert np.array_equal(np.asarray(Image.open(p)), np.squeeze(arr, -1) if arr.shape[-1] == 1 else arr)
    with pytest.raises(ValueError, match="uint8"):
        viz.save_png_u8(p, rgb.astype(np.float32))


def test_load_image_decodes_jpeg_through_pillow_and_says_so_without_it(tmp_path, monkeypatch):
    p = tmp_path / "photo.jpg"
    Image.fromarray(_test_image()).save(p, quality=90)
    assert np.array_equal(viz.load_image(p), np.asarray(Image.open(p)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"photo\.jpg is not a PNG; decoding it needs Pillow"):
        viz.load_image(p)


def _tree_files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_nerfosr_fixture_writer_matches_jax(tmp_path):
    """Same files; PNGs decode to the arrays of JAX's (Pillow-written)
    files; intrinsics and poses are the same text."""
    t_root = t_fix.make_nerfosr_fixture(tmp_path / "t", num_sessions=2, train_per_session=2, width=24, height=16,
                                        seed=4)
    j_root = j_fix.make_nerfosr_fixture(tmp_path / "j", num_sessions=2, train_per_session=2, width=24, height=16,
                                        seed=4)
    files = _tree_files(t_root)
    assert files == _tree_files(j_root) and len(files) > 30
    for rel in files:
        if rel.suffix == ".png":
            assert np.array_equal(viz.load_png(t_root / rel), np.asarray(Image.open(j_root / rel))), rel
        else:
            assert (t_root / rel).read_text() == (j_root / rel).read_text(), rel


def test_blender_fixture_writer_matches_jax(tmp_path):
    t_root = t_fix.make_blender_fixture(tmp_path / "t", seed=2)
    j_root = j_fix.make_blender_fixture(tmp_path / "j", seed=2)
    files = _tree_files(t_root)
    assert files == _tree_files(j_root)
    assert (t_root / "transforms.json").read_text() == (j_root / "transforms.json").read_text()
    assert len(json.loads((t_root / "transforms.json").read_text())["frames"]) == 6
    for rel in files:
        if rel.suffix == ".png":
            assert np.array_equal(viz.load_png(t_root / rel), np.asarray(Image.open(j_root / rel))), rel
