"""The port's C++ batch sampler (``neusky_torch/data/native_sampler.py`` over
its copy of the C++ source) against the JAX package's binding, bit for bit
from the same seed: synchronous batches, sky rays, the prefetch queue and a
reseeded ``DataManager``; the ``DataManager`` hooks (``next_train`` with
``use_native_sampler=True``); and the refusal to run without a build.

The port's prefetch thread draws each batch's sky rays after its pixels
(JAX's draws them on the caller's thread, racing the prefetch thread), so a
live ``next_train`` gives the synchronous stream (batch 0, sky 0, batch 1,
sky 1, ...) draw for draw at any queue depth and any pace of its caller."""

import dataclasses
import itertools
import time

import numpy as np
import pytest
import torch

from neusky_tpu.data import datamanager as j_dm
from neusky_tpu.data.native_sampler import NativeBatchSampler as JSampler, native_available
from neusky_tpu.data.pixel_sampler import PixelSamplerConfig as JPSConfig
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JSceneConfig, generate_synthetic_scene as j_scene

from neusky_torch.data import datamanager as t_dm
from neusky_torch.data import native_sampler
from neusky_torch.data.native_sampler import NativeBatchSampler as TSampler
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene

U, R, SKY = 3, 16, 24


@pytest.fixture(scope="module")
def data():
    """Three 8×8 images: top rows sky, a transient hole in image 0."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(3, 8, 8, 3)).astype(np.float32)
    masks = np.zeros((3, 8, 8, 4), np.float32)
    masks[..., 0] = 1.0
    masks[:, :2, :, 3] = 1.0
    masks[:, 2:, :, 1] = 1.0
    masks[0, 4, 4, 0] = 0.0
    assert native_available()  # JAX's binding is built with g++ too
    return images, masks


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_sample_batch_and_sky_equal_jax(data, seed):
    t, j = TSampler(*data, seed=seed), JSampler(*data, seed=seed)
    assert t.has_sky and j.has_sky
    for _ in range(3):
        _equal(t.sample_batch(U, R), j.sample_batch(U, R))
        _equal(t.sample_sky(SKY), j.sample_sky(SKY))
    t.close()


def test_prefetch_queue_equals_jax(data):
    t, j = TSampler(*data, seed=5), JSampler(*data, seed=5)
    t.start_prefetch(U, R, queue_depth=2)
    j.start_prefetch(U, R, queue_depth=2)
    for _ in range(6):
        _equal(t.next_batch(), j.next_batch())
    t.close()
    del j


def test_sampler_draws_valid_pixels(data):
    images, masks = data
    t = TSampler(images, masks, seed=3)
    rows, pixels, rgb, mask = t.sample_batch(U, R)
    cam = np.repeat(rows, R)
    np.testing.assert_array_equal(rgb, images.reshape(3, -1, 3)[cam, pixels])
    np.testing.assert_array_equal(mask, masks.reshape(3, -1, 4)[cam, pixels])
    assert (mask[:, 0] > 0.5).all()
    rows, pixels = t.sample_sky(64)
    assert (masks.reshape(3, -1, 4)[rows, pixels, 3] > 0.5).all()


def _scene():
    return generate_synthetic_scene(SyntheticSceneConfig(num_cameras=4, width=16, height=16))


def _dms(seed=0):
    """The port's and JAX's DataManagers with the native sampler on the
    same synthetic scene (equal bit for bit between the packages)."""
    ps = dict(images_per_batch=3, rays_per_image=8)
    scene = _scene()
    t = t_dm.DataManager(t_dm.DataManagerConfig(pixel_sampler=PixelSamplerConfig(**ps), num_sky_rays=SKY, seed=seed,
                                                use_native_sampler=True, native_queue_depth=2),
                         scene["cameras"], scene["images"], scene["masks"], device="cpu")
    js = j_scene(JSceneConfig(num_cameras=4, width=16, height=16))
    j = j_dm.DataManager(j_dm.DataManagerConfig(pixel_sampler=JPSConfig(**ps), num_sky_rays=SKY, seed=seed,
                                                use_native_sampler=True, native_queue_depth=2),
                         js["cameras"], js["images"], js["masks"])
    assert j._native is not None and np.array_equal(scene["images"], js["images"])
    return t, j


def test_datamanager_config_mirrors_jax():
    assert [f.name for f in dataclasses.fields(t_dm.DataManagerConfig)] == [
        f.name for f in dataclasses.fields(j_dm.DataManagerConfig)]
    assert t_dm.DataManagerConfig().native_queue_depth == j_dm.DataManagerConfig().native_queue_depth


def test_reseed_rebuilds_the_native_stream_as_jax(data):
    """After ``reseed`` both packages prefetch from the same folded seed:
    the first batch is JAX's prefetched one, and the port's stream goes on
    as JAX's synchronous sampler from that seed, batch and sky in turn."""
    t, j = _dms(seed=2)
    first = t._native
    t.reseed(40)
    j.reseed(40)
    assert t._native is not first and first._handle is None  # the old sampler was closed
    folded = int(np.random.SeedSequence([2, 40]).generate_state(1)[0])
    sync = JSampler(np.asarray(t.train_images), np.asarray(t.train_masks), seed=folded)
    got = t._native.next_batch()
    _equal(got[:4], j._native.next_batch())
    for i in range(3):
        if i:
            got = t._native.next_batch()
        _equal(got, sync.sample_batch(3, 8) + sync.sample_sky(SKY))
    assert t.train_sampler.rng.bit_generator.state == j.train_sampler.rng.bit_generator.state


def test_next_train_native_hooks_equal_jax(monkeypatch):
    """The same native draws through both ``next_train``s: the port's
    batch on its device equals JAX's host batch key for key, with the
    numpy path's keys and index dtypes."""
    t, j = _dms()
    canned = JSampler(*(np.asarray(x) for x in (t.train_images, t.train_masks)), seed=9)
    draws = [canned.sample_batch(3, 8) for _ in range(2)]
    skies = [canned.sample_sky(SKY) for _ in range(2)]
    it_t = iter([d + s for d, s in zip(draws, skies)])  # the port's batches carry their sky
    monkeypatch.setattr(t._native, "next_batch", lambda: next(it_t))
    it_b, it_s = iter(draws), iter(skies)
    monkeypatch.setattr(j._native, "next_batch", lambda: next(it_b))
    monkeypatch.setattr(j._native, "sample_sky", lambda n: next(it_s))
    numpy_keys = sorted(t_dm.DataManager(t_dm.DataManagerConfig(pixel_sampler=PixelSamplerConfig(3, 8)),
                                         _scene()["cameras"], t.train_images, t.train_masks, device="cpu")
                        .next_train(0))
    for step in range(2):
        got, want = t.next_train(step), j.next_train(step)
        assert sorted(got) == numpy_keys == sorted(want)
        for k, v in want.items():
            if k == "cameras":
                continue
            assert got[k].dtype == (torch.int64 if k in ("cam_idx", "image_indices", "ray_image_idx", "sky_cam_idx")
                                    else torch.float32), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_next_train_native_live_batches_are_valid():
    t, _ = _dms()
    imgs, msks = t.train_images.reshape(4, -1, 3), t.train_masks.reshape(4, -1, 4)
    for step in range(4):
        b = t.next_train(step)
        cam = b["cam_idx"].numpy()
        pix = ((b["pixel_coords"][:, 0] - 0.5) * 16 + (b["pixel_coords"][:, 1] - 0.5)).long().numpy()
        np.testing.assert_array_equal(b["image"].numpy(), imgs[cam, pix])
        np.testing.assert_array_equal(b["mask"].numpy(), msks[cam, pix])
        sky = ((b["sky_pixel_coords"][:, 0] - 0.5) * 16 + (b["sky_pixel_coords"][:, 1] - 0.5)).long().numpy()
        assert (msks[b["sky_cam_idx"].numpy(), sky, 3] > 0.5).all()
        assert b["pixel_coords"].shape == (24, 2) and b["sky_cam_idx"].shape == (SKY,)


@pytest.mark.parametrize("pause_s", [0.0, 2e-4], ids=["no_pause", "short_sleep"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetched_stream_equals_the_synchronous_stream(depth, pause_s):
    """200 live ``next_train`` calls (the caller pausing after every third
    call when ``pause_s``, so the queue is found both full and empty) give
    the stream of a sampler of the same seed drawn synchronously: batch 0,
    sky 0, batch 1, sky 1, ..."""
    scene = _scene()
    dm = t_dm.DataManager(t_dm.DataManagerConfig(pixel_sampler=PixelSamplerConfig(3, 8), num_sky_rays=SKY, seed=11,
                                                 use_native_sampler=True, native_queue_depth=depth),
                          scene["cameras"], scene["images"], scene["masks"], device="cpu")
    sync = TSampler(scene["images"], scene["masks"], seed=11)
    coords = dm._native_pixel_coords
    pauses = itertools.cycle([0.0, 0.0, pause_s])
    for step in range(200):
        got = dm.next_train(step)
        rows, pixels, rgb, mask = sync.sample_batch(3, 8)
        sky_rows, sky_pixels = sync.sample_sky(SKY)
        for key, want in (("image_indices", rows), ("pixel_coords", coords(pixels)), ("image", rgb),
                          ("mask", mask), ("sky_cam_idx", sky_rows), ("sky_pixel_coords", coords(sky_pixels))):
            np.testing.assert_array_equal(got[key].numpy(), want, err_msg=f"call {step}: {key}")
        time.sleep(next(pauses))
    dm._native.close()
    sync.close()


@pytest.fixture
def unbuilt(tmp_path, monkeypatch):
    """The sampler as if never built: an empty build directory, nothing
    loaded."""
    monkeypatch.setattr(native_sampler, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_sampler, "_lib", None)
    return tmp_path


def test_native_sampler_raises_without_a_compiler(unbuilt, monkeypatch, data):
    monkeypatch.setattr(native_sampler.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        TSampler(*data)
    scene = _scene()
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        t_dm.DataManager(t_dm.DataManagerConfig(use_native_sampler=True), scene["cameras"], scene["images"],
                         scene["masks"], device="cpu")


def test_native_sampler_raises_when_the_build_fails(unbuilt, monkeypatch, data):
    bad = unbuilt / "batch_sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_sampler, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building the native batch sampler failed"):
        TSampler(*data)
    assert not list((unbuilt / "_build").glob("*.so"))


def test_native_build_writes_only_its_library(unbuilt):
    """A build from nothing writes one file, the library, into the build
    directory (``neusky_torch/_build/`` unless moved, as here)."""
    path = native_sampler.build()
    assert path.parent == unbuilt / "_build" and path.suffix == ".so"
    assert sorted(p.relative_to(unbuilt) for p in unbuilt.rglob("*")) == [path.parent.relative_to(unbuilt),
                                                                          path.relative_to(unbuilt)]
