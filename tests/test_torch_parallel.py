"""The multi-device path of the PyTorch port against JAX's mesh step, on the
CPU: ranks are processes over gloo (``neusky_torch.parallel.launch``),
JAX's mesh runs in this process on the virtual CPU devices of
``conftest.py``.

The config is ``test_torch_joint_slice``'s tiny joint config (stochastic
SDF table gradients, 42 light directions of which 29 are queried, the
level-set query at a strided subset of 8) with the level-set query chunked
in 100 points, so its hash lanes wrap at JAX's chunk (100, or 400 on the
2 × 2 mesh).  The batch is 4 images × 32 rays and 32 sky rays.  The port's
4-rank (``data`` × ``dirs`` = 2 × 2) and 2-rank (``data`` = 2) steps take
JAX's converted params and JAX's draws and must give JAX's
``make_train_step(mesh=...)`` loss, loss terms, metrics and gradients (read
from the step's optimizer state: an optax transformation that keeps the
gradient), at ``test_torch_joint_slice``'s tolerances.  JAX's step is
compiled once per mesh.

Then: the ``dirs`` split of ``compute_visibility`` against the unsplit one
(outputs, points queried per rank, gradients averaged over the ranks, and
a slice-only gather backward that the gradient check must catch); the
draws ``draw_step`` makes on a mesh, fed to the mesh step, against the step
drawing them itself (fused and split, with and without the fused
ground-truth pass) and, from JAX's draws, against JAX's loss; params
bitwise equal on every rank after two steps; ``Trainer(mesh=)`` on 2 ranks
(replicated init, a checkpoint that resumes in one process bit for bit);
``dryrun_multichip(4)`` on the CPU; the batch rule.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.parallel.mesh import make_train_step as j_make_train_step, replicate as j_replicate
from neusky_tpu.parallel.mesh import shard_batch as j_shard_batch

from neusky_torch.core.rays import RayBundle
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.ops import hashgrid
from neusky_torch.parallel import mesh as t_mesh
from neusky_torch.parallel.dryrun import dryrun_multichip
from neusky_torch.parallel.launch import run_ranks
from neusky_torch.tree import tree_items
from test_torch_joint_slice import PIPE, _ray_samples, tiny_joint_config
from test_torch_slice import make_batch_pair
from torch_mesh_ranks import GROUPS, variant_step
from torch_parity import (  # noqa: F401 (fixture)
    flat_jax, jax_ddf_draws, jax_scene_draws, max_rel_err, one_torch_thread, to_torch_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TESTS = Path(__file__).resolve().parent
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
STEP = 100.0
MESHES = {"2x2": ((2, 2), ("data", "dirs")), "data2": ((2,), ("data",))}


def mesh_config():
    return dataclasses.replace(tiny_joint_config(False), sdf_query_chunk=100)


def _keep_grads():
    """An optax transformation whose state after an update is the gradient
    (and whose update is zero): JAX's step then hands its gradient back."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@functools.lru_cache(maxsize=None)
def _batch_pair():
    return make_batch_pair()


@pytest.fixture(scope="module")
def batch_pair():
    return _batch_pair()


def _vis_inputs():
    _, rs, p2p = _ray_samples()
    g = np.random.default_rng(3)
    dirs = g.normal(size=(42, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    weights = {"visibility": (24, 1, 42), "expected_termination_dist": (24 * 29,), "sdf_at_termination": (24 * 8, 1)}
    return dict(rs=rs, p2p=torch.from_numpy(p2p), light_dirs=torch.from_numpy(dirs),
                weights={k: torch.from_numpy(g.uniform(0.5, 1.5, s).astype(np.float32)) for k, s in weights.items()})


def _variants(cfg_j):
    """The other mesh steps, held to the port's one-process step: the fused
    ground-truth pass, the split step, the eval-latent step."""
    cfg = to_torch_config(cfg_j)
    return {"fused_gt": dataclasses.replace(cfg, fused_ddf_gt_pass=True), "split": cfg, "eval_latent": cfg}


def _drawn_kinds(cfg_j):
    """The steps whose draws ``draw_step`` makes on a mesh: fused and
    split, each without and with the fused ground-truth pass (which the
    split step never runs, but ``draw_step`` is given the config)."""
    cfg = to_torch_config(cfg_j)
    gt = dataclasses.replace(cfg, fused_ddf_gt_pass=True)
    return {"fused": ("fused", cfg), "fused_gt": ("fused", gt), "split": ("split", cfg), "split_gt": ("split", gt)}


@functools.lru_cache(maxsize=None)
def _params_j():
    """JAX's params of :func:`mesh_config` (seed 0) with seeded noise on the
    SDF MLP's first kernel: its geometric init takes the hash features at
    zero, so the step's SDF table gradient, which the stochastic hash
    routes, would be zero."""
    def live(path, x):
        keys = [getattr(p, "key", None) for p in path]
        if keys[0] == "fields" and keys[-2:] == ["geo_0", "kernel"]:
            return x + np.random.default_rng(11).normal(scale=1e-3, size=x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(live, JModel(mesh_config()).init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _mesh_step(name):
    """JAX's mesh step ``name`` and the port's ranks on the same params,
    batch and draws (once per module)."""
    shape, names = MESHES[name]
    jb, tb = _batch_pair()
    cfg_j = mesh_config()
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    jm = JModel(cfg_j)
    jm.set_mesh(mesh)
    params_j = _params_j()
    rng = jax.random.PRNGKey(7)
    n = tb["pixel_coords"].shape[0]
    draws = jax_scene_draws(cfg_j, rng, n)
    draws["ddf"] = jax_ddf_draws(cfg_j, PIPE, rng)
    dirs = shape[1] if len(shape) == 2 else 1
    with ThreadPoolExecutor(2) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(
            run_ranks, "torch_mesh_ranks:step_rank", int(np.prod(shape)),
            dict(dirs=dirs, cfg=to_torch_config(cfg_j), pipe=to_torch_config(PIPE),
                 params_np=flat_jax(params_j), batch=tb, draws=draws, step=STEP,
                 vis=_vis_inputs() if name == "2x2" else None,
                 variants=_variants(cfg_j) if name == "data2" else None),
            paths=(TESTS,))
        # kept as a future: a failure fails the draws' tests alone
        drawn = pool.submit(
            run_ranks, "torch_mesh_ranks:drawn_rank", int(np.prod(shape)),
            dict(dirs=dirs, kinds=_drawn_kinds(cfg_j), pipe=to_torch_config(PIPE), params_np=flat_jax(params_j),
                 batch=tb, step=STEP, jax_draws=draws, jax_kind="fused"),
            paths=(TESTS,))
        opt = _keep_grads()
        step_fn = j_make_train_step(jm, PIPE, opt, mesh=mesh, donate=False)
        repl = NamedSharding(mesh, P())
        _, grads_j, aux_j = step_fn(j_replicate(params_j, mesh), j_replicate(opt.init(params_j), mesh),
                                    j_shard_batch(jb, mesh), jax.device_put(rng, repl),
                                    jax.device_put(jnp.asarray(STEP, jnp.float32), repl))
        ranks = ranks.result()
    return dict(name=name, shape=shape, n=n, aux_j=aux_j, grads_j=flat_jax(grads_j), ranks=ranks, drawn=drawn)


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_step(request):
    return _mesh_step(request.param)


def test_mesh_step_total_loss_matches_jax(mesh_step):
    want = float(mesh_step["aux_j"]["total_loss"])
    for r in mesh_step["ranks"]:
        np.testing.assert_allclose(r["total_loss"], want, rtol=LOSS_RTOL)


def test_mesh_step_every_loss_term_matches_jax(mesh_step):
    lj = mesh_step["aux_j"]["loss_dict"]
    for r in mesh_step["ranks"]:
        lt = r["loss_dict"]
        assert sorted(lj) == sorted(lt) and "sdf_level_set_visibility_loss" in lt and "sky_ray_loss" in lt
        for k in lj:
            np.testing.assert_allclose(lt[k], float(lj[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_mesh_step_metrics_are_the_global_batch(mesh_step):
    """PSNR and the foreground PSNR of the global batch (the shards' sums
    reduced), not a mean of the shards' PSNRs."""
    mj = mesh_step["aux_j"]["metrics"]
    for r in mesh_step["ranks"]:
        assert sorted(r["metrics"]) == sorted(mj) and "psnr_fg" in mj
        for k in mj:
            np.testing.assert_allclose(r["metrics"][k], float(mj[k]), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("group", GROUPS)
def test_mesh_step_group_gradients_match_jax(mesh_step, group):
    """Rank 0's gradient after the step's average over the ranks, leaf for
    leaf, the hash tables' stochastic table gradients included."""
    gj, gt = mesh_step["grads_j"], mesh_step["ranks"][0]["grads"]
    keys = [k for k in gj if k.split("/")[0].startswith(group)]
    assert keys
    if group == "fields":  # the stochastic hash's table gradient is live
        assert any("hash_table" in k and np.abs(gj[k]).max() > 0 for k in keys)
    for k in keys:
        got = gt.get(k, np.zeros_like(gj[k]))
        if np.abs(gj[k]).max() == 0:
            assert np.abs(got).max() == 0, k
            continue
        err = max_rel_err(got, gj[k])
        assert err < GRAD_REL, (k, err)


def test_each_rank_queries_its_share_of_the_visibility(mesh_step):
    """A rank queries the DDF at its rays × its share of the 29 queried
    directions: 64 × 15 or 64 × 14 on the 2 × 2 mesh, 64 × 29 on data = 2."""
    shape = mesh_step["shape"]
    n_local = mesh_step["n"] // shape[0]
    dirs = shape[1] if len(shape) == 2 else 1
    shares = [29 // dirs + (1 if j < 29 % dirs else 0) for j in range(dirs)]
    for rank, r in enumerate(mesh_step["ranks"]):
        assert r["rays"] == n_local
        assert r["queries"] == n_local * shares[rank % dirs], (rank, r["queries"])


@pytest.mark.parametrize("kind", ["fused_gt", "split", "eval_latent"])
def test_other_mesh_steps_match_one_process(kind, batch_pair):
    """On ``data`` = 2 the fused ground-truth pass (its vMF rays hashed
    after the global scene rows), the split step and the eval-latent step
    (the whole batch on every rank) give the one-process step's loss,
    gradients and updated params; every rank ends bitwise equal."""
    ranks = _mesh_step("data2")["ranks"]
    got = ranks[0]["variants"][kind]
    cfg = _variants(mesh_config())[kind]
    want = variant_step(kind, cfg, to_torch_config(PIPE), flat_jax(_params_j()), batch_pair[1], None, STEP)
    assert len({r["variants"][kind]["digest"] for r in ranks}) == 1
    np.testing.assert_allclose(got["total_loss"], want["total_loss"], rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"]) and got["grads"]
    for k, g in want["grads"].items():
        if np.abs(g).max() > 0:
            assert max_rel_err(got["grads"][k], g) < GRAD_REL, k
    for k, p in want["params"].items():
        np.testing.assert_allclose(got["params"][k], p, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["fused", "fused_gt", "split", "split_gt"])
def test_draw_steps_draws_feed_the_mesh_step_bit_for_bit(mesh_step, kind):
    """On every rank the mesh step given ``draw_step``'s draws (the global
    draws, cut to the rank's rows: what a captured rank step is fed)
    computes, bit for bit, what it computes drawing from the same generator
    state itself: every loss term, metric and the params after it."""
    for rank, r in enumerate(mesh_step["drawn"].result()):
        assert r[(kind, "fed")] == r[(kind, "self")], rank


def test_draw_steps_completion_of_jaxs_draws_gives_jaxs_mesh_loss(mesh_step):
    """JAX's global draws, completed and cut by ``draw_step`` and fed to the
    mesh step, give JAX's ``make_train_step(mesh=)`` total loss on every
    rank."""
    want = float(mesh_step["aux_j"]["total_loss"])
    for r in mesh_step["drawn"].result():
        np.testing.assert_allclose(r[("jax", "fed")]["total_loss"], want, rtol=LOSS_RTOL)


def test_params_bitwise_equal_on_every_rank_after_two_steps(mesh_step):
    digests = {r["digest_after_2"] for r in mesh_step["ranks"]}
    assert len(digests) == 1


# ---------------------------------------------------------------------------
# the dirs split of the visibility alone (run on the 2 × 2 mesh's ranks)


@pytest.fixture(scope="module")
def vis_checks():
    return [r["vis"] for r in _mesh_step("2x2")["ranks"]]


def test_dirs_split_visibility_matches_unsplit(vis_checks):
    for v in vis_checks:
        for k, want in v["plain"].items():
            np.testing.assert_allclose(v["split"][k], want, rtol=1e-5, atol=2e-6, err_msg=k)


def test_dirs_split_does_not_query_the_whole_nd(vis_checks):
    """Each rank of a dirs group of 2 queries its half of N·D (24 rays ×
    15 or 14 of 29 directions), the unsplit call all of it."""
    for rank, v in enumerate(vis_checks):
        assert v["plain_queries"] == 24 * 29
        assert v["split_queries"] == 24 * (15 if rank % 2 == 0 else 14)


def test_dirs_split_gradient_needs_the_summing_gather(vis_checks):
    """Averaged over the ranks, the split gradients (DDF and SDF field,
    through the level-set query) equal the unsplit ones; a gather whose
    backward only slices is off by the dirs size and fails this check."""
    for v in vis_checks:
        plain = v["plain_grads"]
        assert any(k.startswith("ddf_field") for k in plain) and any("hash_table" in k for k in plain)
        worst_slice = 0.0
        for k, want in plain.items():
            if np.abs(want).max() == 0:
                continue
            assert max_rel_err(v["split_grads"][k], want) < GRAD_REL, k
            worst_slice = max(worst_slice, max_rel_err(v["slice_only_grads"][k], want))
        assert worst_slice > 0.4, worst_slice


# ---------------------------------------------------------------------------
# the trainer, the dry run and the batch rule


def test_trainer_mesh_replicates_and_resumes_in_one_process(tmp_path):
    """``Trainer(mesh=)`` on a ``data`` mesh of 2: ``replicate`` makes
    params drawn from different seeds rank 0's; every rank starts from the
    same params and ends bitwise equal after 2 steps; rank 0's checkpoint
    loads into a one-process trainer bit for bit (params and Adam state)."""
    cfg = to_torch_config(tiny_joint_config(False))
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=6, width=16, height=16))
    out = tmp_path / "run"
    ranks = run_ranks("torch_mesh_ranks:trainer_rank", 2,
                      dict(cfg=cfg, pipe=to_torch_config(PIPE), scene=scene, out_dir=str(out)),
                      paths=(TESTS,))
    assert ranks[0]["noisy_digest"] != ranks[1]["noisy_digest"]
    assert ranks[1]["replicated_digest"] == ranks[0]["noisy_digest"] == ranks[0]["replicated_digest"]
    assert ranks[0]["init_digest"] == ranks[1]["init_digest"]
    assert ranks[0]["digest"] == ranks[1]["digest"] != ranks[0]["init_digest"]
    assert [h["step"] for h in ranks[0]["history"]] == [1, 2]
    assert all(np.isfinite(h["total_loss"]) for h in ranks[0]["history"])

    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig

    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    one = Trainer(TrainerConfig(max_num_iterations=100, seed=1), NeuSkyModel(cfg, device="cpu"),
                  to_torch_config(PIPE), dm, device="cpu")
    one.load(str(out))
    assert one.step == 2
    for k, t in tree_items(one.params):
        assert np.array_equal(t.detach().numpy(), ranks[0]["params"][k]), k
    want = ranks[0]["adam"]["adam"]["state"]
    got = one.optimizer.state_dict()["adam"]["state"]
    assert sorted(want) == sorted(got)
    for i in want:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[i][k], want[i][k]), (i, k)


def test_dryrun_multichip_four_ranks_on_the_cpu():
    out = dryrun_multichip(4, device="cpu", backend="gloo")
    assert out["mesh"] == {"data": 2, "dirs": 2}
    assert out["rel_err"] < 1e-3 and np.isfinite(out["total_loss"])


def test_salt_with_lanes_hashes_the_given_lanes():
    """A shard hashing lanes 25..39 draws what points 25..39 of one call
    over 40 draw, all-level and per-level; a lane count that is not the
    call's raises."""
    salt = torch.tensor(2654435761)
    lanes = torch.arange(25, 40)
    shard = hashgrid.salt_with_lanes(salt, lanes)
    assert torch.equal(hashgrid._cheap_hash_u_all(15, 4, shard), hashgrid._cheap_hash_u_all(40, 4, salt)[:, 25:])
    assert torch.equal(hashgrid._cheap_hash_u(15, 2, shard), hashgrid._cheap_hash_u(40, 2, salt)[25:])
    with pytest.raises(ValueError, match="15 lanes for 14 points"):
        hashgrid._cheap_hash_u_all(14, 4, shard)


class _StubMesh:
    """The DeviceMesh attributes ``shard_batch`` reads."""

    mesh_dim_names = ("data", "dirs")

    def __init__(self, coord, data=4):
        self.coord, self.data = coord, data

    def get_coordinate(self):
        return [self.coord, 0]

    def size(self, dim=None):
        return self.data if dim == 0 else 2


def test_shard_batch_follows_jaxs_batch_spec(batch_pair):
    """Leaves whose leading axis the data size (4) divides are cut, this
    rank keeping its quarter; ``image_indices``, ``cameras`` and scalars
    stay whole, as does a leaf of 6 rows."""
    _, tb = batch_pair
    batch = dict(tb, odd=torch.arange(6), scalar=torch.tensor(3.0))
    for coord in range(4):
        got = t_mesh.shard_batch(batch, _StubMesh(coord))
        assert torch.equal(got["pixel_coords"], tb["pixel_coords"][coord * 32:(coord + 1) * 32])
        assert torch.equal(got["sky_pixel_coords"], tb["sky_pixel_coords"][coord * 8:(coord + 1) * 8])
        assert got["image_indices"] is tb["image_indices"] and got["odd"] is batch["odd"]
        assert got["scalar"] is batch["scalar"]
        assert torch.equal(got["cameras"].camera_to_worlds, tb["cameras"].camera_to_worlds)


@pytest.mark.parametrize("rays_key", ["pixel_coords", "ray_bundle"])
def test_shard_batch_raises_when_data_does_not_divide_the_rays(batch_pair, rays_key):
    """On ``data`` = 3 the 128 scene rays do not split evenly: JAX's rule
    would leave them whole on every rank, while the model takes a rank's
    rays as an equal shard (its draws and hash lanes), so the cut raises,
    for rays given as pixels or as a ray bundle."""
    _, tb = batch_pair
    batch = {k: v for k, v in tb.items() if k != "pixel_coords"} if rays_key == "ray_bundle" else tb
    if rays_key == "ray_bundle":
        batch["ray_bundle"] = RayBundle.create(origins=torch.zeros((128, 3)), directions=torch.ones((128, 3)))
    with pytest.raises(ValueError, match="'data' size 3 does not divide the batch's 128 scene rays"):
        t_mesh.shard_batch(batch, _StubMesh(0, data=3))
    assert t_mesh.shard_batch(batch, _StubMesh(1, data=2))["image"].shape[0] == 64
