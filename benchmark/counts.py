"""The yardstick's arithmetic: rays counted a step, the K1 kernel's least
time a step, and the card's peaks.  Copied from the program
(``engine/trainer.py::count_rays``, ``chip_smoke.py::k1_sites`` and
``k1_bound_ms``) so that a change to the program cannot move it; it reads
the reference's configuration classes only."""

from __future__ import annotations

from benchmark.reference.plain.models.neusky import visibility_query_directions
from benchmark.reference.plain.sampling.illumination import IcosahedronSampler

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (whatever
# precision runs, so that no change of precision can read over 100%),
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = 989e12
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def rays_per_step(model_cfg, pipeline_cfg, scene_rays: int, sky_rays: int) -> int:
    """The training loop's rule: the scene rays, plus the DDF-fit rays when
    the visibility field is fitted, plus the sky rays (1,024 + 1,024 + 256
    = 2,304 for the canonical joint step)."""
    n = scene_rays
    if model_cfg.fit_visibility_field and model_cfg.ddf is not None:
        s = pipeline_cfg.visibility_train_sampler
        n += s.num_samples_on_sphere * s.num_rays_per_sample
    return n + sky_rays


def k1_bound_ms(levels: int, m: int, t: int) -> float:
    """Least time of one K1 launch: read the index (4 B) and two fp32
    values per update, write the L × 2T fp32 output once; 2 fp32 adds per
    update."""
    bytes_ms = (12.0 * levels * m + 8.0 * levels * t) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * levels * m / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms)


def _rows_per_point(stochastic: bool) -> int:
    return 1 if stochastic else 8


def k1_sites(model_cfg, pipeline_cfg, n_rays: int):
    """The step's K1 launches, one per hash-grid encode that a loss
    differentiates: (name, hash config, points, rows per point).  Scene:
    each proposal field, the SDF ``field_outputs``, the density-grid SDF;
    the level-set SDF query over the strided subset of the visibility's
    termination points (one launch per chunk of ``sdf_query_chunk``); with
    the DDF fit, the SDF of the ground-truth pass (unless fused) and the
    DDF-fit SDF query (exact)."""
    prop = model_cfg.proposal
    sh = model_cfg.sdf_field.hash
    sdf_rows = _rows_per_point(model_cfg.sdf_field.stochastic_table_grads)
    fit = model_cfg.ddf is not None and model_cfg.fit_visibility_field
    s = pipeline_cfg.visibility_train_sampler
    n_vmf = s.num_samples_on_sphere * s.num_rays_per_sample if fit else 0
    fused = fit and model_cfg.fused_ddf_gt_pass and not pipeline_cfg.stop_sdf_gradients
    n_pass = n_rays + n_vmf if fused else n_rays
    sites = [(f"proposal_field_{i}", pf.hash, n_pass * prop.num_proposal_samples[i],
              _rows_per_point(pf.stochastic_table_grad))
             for i, pf in enumerate(model_cfg.proposal_fields)]
    sites.append(("sdf_field_outputs", sh, n_pass * prop.num_final_samples, sdf_rows))
    if model_cfg.losses.hashgrid_density:
        sites.append(("density_grid_sdf", sh, model_cfg.losses.hashgrid_density_grid_resolution ** 3, sdf_rows))
    if model_cfg.ddf is None:
        return sites
    if model_cfg.use_visibility and model_cfg.losses.sdf_level_set_visibility:
        d = visibility_query_directions(
            model_cfg, IcosahedronSampler(model_cfg.num_illumination_directions).actual_num_directions)
        sub = model_cfg.sdf_level_set_subset
        m = n_rays * (sub if sub and sub < d else d)
        chunk = model_cfg.sdf_query_chunk or m
        sites += [("level_set_sdf", sh, min(chunk, m - start), sdf_rows) for start in range(0, m, chunk)]
    if fit:
        if not fused:
            sites.append(("ddf_gt_sdf_field_outputs", sh, n_vmf * prop.num_final_samples, sdf_rows))
        sites.append(("ddf_fit_sdf", sh, n_vmf, 8))
    return sites


def k1_step_bound_ms(model_cfg, pipeline_cfg, n_rays: int) -> float:
    """The least time of all of a step's K1 launches."""
    return sum(k1_bound_ms(h.num_levels, pts * rows, h.table_size)
               for _, h, pts, rows in k1_sites(model_cfg, pipeline_cfg, n_rays))
