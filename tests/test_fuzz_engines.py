"""Differential geometry fuzz: all search engines agree on random configs.

The per-engine parity tests pin a handful of geometries; gate/pad bugs
live in the ones nobody pinned (odd boxes, asymmetric xr/yr, overshooting
fractional steps, small ring counts).  Here seeded-random configurations
sweep the geometry space and every engine whose gate admits the config
must produce the same winners as the exact-semantics gather engine
(modulo bf16 tie-swaps with tiny score gaps).

Reference analog: the CUDA core accepts arbitrary img_dim/ring_num/grid
(cuda/gpu_aln_common.h:48-54) with one code path; this library has four
engines and per-engine gates, so agreement must be *tested* across
geometry.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu import AlignConfig, AlignParams
from cryo_ralib_tpu.ops.search import (prepare_ref_spectra,
                                       rotational_shift_search,
                                       rotational_shift_search_mm)
from cryo_ralib_tpu.ops.template_search import (template_search,
                                                template_supported)
from tests.conftest import make_disc_stack


def _random_cfg(rng):
    img_dim = int(rng.choice([48, 56, 64, 75, 90]))
    max_ring = img_dim // 2 - 4
    ring_num = int(rng.integers(8, min(24, max_ring)))
    ring_len = int(rng.choice([64, 128, 256]))
    step = float(rng.choice([0.5, 0.75, 1.0, 2.0]))
    xr = float(rng.choice([1.0, 2.0, 3.0]))
    yr = float(rng.choice([0.0, 1.0, xr]))
    mode = str(rng.choice(["F", "H"]))
    mirror = bool(rng.integers(0, 2))
    return AlignConfig(img_dim=img_dim, ring_num=ring_num,
                       ring_len=ring_len, shift_step=step,
                       shift_rng_x=xr, shift_rng_y=yr,
                       mode=mode, mirror=mirror)


def _winners(res, i):
    return (int(res.best_mirror[i]), int(res.best_sidx[i]),
            int(res.best_ref[i]), int(res.best_aidx[i]))


def _winners_match(res, res_g, name, seed, cfg, n):
    """Engine winners equal the gather engine's (or a tie within the
    bf16 tie-swap tolerance: score gap <= 5e-3 relative)."""
    for i in range(n):
        same = _winners(res, i) == _winners(res_g, i)
        gap = abs(float(res.best_val[i]) - float(res_g.best_val[i]))
        tol = 5e-3 * max(abs(float(res_g.best_val[i])), 1e-6)
        assert same or gap < tol, (
            f"{name} disagrees with gather on seed {seed} cfg {cfg} "
            f"particle {i}: {_winners(res, i)} vs {_winners(res_g, i)} "
            f"gap {gap:.3e}")


@pytest.mark.parametrize("seed", range(8))
def test_engines_agree_on_random_geometry(seed):
    rng = np.random.default_rng(9000 + seed)
    cfg = _random_cfg(rng)
    n, k = 4, 3
    stack = make_disc_stack(rng, n, cfg.img_dim)
    refs = make_disc_stack(rng, k, cfg.img_dim)
    params = AlignParams.zeros(n)
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)

    res_g = rotational_shift_search(jnp.asarray(stack), ref_fw, params, cfg)

    others = [("matmul", rotational_shift_search_mm(
        jnp.asarray(stack), ref_fw, params, cfg, fast=False))]
    if template_supported(cfg, k):
        others.append(("template", template_search(
            jnp.asarray(stack), ref_fw, params, cfg)))

    for name, res in others:
        _winners_match(res, res_g, name, seed, cfg, n)


def _random_cfg_with_margin(rng, margin: int):
    """Like ``_random_cfg`` but keeping ``margin`` extra pixels between
    the outermost sample under the largest grid shift and the image
    boundary, so integer *accumulated* shifts up to ``margin`` never
    touch the clamp region (where the one-stage gather read and the
    two-stage translate+sample differ by construction)."""
    img_dim = int(rng.choice([64, 75, 90]))
    xr = float(rng.choice([1.0, 2.0]))
    max_ring = (img_dim - 1) // 2 - int(xr) - margin
    ring_num = int(rng.integers(8, min(20, max_ring)))
    ring_len = int(rng.choice([64, 128, 256]))
    step = float(rng.choice([0.5, 1.0]))
    yr = float(rng.choice([0.0, xr]))
    mirror = bool(rng.integers(0, 2))
    return AlignConfig(img_dim=img_dim, ring_num=ring_num,
                       ring_len=ring_len, shift_step=step,
                       shift_rng_x=xr, shift_rng_y=yr, mirror=mirror)


@pytest.mark.parametrize("seed", range(6))
def test_engines_agree_with_accumulated_shifts(seed):
    """Nonzero integer accumulated params exercise the per-engine
    pre-translate stages (translate_bilinear_mm, the template engine's
    translate_window_mm fusion, the gather center offset) — the geometry
    where pad/origin bugs live (e.g. the r3 template overshoot-pad bug).
    Integer shifts keep every stage exact, so winners must agree."""
    rng = np.random.default_rng(11000 + seed)
    margin = 4
    cfg = _random_cfg_with_margin(rng, margin)
    n, k = 4, 3
    stack = make_disc_stack(rng, n, cfg.img_dim)
    refs = make_disc_stack(rng, k, cfg.img_dim)
    acc = rng.integers(-(margin - 2), margin - 1, size=(2, n)).astype(
        np.float32)
    params = AlignParams(
        angle=jnp.zeros(n, jnp.float32),
        shift_x=jnp.asarray(acc[0]), shift_y=jnp.asarray(acc[1]),
        mirror=jnp.zeros(n, jnp.int32), ref_id=jnp.zeros(n, jnp.int32))
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)

    res_g = rotational_shift_search(jnp.asarray(stack), ref_fw, params, cfg)
    others = [("matmul", rotational_shift_search_mm(
        jnp.asarray(stack), ref_fw, params, cfg, fast=False))]
    if template_supported(cfg, k):
        others.append(("template", template_search(
            jnp.asarray(stack), ref_fw, params, cfg)))
    for name, res in others:
        _winners_match(res, res_g, name, seed, cfg, n)


@pytest.mark.parametrize("seed", range(6))
def test_engines_agree_with_angle_mask(seed):
    """--dst discrete-angle masks on random geometry: every engine's
    in-fold mask application must pick the same (exact-bin) winner."""
    from cryo_ralib_tpu.ops.search import delta_angle_mask

    rng = np.random.default_rng(12000 + seed)
    cfg = _random_cfg(rng)
    delta = float(rng.choice([10.0, 15.0, 30.0, 45.0]))
    mask = delta_angle_mask(cfg.ring_len, delta, cfg.mode)
    n, k = 4, 3
    stack = make_disc_stack(rng, n, cfg.img_dim)
    refs = make_disc_stack(rng, k, cfg.img_dim)
    params = AlignParams.zeros(n)
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)

    res_g = rotational_shift_search(jnp.asarray(stack), ref_fw, params, cfg,
                                    angle_mask=mask)
    others = [("matmul", rotational_shift_search_mm(
        jnp.asarray(stack), ref_fw, params, cfg, fast=False,
        angle_mask=mask))]
    if template_supported(cfg, k):
        others.append(("template", template_search(
            jnp.asarray(stack), ref_fw, params, cfg, angle_mask=mask)))
    allowed = set(int(b) for b in np.nonzero(mask == 0.0)[0])
    for name, res in others:
        _winners_match(res, res_g, name, seed, cfg, n)
        for i in range(n):
            assert int(res.best_aidx[i]) in allowed, (name, seed, i)


@pytest.mark.parametrize("seed", range(6))
def test_shc_engines_agree_on_random_geometry(seed):
    """The SHC first-passing-candidate pick across all three engines on
    random geometry and a random previousmax threshold (the pinned
    parity test in test_modes.py covers one config only)."""
    from cryo_ralib_tpu.ops.search import (rotational_shift_search_shc,
                                           rotational_shift_search_shc_mm)
    from cryo_ralib_tpu.ops.template_search import template_search_shc

    rng = np.random.default_rng(13000 + seed)
    cfg = _random_cfg(rng)
    n, k = 4, 3
    stack = make_disc_stack(rng, n, cfg.img_dim)
    refs = make_disc_stack(rng, k, cfg.img_dim)
    params = AlignParams.zeros(n)
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)

    # thresholds spanning never-pass / near-peak / always-pass regimes
    peaks = np.asarray(rotational_shift_search(
        jnp.asarray(stack), ref_fw, params, cfg).best_val)
    scale = rng.uniform(0.5, 1.2, n).astype(np.float32)
    scale[0] = 2.0            # particle 0 never improves
    pm = jnp.asarray(peaks * scale)

    ref_res, ref_found = rotational_shift_search_shc(
        jnp.asarray(stack), ref_fw, params, cfg, pm)
    engines = {"matmul": rotational_shift_search_shc_mm(
        jnp.asarray(stack), ref_fw, params, cfg, pm, fast=False)}
    if template_supported(cfg, k):
        engines["template"] = template_search_shc(
            jnp.asarray(stack), ref_fw, params, cfg, pm)
    fr = np.asarray(ref_found)
    assert not fr[0]
    trip = lambda r, i: (int(r.best_mirror[i]), int(r.best_sidx[i]),
                         int(r.best_ref[i]))
    for name, (res, found) in engines.items():
        np.testing.assert_array_equal(np.asarray(found), fr,
                                      err_msg=f"{name} seed {seed}")
        for i in np.nonzero(fr)[0]:
            i = int(i)
            # the SHC pick is at candidate granularity: the (mirror,
            # shift, ref) triple must match exactly
            assert trip(res, i) == trip(ref_res, i), (
                f"{name} seed {seed} cfg {cfg} particle {i}")
            # the angle is an argmax within the winning row — adjacent
            # bins can tie within bf16 noise (same tolerance as the
            # full-search winners)
            ai_e, ai_r = int(res.best_aidx[i]), int(ref_res.best_aidx[i])
            if ai_e != ai_r:
                row = np.asarray(ref_res.best_row[i])
                gap = abs(float(row[ai_e]) - float(row[ai_r]))
                assert gap < 5e-3 * max(abs(float(row[ai_r])), 1e-6), (
                    f"{name} seed {seed} particle {i}: angle bins "
                    f"{ai_e} vs {ai_r} gap {gap:.3e}")


@pytest.mark.parametrize("seed", range(4))
def test_eman_engines_agree_on_random_geometry(seed):
    """The eman2 ring scheme's matmul and gather samplers agree on
    random Numrinit plans (random first_ring/ring_step included)."""
    from cryo_ralib_tpu.ops.eman_search import (prepare_ref_spectra_eman,
                                                rotational_shift_search_eman)

    rng = np.random.default_rng(14000 + seed)
    img_dim = int(rng.choice([64, 75, 90]))
    xr = float(rng.choice([1.0, 2.0]))
    first = int(rng.integers(1, 4))
    rstep = int(rng.choice([1, 2]))
    max_ring = (img_dim - 1) // 2 - int(xr) - 1
    n_rings = int(rng.integers(6, (max_ring - first) // rstep))
    cfg = AlignConfig(img_dim=img_dim, ring_num=n_rings,
                      first_ring=first, ring_step=rstep,
                      ring_scheme="eman2", shift_step=1.0,
                      shift_rng_x=xr, shift_rng_y=xr,
                      mirror=bool(rng.integers(0, 2)))
    n, k = 4, 2
    stack = make_disc_stack(rng, n, img_dim)
    refs = make_disc_stack(rng, k, img_dim)
    params = AlignParams.zeros(n)
    rfwg = prepare_ref_spectra_eman(jnp.asarray(refs), cfg)
    res_g = rotational_shift_search_eman(jnp.asarray(stack), rfwg, params,
                                         cfg, sampler="gather")
    res_m = rotational_shift_search_eman(jnp.asarray(stack), rfwg, params,
                                         cfg, sampler="matmul", fast=False)
    _winners_match(res_m, res_g, "eman-matmul", seed, cfg, n)
