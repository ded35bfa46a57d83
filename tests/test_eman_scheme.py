"""ring_scheme="eman2": variable Numrinit rings + ringwe as production.

The CPU twin — the semantics contract of SURVEY.md §3.3 — aligns over
``Numrinit`` variable-length rings with ``ringwe`` weights
(test_mref_gpu_align.py:741-750); the reference GPU path (and this
rebuild's default) uses the uniform-256 CUDA scheme.  Since r4 the
EMAN2 convention is an opt-in production option: ``ops/eman_search.py``
must match the oracle's
``align_particle_eman_np`` exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu import AlignConfig, AlignParams
from cryo_ralib_tpu.ops.search import decode_params
from cryo_ralib_tpu.utils import oracle
from tests.conftest import make_disc_stack

NX = 64


def _cfg(**kw):
    base = dict(img_dim=NX, ring_num=18, ring_scheme="eman2",
                shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0)
    base.update(kw)
    return AlignConfig(**base)


@pytest.fixture(scope="module")
def stack():
    r = np.random.default_rng(61)
    return make_disc_stack(r, 5, NX)


@pytest.fixture(scope="module")
def refs():
    r = np.random.default_rng(95)
    return make_disc_stack(r, 3, NX)


def test_ring_plan_matches_oracle_copy():
    """Production rings.py and the independent oracle copy agree."""
    from cryo_ralib_tpu.rings import numrinit, ringwe

    for first, last, skip in [(1, 18, 1), (3, 30, 2), (1, 36, 1)]:
        a = numrinit(first, last, skip)
        b = oracle.numrinit(first, last, skip)
        assert a == b, (first, last, skip)
        np.testing.assert_allclose(ringwe(a), oracle.ringwe(b))


def test_eman_config_derives_ring_len():
    cfg = _cfg()
    rings = oracle.numrinit(1, 18)
    assert cfg.eman_rings == tuple(rings)
    assert cfg.ring_len == rings[-1][1]          # maxrin
    np.testing.assert_allclose(cfg.eman_ring_weights,
                               oracle.ringwe(rings), rtol=1e-6)
    # the template engine admits eman2, so the GPU selector picks it;
    # H-mode rejected
    from cryo_ralib_tpu.models.steps import select_engine
    from cryo_ralib_tpu.ops.template_search import template_supported

    assert template_supported(cfg, 3)
    assert select_engine(cfg, 3, platform="gpu") == "template"
    assert select_engine(cfg, 3, platform="cpu") == "gather"
    with pytest.raises(ValueError, match="full rings"):
        _cfg(mode="H")


@pytest.mark.parametrize("sampler", ["gather", "matmul"])
def test_eman_search_matches_oracle(stack, refs, sampler):
    from cryo_ralib_tpu.ops.eman_search import (
        prepare_ref_spectra_eman, rotational_shift_search_eman)

    cfg = _cfg()
    params = AlignParams.zeros(stack.shape[0])
    ref_fwg = prepare_ref_spectra_eman(jnp.asarray(refs), cfg)
    res = rotational_shift_search_eman(
        jnp.asarray(stack), ref_fwg, params, cfg, sampler=sampler,
        fast=False)
    new = decode_params(res, params, cfg)
    rings = list(cfg.eman_rings)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_eman_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            rings, cfg.shifts, 0.0, 0.0, cfg.shift_limit)
        assert int(new.mirror[i]) == want["mirror"], i
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.shift_x[i]) - want["shift_x"]) < 1e-4
        assert abs(float(new.shift_y[i]) - want["shift_y"]) < 1e-4
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3
        assert abs(float(res.best_val[i]) - want["peak"]) \
            < 1e-3 * abs(want["peak"])


@pytest.mark.parametrize("kw", [
    dict(),                                              # integer grid
    dict(shift_step=0.5, shift_rng_x=1.0, shift_rng_y=1.0),  # fractional
])
def test_eman_template_engine_matches_matmul(stack, refs, kw):
    """The eman2 scheme on the template engine — per-ring-group
    splat spectra accumulated into the maxrin angle spectrum
    (ops/template_search._angle_spectra) must reproduce the
    ``rotational_shift_search_eman`` table up to bf16 near-ties, with
    nonzero accumulated shifts and fractional grids."""
    from cryo_ralib_tpu.ops.eman_search import (
        prepare_ref_spectra_eman, rotational_shift_search_eman)
    from cryo_ralib_tpu.ops.template_search import (template_search,
                                                    template_supported)

    cfg = _cfg(**kw)
    assert template_supported(cfg, refs.shape[0])
    rng = np.random.default_rng(7)
    n = stack.shape[0]
    params = AlignParams(
        jnp.zeros(n),
        jnp.asarray(rng.integers(-2, 3, n).astype(np.float32)),
        jnp.asarray(rng.integers(-2, 3, n).astype(np.float32)),
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32))
    ref_fwg = prepare_ref_spectra_eman(jnp.asarray(refs), cfg)
    r_mm = rotational_shift_search_eman(
        jnp.asarray(stack), ref_fwg, params, cfg, sampler="matmul",
        fast=False)
    r_tm = template_search(jnp.asarray(stack), ref_fwg, params, cfg)
    va = np.asarray(r_mm.best_val)
    vb = np.asarray(r_tm.best_val)
    same = ((np.asarray(r_mm.best_aidx) == np.asarray(r_tm.best_aidx))
            & (np.asarray(r_mm.best_sidx) == np.asarray(r_tm.best_sidx))
            & (np.asarray(r_mm.best_ref) == np.asarray(r_tm.best_ref))
            & (np.asarray(r_mm.best_mirror) == np.asarray(r_tm.best_mirror)))
    gap = np.abs(vb - va) / np.abs(va).max()
    # bf16 tent-matmul intermediates: identical winners up to near-ties
    assert np.all(same | (gap <= 5e-3)), (same, gap)
    assert gap.max() <= 5e-3


def test_eman_step_auto_picks_template_on_gpu_geometry(stack, refs,
                                                      monkeypatch):
    """align_step(sampler='auto') on the GPU branch runs the eman2 scheme
    on the template engine end to end (counts conserved; same class
    assignments as the matmul engine)."""
    from cryo_ralib_tpu.models import steps
    from cryo_ralib_tpu.models.steps import align_step

    cfg = _cfg()
    n = stack.shape[0]
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), jnp.float32)
    monkeypatch.setattr(steps.jax, "default_backend", lambda: "gpu")
    assert steps.select_engine(cfg, refs.shape[0]) == "template"
    out_t = align_step(jnp.asarray(stack), jnp.asarray(refs),
                       AlignParams.zeros(n), gidx, valid, cfg,
                       n_classes=refs.shape[0], sampler="auto")
    monkeypatch.undo()
    out_m = align_step(jnp.asarray(stack), jnp.asarray(refs),
                       AlignParams.zeros(n), gidx, valid, cfg,
                       n_classes=refs.shape[0], sampler="matmul",
                       fast=False)
    assert int(out_t.counts.sum()) == n
    np.testing.assert_array_equal(np.asarray(out_t.params.ref_id),
                                  np.asarray(out_m.params.ref_id))


def test_eman_step_and_sampler_gate(stack, refs):
    from cryo_ralib_tpu.models.steps import align_step

    cfg = _cfg()
    n = stack.shape[0]
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), jnp.float32)
    out = align_step(jnp.asarray(stack), jnp.asarray(refs),
                     AlignParams.zeros(n), gidx, valid, cfg,
                     n_classes=refs.shape[0], sampler="gather")
    assert int(out.counts.sum()) == n
    # an engine name outside the selector's set is rejected
    with pytest.raises(ValueError, match="eman2"):
        align_step(jnp.asarray(stack), jnp.asarray(refs),
                   AlignParams.zeros(n), gidx, valid, cfg,
                   n_classes=refs.shape[0], sampler="bogus")


def test_eman_delta_mask_matches_oracle(stack, refs):
    """--dst under the eman2 scheme: the maxrin-bin mask restricts the
    angle argmax exactly like the cuda-scheme engines."""
    from cryo_ralib_tpu.ops.eman_search import (
        prepare_ref_spectra_eman, rotational_shift_search_eman)
    from cryo_ralib_tpu.ops.search import delta_angle_mask

    cfg = _cfg(shift_rng_x=1.0, shift_rng_y=1.0)
    delta = 90.0
    mask = delta_angle_mask(cfg.ring_len, delta, cfg.mode)
    params = AlignParams.zeros(stack.shape[0])
    ref_fwg = prepare_ref_spectra_eman(jnp.asarray(refs), cfg)
    res = rotational_shift_search_eman(
        jnp.asarray(stack), ref_fwg, params, cfg, sampler="gather",
        fast=False, angle_mask=jnp.asarray(mask))
    new = decode_params(res, params, cfg, refine=False)
    ang = np.asarray(new.angle) % delta
    assert np.all(np.minimum(ang, delta - ang) < 1e-3)


def test_reffree_driver_eman_scheme(tmp_path, stack):
    from cryo_ralib_tpu.models.reffree import ali2d_base_tpu

    res = ali2d_base_tpu(stack, outdir=str(tmp_path / "rf"), ou=18,
                         xr=1.0, ts=1.0, maxit=2, sampler="gather",
                         ring_scheme="eman2",
                         user_func_name="ref_ali2d_no_filter")
    assert res.iterations == 2
    with pytest.raises(ValueError, match="standard search"):
        ali2d_base_tpu(stack, outdir=str(tmp_path / "rf2"), ou=18,
                       maxit=1, random_method="SHC", ring_scheme="eman2",
                       sampler="gather")


def test_eman_scheme_with_ir_rs(stack, refs):
    """Numrinit(first_ring=3, rstep=2) plan under the eman2 engine."""
    from cryo_ralib_tpu.ops.eman_search import (
        prepare_ref_spectra_eman, rotational_shift_search_eman)

    cfg = AlignConfig(img_dim=NX, ring_num=9, first_ring=3, ring_step=2,
                      ring_scheme="eman2", shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    assert cfg.eman_rings == tuple(oracle.numrinit(3, 19, 2))
    params = AlignParams.zeros(stack.shape[0])
    ref_fwg = prepare_ref_spectra_eman(jnp.asarray(refs), cfg)
    res = rotational_shift_search_eman(
        jnp.asarray(stack), ref_fwg, params, cfg, sampler="gather",
        fast=False)
    new = decode_params(res, params, cfg)
    rings = list(cfg.eman_rings)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_eman_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            rings, cfg.shifts, 0.0, 0.0, cfg.shift_limit)
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3


def test_mref_driver_eman_scheme_end_to_end(tmp_path, stack, refs):
    """One driver iteration under the eman2 scheme reproduces the oracle
    per-particle search + decode."""
    from cryo_ralib_tpu.models.mref import mref_ali2d_tpu
    from cryo_ralib_tpu.ops.masks import model_circle, normalize_mask

    res = mref_ali2d_tpu(stack, refs, outdir=str(tmp_path / "eman"),
                         ou=18, xr=1.0, ts=1.0, maxit=1, sampler="gather",
                         ring_scheme="eman2",
                         user_func_name="ref_ali2d_no_filter")
    # reproduce the driver's preprocessing, then the oracle search
    mask = model_circle(18, NX)
    data = np.asarray(normalize_mask(jnp.asarray(stack), jnp.asarray(mask),
                                     no_sigma=False))
    refn = np.asarray(normalize_mask(jnp.asarray(refs), jnp.asarray(mask),
                                     no_sigma=True))
    cfg = _cfg(shift_rng_x=1.0, shift_rng_y=1.0)
    rings = list(cfg.eman_rings)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_eman_np(
            data[i].astype(np.float64), refn.astype(np.float64),
            rings, cfg.shifts, 0.0, 0.0, cfg.shift_limit)
        assert int(res.assignments[i]) == want["ref_id"], i
        assert int(res.params[i, 3]) == want["mirror"], i
