"""--dst discrete-angle (delta) search: JAX paths vs the oracle.

The CPU twin restricts every 4th iteration's rotation search to
multiples of ``dst`` degrees (``ali2d_single_iter(delta=dst)`` ->
EMAN2 ``Util.Crosrng_ms_delta``; schedule at
test_reffree_gpu_align.py:841-846).  The GPU reference hard-codes
delta=0 (line 307); here it is real capability.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu import AlignConfig, AlignParams
from cryo_ralib_tpu.ops.search import (decode_params, delta_angle_bins,
                                       delta_angle_mask, prepare_ref_spectra,
                                       rotational_shift_search,
                                       rotational_shift_search_mm)
from cryo_ralib_tpu.utils import oracle
from tests.conftest import make_disc_stack

NX = 64


def _cfg(**kw):
    base = dict(img_dim=NX, ring_num=20, ring_len=128,
                shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0)
    base.update(kw)
    return AlignConfig(**base)


@pytest.fixture(scope="module")
def stack():
    r = np.random.default_rng(43)
    return make_disc_stack(r, 6, NX)


@pytest.fixture(scope="module")
def refs():
    r = np.random.default_rng(91)
    return make_disc_stack(r, 3, NX)


def test_delta_angle_bins_exact_divisors():
    # L=128 mode F: step 2.8125 deg; 90 deg = bin 32 exactly
    np.testing.assert_array_equal(delta_angle_bins(128, 90.0, "F"),
                                  [0, 32, 64, 96])
    np.testing.assert_array_equal(delta_angle_bins(128, 45.0, "F"),
                                  np.arange(0, 128, 16))
    # mode H spans 180 deg: 90 deg = bin 64 of 128
    np.testing.assert_array_equal(delta_angle_bins(128, 90.0, "H"), [0, 64])
    mask = delta_angle_mask(128, 90.0, "F")
    assert (mask == 0.0).sum() == 4 and (mask < -1e30).sum() == 124


def test_delta_angle_bins_nonexact():
    # delta that does not divide the bin grid: nearest bins, deduped
    bins = delta_angle_bins(128, 77.0, "F")
    assert bins.shape[0] == len(np.arange(0.0, 360.0 - 1e-9, 77.0))
    step = 360.0 / 128
    for b in bins:
        # each selected bin is within half a bin of some multiple of 77
        assert min(abs(b * step - m) for m in np.arange(0, 360, 77.0)) <= step / 2 + 1e-9


@pytest.mark.parametrize("search_fn", [
    lambda i, r, p, c, m: rotational_shift_search(i, r, p, c, angle_mask=m),
    lambda i, r, p, c, m: rotational_shift_search_mm(i, r, p, c, fast=False,
                                                     angle_mask=m)])
def test_delta_matches_oracle(stack, refs, search_fn):
    cfg = _cfg()
    delta = 90.0
    mask = delta_angle_mask(cfg.ring_len, delta, cfg.mode)
    params = AlignParams.zeros(stack.shape[0])
    rfw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res = search_fn(jnp.asarray(stack), rfw, params, cfg, jnp.asarray(mask))
    new = decode_params(res, params, cfg, refine=False)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, cfg.shifts,
            0.0, 0.0, cfg.shift_limit, delta=delta)
        assert int(new.mirror[i]) == want["mirror"], i
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.shift_x[i]) - want["shift_x"]) < 1e-4
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3
        # decoded angle is an exact multiple of delta (mod 360; the
        # mirror branch adds 180, itself a multiple of 90)
        assert float(new.angle[i]) % delta < 1e-3 or \
            delta - float(new.angle[i]) % delta < 1e-3


def test_delta_template_matches_oracle(stack, refs):
    """The template engine's online argmax takes the mask (r4)."""
    from cryo_ralib_tpu.ops.template_search import (template_search,
                                                    template_supported)

    cfg = _cfg()
    assert template_supported(cfg, refs.shape[0])
    delta = 90.0
    mask = delta_angle_mask(cfg.ring_len, delta, cfg.mode)
    params = AlignParams.zeros(stack.shape[0])
    rfw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res = template_search(jnp.asarray(stack), rfw, params, cfg,
                          angle_mask=mask)
    new = decode_params(res, params, cfg, refine=False)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, cfg.shifts,
            0.0, 0.0, cfg.shift_limit, delta=delta)
        assert int(new.mirror[i]) == want["mirror"], i
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.shift_x[i]) - want["shift_x"]) < 1e-4
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3
    # streamed path produces identical winners (same slices, same mask)
    res_s = template_search(jnp.asarray(stack), rfw, params, cfg,
                            angle_mask=mask, stream=True)
    for f in ("best_aidx", "best_sidx", "best_ref", "best_mirror"):
        np.testing.assert_array_equal(np.asarray(getattr(res_s, f)),
                                      np.asarray(getattr(res, f)), err_msg=f)


def test_delta_step_keeps_fast_sampler(stack, refs):
    """align_step keeps the template engine under a mask."""
    from cryo_ralib_tpu.models.steps import align_step

    cfg = _cfg(ring_len=256)
    mask = delta_angle_mask(cfg.ring_len, 90.0, cfg.mode)
    n = stack.shape[0]
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), jnp.float32)
    outs = {}
    for sampler in ("template", "gather"):
        out = align_step(jnp.asarray(stack), jnp.asarray(refs),
                         AlignParams.zeros(n), gidx, valid, cfg,
                         n_classes=refs.shape[0], sampler=sampler,
                         angle_mask=jnp.asarray(mask))
        outs[sampler] = out
    np.testing.assert_array_equal(np.asarray(outs["template"].params.ref_id),
                                  np.asarray(outs["gather"].params.ref_id))
    np.testing.assert_allclose(np.asarray(outs["template"].params.angle),
                               np.asarray(outs["gather"].params.angle),
                               atol=5e-3)


def test_engine_discrete_iterate(stack):
    """iterate(discrete=True) snaps angles; discrete=False refines."""
    from cryo_ralib_tpu.models.engine import AlignmentEngine

    cfg = _cfg()
    ref = stack.mean(0)[None]
    eng = AlignmentEngine(stack, cfg, n_classes=1, update_ref=False,
                          sampler="gather", delta=90.0)
    out_d = eng.iterate(ref, discrete=True)
    ang = eng.params_np().angle % 90.0
    assert np.all(np.minimum(ang, 90.0 - ang) < 1e-3)
    assert out_d.counts.sum() == stack.shape[0]
    # continuous pass afterwards: parabolic refinement produces
    # non-multiples for at least one particle on random blobs
    eng.iterate(ref, discrete=False)
    ang2 = eng.params_np().angle % 90.0
    assert np.any(np.minimum(ang2, 90.0 - ang2) > 1e-3)


def test_engine_delta_rejected_for_shc(stack):
    from cryo_ralib_tpu.models.engine import AlignmentEngine

    with pytest.raises(ValueError, match="dst"):
        AlignmentEngine(stack, _cfg(), n_classes=1, update_ref=False,
                        sampler="gather", random_method="SHC", delta=90.0)
    eng = AlignmentEngine(stack, _cfg(), n_classes=1, update_ref=False,
                          sampler="gather")
    with pytest.raises(ValueError, match="delta"):
        eng.iterate(stack.mean(0)[None], discrete=True)


def test_reffree_driver_dst_schedule(tmp_path, stack):
    """maxit=11 makes the first iteration discrete (it=0: 0%4==0 and
    total_iter 1 <= 11-10); the log records it and the run completes."""
    from cryo_ralib_tpu.models.reffree import ali2d_base_tpu

    outdir = str(tmp_path / "dst")
    res = ali2d_base_tpu(stack, outdir=outdir, ou=20, xr=1.0, ts=1.0,
                         maxit=11, dst=90.0, sampler="gather",
                         user_func_name="ref_ali2d_no_filter")
    assert res.iterations == 11
    log_text = open(os.path.join(outdir, "logfile.txt")).read()
    assert "Discrete angle used" in log_text
    # exactly one discrete iteration in an 11-iteration run: it=0 only
    # (it=4, 8 fall inside the trailing-10 guard)
    assert log_text.count("uses discrete angles") == 1
