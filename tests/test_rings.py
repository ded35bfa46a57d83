"""--ir/--rs ring plans: non-default first_ring/ring_step as real behavior.

The reference GPU config silently ignores both flags (its AlignConfig
always builds rings 1..ou step 1, test_mref_gpu_align.py:365-369), but
its CPU twin honors ``Numrinit(first_ring, last_ring, rstep)``
(test_mref_gpu_align.py:338).  Since r4 the rebuild threads them into
the ring template, and every engine is radius-agnostic.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu import AlignConfig, AlignParams
from cryo_ralib_tpu.ops.search import (decode_params, prepare_ref_spectra,
                                       rotational_shift_search,
                                       rotational_shift_search_mm)
from cryo_ralib_tpu.utils import oracle
from tests.conftest import make_disc_stack

NX = 64


@pytest.fixture(scope="module")
def stack():
    r = np.random.default_rng(53)
    return make_disc_stack(r, 5, NX)


@pytest.fixture(scope="module")
def refs():
    r = np.random.default_rng(87)
    return make_disc_stack(r, 3, NX)


def test_ring_plan_geometry():
    cfg = AlignConfig(img_dim=NX, ring_num=9, first_ring=3, ring_step=2)
    np.testing.assert_array_equal(cfg.radii, np.arange(3, 20, 2))
    assert cfg.max_radius == 19
    assert cfg.shift_limit == NX - 19 - 2
    np.testing.assert_array_equal(cfg.ring_weights, cfg.radii)
    # ring i radius in the sampled coords
    rad = np.hypot(cfg.polar_coords[..., 0], cfg.polar_coords[..., 1])
    np.testing.assert_allclose(rad, np.broadcast_to(
        cfg.radii[:, None], rad.shape), rtol=1e-6)
    # defaults unchanged: radius i+1, weight i+1
    base = AlignConfig(img_dim=NX, ring_num=20)
    np.testing.assert_array_equal(base.radii, np.arange(1, 21))
    assert base.shift_limit == NX - 20 - 2


def test_ring_plan_validation():
    with pytest.raises(ValueError, match="first_ring"):
        AlignConfig(img_dim=NX, ring_num=4, first_ring=0)
    with pytest.raises(ValueError, match="ring_step"):
        AlignConfig(img_dim=NX, ring_num=4, ring_step=0)
    # boundary check uses the outermost radius (33 > 31), not ring_num
    with pytest.raises(ValueError, match="boundary"):
        AlignConfig(img_dim=NX, ring_num=17, first_ring=1, ring_step=2)


def test_ring_plan_gates():
    from cryo_ralib_tpu.models.steps import select_engine
    from cryo_ralib_tpu.ops.template_search import template_supported

    cfg = AlignConfig(img_dim=NX, ring_num=9, ring_len=256, first_ring=3,
                      ring_step=2, shift_rng_x=2.0, shift_rng_y=2.0)
    assert template_supported(cfg, 3)
    assert select_engine(cfg, 3, platform="gpu") == "template"


@pytest.mark.parametrize("search_fn", [
    rotational_shift_search,
    lambda i, r, p, c: rotational_shift_search_mm(i, r, p, c, fast=False)])
def test_ring_plan_matches_oracle(stack, refs, search_fn):
    cfg = AlignConfig(img_dim=NX, ring_num=8, ring_len=128, first_ring=4,
                      ring_step=2, shift_step=1.0, shift_rng_x=2.0,
                      shift_rng_y=2.0)
    params = AlignParams.zeros(stack.shape[0])
    rfw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res = search_fn(jnp.asarray(stack), rfw, params, cfg)
    new = decode_params(res, params, cfg)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, cfg.shifts,
            0.0, 0.0, cfg.shift_limit)
        assert int(new.mirror[i]) == want["mirror"], i
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.shift_x[i]) - want["shift_x"]) < 1e-4
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3


def test_ring_plan_template_matches_gather(stack, refs):
    from cryo_ralib_tpu.ops.template_search import template_search

    cfg = AlignConfig(img_dim=NX, ring_num=8, ring_len=128, first_ring=4,
                      ring_step=2, shift_step=1.0, shift_rng_x=2.0,
                      shift_rng_y=2.0)
    params = AlignParams.zeros(stack.shape[0])
    rfw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    a = rotational_shift_search(jnp.asarray(stack), rfw, params, cfg)
    b = template_search(jnp.asarray(stack), rfw, params, cfg)
    np.testing.assert_array_equal(np.asarray(a.best_ref),
                                  np.asarray(b.best_ref))
    np.testing.assert_array_equal(np.asarray(a.best_sidx),
                                  np.asarray(b.best_sidx))
    np.testing.assert_array_equal(np.asarray(a.best_aidx),
                                  np.asarray(b.best_aidx))


def test_mref_driver_honors_ir_rs(tmp_path, stack, refs):
    from cryo_ralib_tpu.models.mref import mref_ali2d_tpu

    res = mref_ali2d_tpu(stack, refs, outdir=str(tmp_path / "irrs"),
                         ir=3, ou=20, rs=2, xr=1.0, ts=1.0, maxit=2,
                         sampler="gather",
                         user_func_name="ref_ali2d_no_filter")
    assert res.iterations == 2
    assert res.params.shape == (stack.shape[0], 4)
    with pytest.raises(ValueError, match="ring plan"):
        mref_ali2d_tpu(stack, refs, outdir=str(tmp_path / "bad"),
                       ir=30, ou=20, maxit=1, sampler="gather")


def test_reffree_driver_honors_ir_rs(tmp_path, stack):
    from cryo_ralib_tpu.models.reffree import ali2d_base_tpu

    res = ali2d_base_tpu(stack, outdir=str(tmp_path / "rf"), ir=2, ou=20,
                         rs=3, xr=1.0, ts=1.0, maxit=2, sampler="gather",
                         user_func_name="ref_ali2d_no_filter")
    assert res.iterations == 2


def test_center_method_honesty(tmp_path, stack, refs):
    """--center policy (r4): 0/1 honored, anything else rejected loudly
    instead of aliased to cog."""
    from cryo_ralib_tpu.models.mref import mref_ali2d_tpu
    from cryo_ralib_tpu.models.reffree import ali2d_base_tpu
    from cryo_ralib_tpu.ops.center import center_2D

    img, _, _ = center_2D(stack[0], method=0)
    np.testing.assert_array_equal(np.asarray(img), stack[0])
    _, sx, sy = center_2D(stack[0], method=1)
    assert np.isfinite(float(sx)) and np.isfinite(float(sy))
    with pytest.raises(ValueError, match="center"):
        center_2D(stack[0], method=2)
    with pytest.raises(ValueError, match="center"):
        mref_ali2d_tpu(stack, refs, outdir=str(tmp_path / "c7"), ou=20,
                       maxit=1, center=7, sampler="gather")
    with pytest.raises(ValueError, match="center"):
        ali2d_base_tpu(stack, outdir=str(tmp_path / "c3"), ou=20,
                       maxit=1, center=3, sampler="gather")
