"""H-mode (half rings), --nomirror and SHC: JAX paths vs the oracle.

These cover the r3 capability additions: the CPU
twin's alignment modes (test_reffree_gpu_align.py:714,724,921) as real
behavior rather than loud rejection.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu import AlignConfig, AlignParams
from cryo_ralib_tpu.models.steps import align_step_shc, make_align_step_shc
from cryo_ralib_tpu.ops.search import (decode_params, prepare_ref_spectra,
                                       rotational_shift_search,
                                       rotational_shift_search_mm,
                                       rotational_shift_search_shc)
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
    r = np.random.default_rng(31)
    return make_disc_stack(r, 6, NX)


@pytest.fixture(scope="module")
def refs():
    r = np.random.default_rng(77)
    return make_disc_stack(r, 3, NX)


def _search_and_decode(cfg, imgs, refs, search_fn):
    params = AlignParams.zeros(imgs.shape[0])
    rfw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res = search_fn(jnp.asarray(imgs), rfw, params, cfg)
    return decode_params(res, params, cfg)


@pytest.mark.parametrize("search_fn", [
    rotational_shift_search,
    lambda i, r, p, c: rotational_shift_search_mm(i, r, p, c, fast=False)])
def test_nomirror_matches_oracle(stack, refs, search_fn):
    cfg = _cfg(mirror=False)
    new = _search_and_decode(cfg, stack, refs, search_fn)
    assert np.all(np.asarray(new.mirror) == 0)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, cfg.shifts,
            0.0, 0.0, cfg.shift_limit, mirror=False)
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.shift_x[i]) - want["shift_x"]) < 1e-4
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3


def test_nomirror_changes_result_for_mirrored_input():
    """An (EMAN2-convention) mirrored copy of a reference must match with
    mirror=1 under the full search but can only pick a worse mirror=0
    candidate under --nomirror."""
    cfg_f = _cfg()
    cfg_n = _cfg(mirror=False)
    r = np.random.default_rng(5)
    # uncorrelated noise references: no accidental rotational matches
    nrefs = r.standard_normal((2, NX, NX)).astype(np.float32)
    img = oracle.transform_np(nrefs[1].astype(np.float64),
                              0.0, 0.0, 0.0, 1).astype(np.float32)[None]
    full = _search_and_decode(cfg_f, img, nrefs, rotational_shift_search)
    nomi = _search_and_decode(cfg_n, img, nrefs, rotational_shift_search)
    assert int(full.mirror[0]) == 1
    assert int(full.ref_id[0]) == 1
    assert int(nomi.mirror[0]) == 0


def test_hmode_matches_oracle(stack, refs):
    cfg = _cfg(mode="H")
    # half-ring coords: all sampled angles in [0, pi)
    assert np.all(cfg.polar_coords[:, :, 1] >= -1e-5)
    assert cfg.angle_step == pytest.approx(180.0 / cfg.ring_len)
    new = _search_and_decode(cfg, stack, refs, rotational_shift_search)
    for i in range(stack.shape[0]):
        want = oracle.align_particle_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, cfg.shifts,
            0.0, 0.0, cfg.shift_limit, mode="H")
        assert int(new.mirror[i]) == want["mirror"], i
        assert int(new.ref_id[i]) == want["ref_id"], i
        assert abs(float(new.angle[i]) - want["angle"]) < 5e-3


def test_hmode_mm_agrees_with_gather(stack, refs):
    cfg = _cfg(mode="H")
    a = _search_and_decode(cfg, stack, refs, rotational_shift_search)
    b = _search_and_decode(cfg, stack, refs,
                           lambda i, r, p, c: rotational_shift_search_mm(
                               i, r, p, c, fast=False))
    np.testing.assert_array_equal(np.asarray(a.ref_id), np.asarray(b.ref_id))
    np.testing.assert_allclose(np.asarray(a.angle), np.asarray(b.angle),
                               atol=5e-3)


def test_shc_first_above_matches_oracle(stack, refs):
    cfg = _cfg()
    n = stack.shape[0]
    params = AlignParams.zeros(n)
    rfw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    # mid-range previousmax so some particles improve and some do not
    res0 = rotational_shift_search(jnp.asarray(stack), rfw, params, cfg)
    peaks = np.asarray(res0.best_val)
    pm = np.full(n, 1.0e-23, np.float32)
    pm[0] = peaks[0] * 2.0          # nothing beats this -> nope
    pm[1] = peaks[1] * 0.9          # only near-peak candidates pass

    res, found = rotational_shift_search_shc(
        jnp.asarray(stack), rfw, params, cfg, jnp.asarray(pm))
    found = np.asarray(found)
    assert not found[0]
    assert found[1:].all()
    dec = decode_params(res, params, cfg)
    for i in range(1, n):
        want = oracle.align_particle_shc_np(
            stack[i].astype(np.float64), refs.astype(np.float64),
            cfg.polar_coords, cfg.ring_weights, cfg.shifts,
            0.0, 0.0, cfg.shift_limit, float(pm[i]))
        assert want is not None
        assert int(dec.mirror[i]) == want["mirror"], i
        assert int(dec.ref_id[i]) == want["ref_id"], i
        assert abs(float(dec.shift_x[i]) - want["shift_x"]) < 1e-4
        assert abs(float(dec.angle[i]) - want["angle"]) < 5e-3
        assert abs(float(res.best_val[i]) - want["peak"]) < 1e-3 * abs(
            want["peak"])
    # oracle agrees particle 0 has no improving candidate
    assert oracle.align_particle_shc_np(
        stack[0].astype(np.float64), refs.astype(np.float64),
        cfg.polar_coords, cfg.ring_weights, cfg.shifts,
        0.0, 0.0, cfg.shift_limit, float(pm[0])) is None


def test_shc_fast_engines_match_gather(stack, refs):
    """The r4 SHC fast paths (matmul tent sampling, template matmul)
    share the priority fold with the gather engine: picks must agree on
    structured stacks."""
    from cryo_ralib_tpu.ops.search import rotational_shift_search_shc_mm
    from cryo_ralib_tpu.ops.template_search import template_search_shc

    cfg = _cfg()
    n = stack.shape[0]
    params = AlignParams.zeros(n)
    rfw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res0 = rotational_shift_search(jnp.asarray(stack), rfw, params, cfg)
    peaks = np.asarray(res0.best_val)
    pm = np.full(n, 1.0e-23, np.float32)
    pm[0] = peaks[0] * 2.0          # no candidate passes -> nope
    pm[1] = peaks[1] * 0.9          # only near-peak candidates pass

    ref_res, ref_found = rotational_shift_search_shc(
        jnp.asarray(stack), rfw, params, cfg, jnp.asarray(pm))
    for name, (res, found) in {
        "matmul": rotational_shift_search_shc_mm(
            jnp.asarray(stack), rfw, params, cfg, jnp.asarray(pm),
            fast=False),
        "template": template_search_shc(
            jnp.asarray(stack), rfw, params, cfg, jnp.asarray(pm)),
    }.items():
        np.testing.assert_array_equal(np.asarray(found),
                                      np.asarray(ref_found), err_msg=name)
        f = np.asarray(ref_found)
        for fld in ("best_sidx", "best_ref", "best_mirror", "best_aidx"):
            np.testing.assert_array_equal(
                np.asarray(getattr(res, fld))[f],
                np.asarray(getattr(ref_res, fld))[f],
                err_msg=f"{name}:{fld}")
        va = np.asarray(ref_res.best_val)[f]
        np.testing.assert_allclose(np.asarray(res.best_val)[f], va,
                                   atol=5e-3 * np.abs(va).max(),
                                   err_msg=name)


def test_shc_step_sampler_parity(stack):
    """align_step_shc produces the same params/nope for every engine."""
    cfg = _cfg()
    n = stack.shape[0]
    imgs = jnp.asarray(stack)
    ref = jnp.asarray(stack.mean(0)[None])
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), jnp.float32)
    pm = jnp.full((n,), 1.0e-23, jnp.float32)
    outs = {}
    for sampler in ("gather", "matmul", "template"):
        outs[sampler] = align_step_shc(imgs, ref, AlignParams.zeros(n),
                                       gidx, valid, pm, cfg, n_classes=1,
                                       sampler=sampler)
    base = outs["gather"]
    for sampler in ("matmul", "template"):
        out = outs[sampler]
        assert int(out.nope) == int(base.nope), sampler
        np.testing.assert_array_equal(np.asarray(out.step.params.mirror),
                                      np.asarray(base.step.params.mirror))
        np.testing.assert_allclose(np.asarray(out.step.params.angle),
                                   np.asarray(base.step.params.angle),
                                   atol=0.1, err_msg=sampler)
        np.testing.assert_allclose(np.asarray(out.previousmax),
                                   np.asarray(base.previousmax), rtol=5e-3,
                                   err_msg=sampler)


def test_shc_step_keeps_nonimprovers_and_counts_nope(stack):
    # zero shift range: iteration 2 sees the identical candidate table
    # (with shifts the accumulated recentering legitimately re-improves)
    cfg = _cfg(shift_rng_x=0.0, shift_rng_y=0.0)
    n = stack.shape[0]
    imgs = jnp.asarray(stack)
    ref = jnp.asarray(stack.mean(0)[None])
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), jnp.float32)
    params = AlignParams.zeros(n)
    pm = jnp.full((n,), 1.0e-23, jnp.float32)

    out = align_step_shc(imgs, ref, params, gidx, valid, pm, cfg,
                         n_classes=1)
    assert int(out.nope) == 0           # everything beats 1e-23
    # repeated passes against the same reference: previousmax climbs
    # monotonically and the hill climb terminates (every particle "nope")
    # within the candidate count; params then stop changing
    prev_pm = np.asarray(out.previousmax)
    n_cand = 2 * 1 * 1        # mirror x shifts x refs
    for _ in range(n_cand + 2):
        nxt = align_step_shc(imgs, ref, out.step.params, gidx, valid,
                             out.previousmax, cfg, n_classes=1)
        pm_now = np.asarray(nxt.previousmax)
        assert np.all(pm_now >= prev_pm - 1e-6)
        if int(nxt.nope) == n:
            np.testing.assert_array_equal(
                np.asarray(nxt.step.params.angle),
                np.asarray(out.step.params.angle))
            np.testing.assert_array_equal(pm_now, prev_pm)
            break
        prev_pm = pm_now
        out = nxt
    else:
        raise AssertionError("SHC did not converge within candidate count")


def test_shc_sharded_step_matches_single(stack):
    from cryo_ralib_tpu.parallel.mesh import make_mesh, shard_stack

    cfg = _cfg()
    n = 8
    imgs_np = np.concatenate([stack, stack[:2]], axis=0)
    ref = jnp.asarray(imgs_np.mean(0)[None])
    mesh = make_mesh(4)
    step = make_align_step_shc(cfg, n_classes=1, mesh=mesh)
    imgs_dev, gidx, valid = shard_stack(imgs_np, mesh)
    pm = jax.device_put(jnp.full((n,), 1.0e-23, jnp.float32), gidx.sharding)
    out = step(imgs_dev, ref, AlignParams.zeros(n), gidx, valid, pm)

    ref1 = align_step_shc(jnp.asarray(imgs_np), ref, AlignParams.zeros(n),
                          jnp.arange(n, dtype=jnp.int32),
                          jnp.ones((n,), jnp.float32),
                          jnp.full((n,), 1.0e-23, jnp.float32), cfg,
                          n_classes=1)
    np.testing.assert_allclose(np.asarray(out.step.class_sums),
                               np.asarray(ref1.step.class_sums),
                               atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out.step.params.mirror),
                                  np.asarray(ref1.step.params.mirror))
    assert int(out.nope) == int(ref1.nope)


def test_reffree_driver_shc_and_modes(tmp_path, stack):
    """End-to-end: SHC / nomirror / H-mode through ali2d_base_tpu."""
    from cryo_ralib_tpu.models.reffree import ali2d_base_tpu

    big = np.concatenate([stack, stack[::-1] * 0.7], axis=0)
    res_shc = ali2d_base_tpu(big, outdir=str(tmp_path / "shc"), ou=20,
                             xr=1.0, ts=1.0, maxit=3, random_method="SHC",
                             sampler="gather")
    assert res_shc.iterations >= 1
    res_nm = ali2d_base_tpu(big, outdir=str(tmp_path / "nm"), ou=20,
                            xr=1.0, ts=1.0, maxit=2, nomirror=True,
                            sampler="gather")
    assert np.all(res_nm.params[:, 3] == 0)     # no mirrors assigned
    res_h = ali2d_base_tpu(big, outdir=str(tmp_path / "h"), ou=20,
                           xr=1.0, ts=1.0, maxit=2, mode="H",
                           sampler="gather")
    assert res_h.iterations >= 1


def test_engine_shc_streaming_matches_resident(stack):
    """SHC previousmax bookkeeping must survive the host-batched
    streaming path (fixed-size padded batches)."""
    from cryo_ralib_tpu.models.engine import AlignmentEngine

    cfg = _cfg()
    data = np.concatenate([stack, stack[::-1] * 0.8], axis=0)  # N=12
    ref = data.mean(0)[None]

    res = AlignmentEngine(data, cfg, n_classes=1, update_ref=False,
                          sampler="gather", random_method="SHC")
    assert res.resident
    stm = AlignmentEngine(data, cfg, n_classes=1, update_ref=False,
                          sampler="gather", random_method="SHC",
                          batch_size=5)
    assert not stm.resident

    for _ in range(2):
        o_r = res.iterate(ref)
        o_s = stm.iterate(ref)
        assert o_r.nope == o_s.nope
        np.testing.assert_allclose(o_r.class_sums, o_s.class_sums,
                                   atol=1e-3)
    np.testing.assert_allclose(res.previousmax_np(), stm.previousmax_np(),
                               rtol=1e-6)
    pr, ps = res.params_np(), stm.params_np()
    np.testing.assert_array_equal(pr.mirror, ps.mirror)
    np.testing.assert_allclose(pr.angle, ps.angle, atol=1e-4)


def test_reffree_driver_combined_flags(tmp_path, stack):
    """All round-3 reffree capabilities at once — the reference's
    ali2d_base accepts CTF+Fourvar+SHC+mode=H+nomirror+yr simultaneously
    (test_reffree_gpu_align.py:915-935), so the rebuild must too; each
    flag is oracle-tested alone elsewhere, this guards the wiring."""
    import os

    from cryo_ralib_tpu.models import ali2d_base_tpu

    n = stack.shape[0]
    res = ali2d_base_tpu(
        stack, outdir=str(tmp_path / "combo"), ou=12, xr=1.0, yr=2.0,
        ts=1.0, maxit=2, CTF=True, snr=5.0,
        ctf_params=dict(dfu=np.full(n, 1.4), apix=1.5),
        Fourvar=True, random_method="SHC", mode="H", nomirror=True,
        sampler="gather")
    p = np.asarray(res.params)                        # (N, 4) header rows
    assert np.all(p[:, 3] == 0)                       # --nomirror
    assert np.all(p[:, 0] >= 0.0) and np.all(p[:, 0] < 360.0)
    assert os.path.exists(tmp_path / "combo" / "varf.hdf")   # --Fourvar
    assert os.path.exists(tmp_path / "combo" / "aqfinal.hdf")
    assert res.radial_variances and np.all(np.isfinite(res.radial_variances[-1]))
    assert np.isfinite(res.criteria[-1])


def test_forced_sampler_gates_reject(stack, refs):
    """Forced samplers validate their geometry gates instead of
    computing silently wrong results (r4 code review): every accepted
    --sampler value either has the engine's exact semantics or errors."""
    from cryo_ralib_tpu.models.steps import (align_step, align_step_scf,
                                             select_engine)
    from cryo_ralib_tpu.ops.template_search import template_supported

    n = stack.shape[0]
    imgs = jnp.asarray(stack)
    r = jnp.asarray(refs)
    params = AlignParams.zeros(n)
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), jnp.float32)
    # custom --ir ring plan: the selector keeps the template engine; an
    # engine name it does not know is rejected
    cfg_ir = _cfg(first_ring=3)
    assert select_engine(cfg_ir, r.shape[0], platform="gpu") == "template"
    with pytest.raises(ValueError, match="sampler='bogus'"):
        align_step(imgs, r, params, gidx, valid, cfg_ir,
                   n_classes=r.shape[0], sampler="bogus")
    # window overflows the box: outside the template gate, so the
    # selector falls back and a forced template errors
    cfg_big = _cfg(ring_num=29)
    assert not template_supported(cfg_big, r.shape[0])
    assert select_engine(cfg_big, r.shape[0], platform="gpu") == "gather"
    with pytest.raises(ValueError, match="template"):
        align_step(imgs, r, params, gidx, valid, cfg_big,
                   n_classes=r.shape[0], sampler="template")
    # SHC: unknown engines rejected; template gate also applies
    pm = jnp.full((n,), 1e-23, jnp.float32)
    assert select_engine(cfg_big, 1, mode="shc", platform="gpu") == "gather"
    with pytest.raises(ValueError, match="SHC"):
        align_step_shc(imgs, r[:1], params, gidx, valid, pm, cfg=_cfg(),
                       n_classes=1, sampler="bogus")
    with pytest.raises(ValueError, match="template"):
        align_step_shc(imgs, r[:1], params, gidx, valid, pm, cfg=cfg_big,
                       n_classes=1, sampler="template")
    # SHC/SCF never run the eman2 ring scheme
    cfg_e = _cfg(ring_scheme="eman2", mirror=True)
    with pytest.raises(ValueError, match="ring "):
        align_step_shc(imgs, r[:1], params, gidx, valid, pm, cfg=cfg_e,
                       n_classes=1, sampler="gather")
    # SCF: no template variant
    with pytest.raises(ValueError, match="SCF"):
        align_step_scf(imgs, r[:1], params, gidx, valid,
                       _cfg(mode="H"), n_classes=1, sampler="template")
