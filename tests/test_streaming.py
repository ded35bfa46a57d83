"""Streaming (host-batched) execution equals resident execution, and the
device-memory batch planner behaves sanely."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from cryo_ralib_tpu.config import AlignConfig
from cryo_ralib_tpu.models import mref_ali2d_tpu
from cryo_ralib_tpu.models.engine import AlignmentEngine
from cryo_ralib_tpu.parallel.batching import plan_batch_size, step_footprint
from cryo_ralib_tpu.utils.log import RunLogger
from tests.conftest import make_class_bases, make_disc_stack


def test_plan_batch_size_monotone():
    cfg = AlignConfig(img_dim=90, ring_num=36, ring_len=256, shift_step=1.0,
                      shift_rng_x=3.0, shift_rng_y=3.0)
    small = plan_batch_size(10 ** 6, 8, cfg, limit_bytes=2 * 2 ** 30)
    big = plan_batch_size(10 ** 6, 8, cfg, limit_bytes=16 * 2 ** 30)
    assert small < big
    assert small >= 1
    # footprint of the planned batch actually fits the budget
    assert step_footprint(small, 8, cfg).total <= 0.7 * 2 * 2 ** 30
    # whole tiny stack always fits
    assert plan_batch_size(64, 8, cfg) == 64


def test_template_footprint_no_phantom_tables():
    # the template engine never allocates the PolarTables constants — at
    # big boxes the phantom ~quarter-GiB tables term shrank the planned
    # batch below what the path can actually run (r4 review finding)
    cfg = AlignConfig(img_dim=256, ring_num=100, ring_len=256,
                      shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0)
    fp_t = step_footprint(2048, 4, cfg, sampler="template")
    fp_m = step_footprint(2048, 4, cfg, sampler="matmul")
    assert fp_t.tables == 0
    assert fp_m.tables > 0
    assert plan_batch_size(
        10 ** 6, 4, cfg, limit_bytes=16 * 2 ** 30, sampler="template",
    ) >= plan_batch_size(
        10 ** 6, 4, cfg, limit_bytes=16 * 2 ** 30, sampler="matmul")


def _engine_results(data, refs, cfg, k, batch_size, iters=2, mesh=None):
    eng = AlignmentEngine(data, cfg, n_classes=k, mesh=mesh,
                          sampler="gather", update_ref=True,
                          batch_size=batch_size)
    outs = []
    for _ in range(iters):
        outs.append(eng.iterate(refs))
    return eng, outs


def test_streaming_equals_resident(rng):
    nx, k, n = 64, 3, 22
    cfg = AlignConfig(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    base = make_class_bases(k, nx)
    data = (base[rng.integers(0, k, n)]
            + rng.normal(0, 0.05, (n, nx, nx))).astype(np.float32)
    refs = base.copy()

    eng_r, outs_r = _engine_results(data, refs, cfg, k, batch_size=n)
    eng_s, outs_s = _engine_results(data, refs, cfg, k, batch_size=8)
    assert eng_r.resident and not eng_s.resident

    for o_r, o_s in zip(outs_r, outs_s):
        np.testing.assert_array_equal(o_r.counts, o_s.counts)
        np.testing.assert_allclose(o_r.class_sums, o_s.class_sums,
                                   atol=5e-4 * np.abs(o_r.class_sums).max())
        np.testing.assert_allclose(o_r.sx_sum, o_s.sx_sum, atol=1e-3)
    p_r = eng_r.params_np()
    p_s = eng_s.params_np()
    np.testing.assert_array_equal(p_r.ref_id, p_s.ref_id)
    np.testing.assert_array_equal(p_r.mirror, p_s.mirror)
    np.testing.assert_allclose(p_r.angle, p_s.angle, atol=1e-3)
    np.testing.assert_allclose(p_r.shift_x, p_s.shift_x, atol=1e-5)


def test_streaming_with_mesh(rng):
    """Streamed batches over the 8-device mesh: batch rounds to a multiple
    of the dp size and results still match the resident run."""
    from cryo_ralib_tpu.parallel import make_mesh

    nx, k, n = 64, 2, 20
    cfg = AlignConfig(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    base = make_class_bases(k, nx)
    data = (base[rng.integers(0, k, n)]
            + rng.normal(0, 0.05, (n, nx, nx))).astype(np.float32)
    mesh = make_mesh(8)
    eng_r, outs_r = _engine_results(data, base.copy(), cfg, k, batch_size=n)
    eng_s, outs_s = _engine_results(data, base.copy(), cfg, k,
                                    batch_size=6, mesh=mesh)
    assert eng_s.batch == 8  # rounded up to the mesh size
    np.testing.assert_array_equal(outs_r[-1].counts, outs_s[-1].counts)
    np.testing.assert_array_equal(eng_r.params_np().ref_id,
                                  eng_s.params_np().ref_id)


def test_mref_driver_streamed(tmp_path, rng):
    """Full mref driver forced into streaming mode matches the resident
    driver run."""
    base = make_class_bases(3, 64)
    cls = rng.integers(0, 3, 18)
    data = (base[cls] + rng.normal(0, 0.05, (18, 64, 64))).astype(np.float32)
    kw = dict(ou=24, xr=1, yr=1, ts=1, maxit=2,
              user_func_name="ref_ali2d_no_filter",
              log=RunLogger(None, quiet=True), sampler="gather")
    res_r = mref_ali2d_tpu(data, base.copy(), **kw)
    res_s = mref_ali2d_tpu(data, base.copy(), batch_size=8, **kw)
    np.testing.assert_array_equal(res_r.assignments, res_s.assignments)
    np.testing.assert_allclose(res_r.params, res_s.params, atol=1e-3)
    np.testing.assert_array_equal(res_r.class_counts, res_s.class_counts)


def test_shard_map_equals_gspmd(rng):
    """Manual-SPMD (shard_map + in-step psum) matches the GSPMD step."""
    import jax.numpy as jnp

    from cryo_ralib_tpu.models.steps import make_align_step
    from cryo_ralib_tpu.parallel.mesh import make_mesh, shard_stack
    from cryo_ralib_tpu.params import AlignParams

    base = make_class_bases(2, 64)
    imgs = (base[rng.integers(0, 2, 16)]
            + rng.normal(0, 0.05, (16, 64, 64))).astype(np.float32)
    cfg = AlignConfig(img_dim=64, ring_num=24, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    mesh = make_mesh(8)
    refs = jnp.asarray(base)
    outs = []
    for dist in ("gspmd", "shard_map"):
        imgs_dev, gidx, valid = shard_stack(imgs, mesh)
        step = make_align_step(cfg, 2, update_ref=True, mesh=mesh,
                               sampler="gather", dist=dist)
        outs.append(step(imgs_dev, refs, AlignParams.zeros(16), gidx, valid))
    o1, o2 = outs
    np.testing.assert_array_equal(np.asarray(o1.counts), np.asarray(o2.counts))
    np.testing.assert_array_equal(np.asarray(o1.params.ref_id),
                                  np.asarray(o2.params.ref_id))
    np.testing.assert_allclose(np.asarray(o1.class_sums),
                               np.asarray(o2.class_sums), atol=1e-4)
    np.testing.assert_allclose(float(o1.sx_sum), float(o2.sx_sum), atol=1e-4)
