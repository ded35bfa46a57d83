"""Device-resident multi-iteration loop (models/device_loop.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig
from cryo_ralib_tpu.models.device_loop import (make_device_loop,
                                               ref_free_alignment_2d)
from cryo_ralib_tpu.ops.filters import filt_tanl, filt_tanl_dyn
from cryo_ralib_tpu.params import AlignParams
from cryo_ralib_tpu.utils.synthetic import class_templates, scattered_stack


def test_filt_tanl_dyn_matches_static(rng):
    img = jnp.asarray(rng.standard_normal((48, 48)).astype(np.float32))
    a = np.asarray(filt_tanl(img, 0.22, 0.1))
    b = np.asarray(filt_tanl_dyn(img, jnp.float32(0.22), jnp.float32(0.1)))
    np.testing.assert_allclose(a, b, atol=1e-5)
    # disabled filter passes through
    c = np.asarray(filt_tanl_dyn(img, jnp.float32(0.0), jnp.float32(0.1)))
    np.testing.assert_allclose(c, np.asarray(img), atol=1e-4)


def test_device_loop_aligns(rng):
    from cryo_ralib_tpu.utils.synthetic import blob_stack

    base = blob_stack(1, 64, blobs=4, noise=0.0, seed=13)  # asymmetric
    imgs, _, angs, _ = scattered_stack(base, 24, max_shift=1, seed=13)
    params, avg = ref_free_alignment_2d(imgs, n_iter=3, ou=24, xr=1, ts=1,
                                        cutoff=0.0, sampler="gather")
    assert params.angle.shape == (24,)
    # alignment is defined up to a global rotation, so test the gauge
    # invariants: (a) the aligned average is much sharper than the raw
    # mean (the a1 criterion), (b) recovered angles undo the generating
    # rotations up to one global constant (circular std ~ 0)
    e_raw = float((imgs.mean(0) ** 2).sum())
    e_avg = float((avg ** 2).sum())
    assert e_avg > 2.0 * e_raw, (e_raw, e_avg)
    m = np.asarray(params.mirror)
    rel = np.deg2rad(np.asarray(params.angle) + angs)[m == 0]
    r = np.abs(np.mean(np.exp(1j * rel)))  # 1.0 = perfectly consistent
    assert r > 0.95, r


@pytest.mark.parametrize("sampler", ["gather", "matmul"])
def test_device_loop_one_iter_matches_step(rng, sampler):
    """One loop iteration == one align_step + average rebuild.

    The matmul case exercises the in-loop fused transform+class-sum path
    (class_sum_transform_mm) of the tent/template engines."""
    from cryo_ralib_tpu.models.steps import align_step

    base = class_templates(1, 64)
    imgs, _, _, _ = scattered_stack(base, 10, max_shift=1, seed=17)
    n = 10
    cfg = AlignConfig(img_dim=64, ring_num=24, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    avg0 = imgs.mean(0).astype(np.float32)
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones(n, jnp.float32)

    loop = make_device_loop(cfg, 1, np.zeros(1, np.float32),
                            sampler=sampler, shift_chunk=9)
    p_loop, avg_loop = loop(jnp.asarray(imgs), avg0, AlignParams.zeros(n),
                            gidx, valid)

    out = align_step(jnp.asarray(imgs), jnp.asarray(avg0)[None],
                     AlignParams.zeros(n), gidx, valid, cfg=cfg,
                     n_classes=1, update_ref=False, sampler=sampler,
                     shift_chunk=9)
    np.testing.assert_allclose(np.asarray(p_loop.angle),
                               np.asarray(out.params.angle), atol=5e-4)
    want_avg = (np.asarray(out.class_sums)[0, 0]
                + np.asarray(out.class_sums)[0, 1]) / n
    # the FFT-shear spectra sums fuse differently inside the fori_loop
    # program than standalone — float32 ordering noise, not semantics
    atol = 1e-4 if sampler == "gather" else 5e-3
    np.testing.assert_allclose(np.asarray(avg_loop), want_avg, atol=atol)


def test_device_loop_sharded(rng):
    from cryo_ralib_tpu.parallel import make_mesh
    from cryo_ralib_tpu.parallel.mesh import shard_stack

    base = class_templates(1, 64)
    imgs, _, _, _ = scattered_stack(base, 16, max_shift=1, seed=19)
    cfg = AlignConfig(img_dim=64, ring_num=24, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    cut = np.zeros(2, np.float32)

    loop1 = make_device_loop(cfg, 2, cut, sampler="gather", shift_chunk=9)
    p1, a1 = loop1(jnp.asarray(imgs), imgs.mean(0), AlignParams.zeros(16),
                   jnp.arange(16), jnp.ones(16))

    mesh = make_mesh(8)
    imgs_dev, gidx, valid = shard_stack(imgs, mesh)
    loop8 = make_device_loop(cfg, 2, cut, mesh=mesh, sampler="gather",
                             shift_chunk=9)
    p8, a8 = loop8(imgs_dev, imgs.mean(0), AlignParams.zeros(16), gidx, valid)
    np.testing.assert_allclose(np.asarray(p1.angle), np.asarray(p8.angle)[:16],
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a8),
                               atol=2e-4 * np.abs(np.asarray(a1)).max())


@pytest.mark.parametrize("sampler", ["gather", "matmul", "template"])
def test_mref_device_loop_one_iter_matches_step(rng, sampler):
    from cryo_ralib_tpu.models.device_loop import make_mref_device_loop
    from cryo_ralib_tpu.models.steps import align_step

    k, nx, n = 3, 64, 12
    base = class_templates(k, nx)
    imgs, cls, _, _ = scattered_stack(base, n, max_shift=1, seed=31)
    cfg = AlignConfig(img_dim=nx, ring_num=24, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones(n, jnp.float32)

    loop = make_mref_device_loop(cfg, 1, k, np.zeros(1, np.float32),
                                 sampler=sampler, shift_chunk=9)
    p_loop, refs_loop = loop(jnp.asarray(imgs), base, AlignParams.zeros(n),
                             gidx, valid)

    out = align_step(jnp.asarray(imgs), jnp.asarray(base),
                     AlignParams.zeros(n), gidx, valid, cfg=cfg,
                     n_classes=k, update_ref=True, sampler=sampler,
                     shift_chunk=9)
    np.testing.assert_array_equal(np.asarray(p_loop.ref_id),
                                  np.asarray(out.params.ref_id))
    s = np.asarray(out.class_sums)
    c = np.asarray(out.counts)
    want = (s[:, 0] + s[:, 1]) / np.maximum(c, 1)[:, None, None]
    keep = c < 4
    want[keep] = base[keep]
    # matmul: FFT-shear sums fuse differently inside the fori_loop than
    # standalone; worst float32 ordering deviation seen is ~0.1% relative
    # on O(6) template pixels
    atol = 1e-4 if sampler == "gather" else 1e-2
    np.testing.assert_allclose(np.asarray(refs_loop), want, atol=atol)


def test_mref_device_loop_converges(rng):
    from cryo_ralib_tpu.analysis import purity_score
    from cryo_ralib_tpu.models.device_loop import make_mref_device_loop

    k, nx, n = 3, 64, 30
    base = class_templates(k, nx)
    imgs, cls, _, _ = scattered_stack(base, n, max_shift=1, seed=37)
    cfg = AlignConfig(img_dim=nx, ring_num=24, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    loop = make_mref_device_loop(cfg, 3, k, np.zeros(3, np.float32),
                                 sampler="gather", shift_chunk=9)
    p, refs = loop(jnp.asarray(imgs), base, AlignParams.zeros(n),
                   jnp.arange(n), jnp.ones(n))
    assert purity_score(cls, np.asarray(p.ref_id)) > 0.9
