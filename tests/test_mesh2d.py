"""Large-K reference-axis sharding: the 2-D ('dp', 'ref') GSPMD mesh
produces the same StepOutput as the replicated 1-D 'dp' run.

This is the stand-in for the reference's per-ref ccf slot
layout (cuda/gpu_aln_noref.cu:1009-1143, `cu_ccf_mult_m` writing every
sbj x ref pair) at reference counts where the replicated ref stack and
its ring spectra would dominate device memory (SURVEY.md §5 "large-K mref").
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig
from cryo_ralib_tpu.models.steps import make_align_step
from cryo_ralib_tpu.parallel.mesh import make_mesh, make_mesh_2d, shard_stack
from cryo_ralib_tpu.params import AlignParams
from tests.conftest import make_class_bases, make_disc_stack


def _run_step(mesh, imgs, refs, cfg, k, ref_sharded):
    imgs_dev, gidx, valid = shard_stack(imgs, mesh)
    step = make_align_step(cfg, k, update_ref=True, mesh=mesh,
                           sampler="gather", dist="gspmd")
    refs_dev = jnp.asarray(refs)
    if ref_sharded:
        from jax.sharding import NamedSharding, PartitionSpec as P

        refs_dev = jax.device_put(refs_dev, NamedSharding(mesh, P("ref")))
    n = imgs_dev.shape[0]
    out = step(imgs_dev, refs_dev, AlignParams.zeros(n), gidx, valid)
    return jax.tree.map(np.asarray, out)


def _check_equal(o1, o2, n=None):
    # different dp sizes pad the particle axis differently; compare the
    # real-particle prefix
    n = n if n is not None else min(len(o1.params.ref_id),
                                    len(o2.params.ref_id))
    np.testing.assert_array_equal(o1.counts, o2.counts)
    np.testing.assert_array_equal(o1.params.ref_id[:n], o2.params.ref_id[:n])
    np.testing.assert_array_equal(o1.params.mirror[:n], o2.params.mirror[:n])
    np.testing.assert_allclose(o1.params.angle[:n], o2.params.angle[:n],
                               atol=1e-3)
    np.testing.assert_allclose(o1.class_sums, o2.class_sums,
                               atol=5e-4 * np.abs(o1.class_sums).max())
    np.testing.assert_allclose(o1.sx_sum, o2.sx_sum, atol=1e-3)


@pytest.mark.parametrize("k", [8, 32])
def test_mesh2d_matches_1d(rng, k):
    """(dp=4, ref=2) mesh with refs sharded P('ref') == replicated 1-D dp
    run, for K=8 and the BASELINE 'large-K mref' K=32 config."""
    nx, n = 64, 16
    cfg = AlignConfig(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    base = make_class_bases(k, nx)
    data = (base[rng.integers(0, k, n)]
            + rng.normal(0, 0.05, (n, nx, nx))).astype(np.float32)

    o_1d = _run_step(make_mesh(8), data, base, cfg, k, ref_sharded=False)
    o_2d = _run_step(make_mesh_2d(4, 2), data, base, cfg, k, ref_sharded=True)
    _check_equal(o_1d, o_2d, n=n)


def test_mesh2d_ref4(rng):
    """Deeper ref split (dp=2, ref=4) still agrees."""
    nx, n, k = 64, 12, 8
    cfg = AlignConfig(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    base = make_class_bases(k, nx)
    data = (base[rng.integers(0, k, n)]
            + rng.normal(0, 0.04, (n, nx, nx))).astype(np.float32)
    o_1d = _run_step(make_mesh(8), data, base, cfg, k, ref_sharded=False)
    o_2d = _run_step(make_mesh_2d(2, 4), data, base, cfg, k, ref_sharded=True)
    _check_equal(o_1d, o_2d, n=n)
