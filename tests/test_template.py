"""Template-matmul search engine (sampler="template") parity tests.

The engine (ops/template_search.py) computes the whole ccf table as one
pixel-domain matmul against splat-back-projected rotated references —
algebraically the production table, so winners must match the matmul
sampler and the NumPy oracle up to bf16 tie noise.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu import AlignConfig, AlignParams
from cryo_ralib_tpu.ops.search import (decode_params, prepare_ref_spectra,
                                       rotational_shift_search_mm)
from cryo_ralib_tpu.ops.template_search import (build_template_matrix,
                                                template_geometry,
                                                template_search,
                                                template_supported)
from cryo_ralib_tpu.utils import oracle
from tests.conftest import make_class_bases, make_disc_stack

NX = 64
K = 3


def _cfg(**kw):
    base = dict(img_dim=NX, ring_num=20, ring_len=128,
                shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0)
    base.update(kw)
    return AlignConfig(**base)


@pytest.fixture(scope="module")
def stack():
    r = np.random.default_rng(17)
    return make_disc_stack(r, 8, NX)


@pytest.fixture(scope="module")
def refs():
    return make_class_bases(K, NX).astype(np.float32)


def test_template_supported_gates():
    assert template_supported(_cfg(), K)
    # fractional grids run via per-remainder splat groups (ts=0.5 -> 4)
    assert template_supported(_cfg(shift_step=0.5), K)
    # but a grid with too many unique remainders is rejected
    # (ts=0.1 -> 10x10 = 100 groups > MAX_FRAC_GROUPS)
    assert not template_supported(
        _cfg(shift_step=0.1, shift_rng_x=0.5, shift_rng_y=0.5), K)
    # window exceeding the image edge -> reject (ring 29 + shift 2 + 1)
    assert not template_supported(_cfg(ring_num=29), K)


def test_template_matrix_columns_match_ccf_rows(stack, refs):
    """Spot-check: TM columns dotted with a windowed image equal the
    production ccf rows at the same (m, s, k)."""
    cfg = _cfg()
    lo, width, _ = template_geometry(cfg)
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    tm = np.asarray(build_template_matrix(ref_fw, cfg)).astype(np.float32)
    img = stack[0]
    win = img[lo:lo + width, lo:lo + width].reshape(-1)
    res = rotational_shift_search_mm(jnp.asarray(stack[:1]), ref_fw,
                                     AlignParams.zeros(1), cfg, fast=False)
    # reconstruct the winning row from TM columns
    m, s, k = (int(res.best_mirror[0]), int(res.best_sidx[0]),
               int(res.best_ref[0]))
    base = ((m * cfg.n_shifts + s) * K + k) * cfg.ring_len
    row_tm = tm[base:base + cfg.ring_len] @ win
    row_ref = np.asarray(res.best_row[0])
    assert np.allclose(row_tm, row_ref,
                       atol=5e-3 * np.abs(row_ref).max())


@pytest.mark.parametrize("mode,mirror,step", [("F", True, 1.0),
                                              ("F", False, 1.0),
                                              ("H", True, 1.0),
                                              ("F", True, 0.5)])
def test_template_matches_matmul_sampler(stack, refs, mode, mirror, step):
    # step=0.5 is the fractional-grid path: four splat groups, the same
    # tent algebra as the matmul sampler's per-shift tables
    cfg = _cfg(mode=mode, mirror=mirror, shift_step=step)
    params = AlignParams.zeros(stack.shape[0])
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res_t = template_search(jnp.asarray(stack), ref_fw, params, cfg)
    res_m = rotational_shift_search_mm(jnp.asarray(stack), ref_fw, params,
                                       cfg, fast=True)
    for i in range(stack.shape[0]):
        same = (int(res_t.best_mirror[i]) == int(res_m.best_mirror[i])
                and int(res_t.best_sidx[i]) == int(res_m.best_sidx[i])
                and int(res_t.best_ref[i]) == int(res_m.best_ref[i])
                and int(res_t.best_aidx[i]) == int(res_m.best_aidx[i]))
        gap = abs(float(res_t.best_val[i]) - float(res_m.best_val[i]))
        assert same or gap < 5e-3 * abs(float(res_m.best_val[i])), i
        if same:
            np.testing.assert_allclose(
                np.asarray(res_t.best_row[i]), np.asarray(res_m.best_row[i]),
                atol=5e-3 * float(jnp.abs(res_m.best_row[i]).max()))


def test_template_accumulated_fractional_shifts(stack, refs):
    """Nonzero fractional accumulated shifts go through the same
    two-stage pre-translate as the matmul sampler — decoded params must
    agree."""
    cfg = _cfg()
    n = stack.shape[0]
    r = np.random.default_rng(5)
    params = AlignParams(
        angle=jnp.zeros(n, jnp.float32),
        shift_x=jnp.asarray(r.uniform(-1.5, 1.5, n).astype(np.float32)),
        shift_y=jnp.asarray(r.uniform(-1.5, 1.5, n).astype(np.float32)),
        mirror=jnp.zeros(n, jnp.int32),
        ref_id=jnp.zeros(n, jnp.int32))
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res_t = template_search(jnp.asarray(stack), ref_fw, params, cfg)
    res_m = rotational_shift_search_mm(jnp.asarray(stack), ref_fw, params,
                                       cfg, fast=True)
    dec_t = decode_params(res_t, params, cfg)
    dec_m = decode_params(res_m, params, cfg)
    agree = 0
    for i in range(n):
        if (int(res_t.best_mirror[i]) == int(res_m.best_mirror[i])
                and int(res_t.best_sidx[i]) == int(res_m.best_sidx[i])
                and int(res_t.best_ref[i]) == int(res_m.best_ref[i])):
            da = abs(float(dec_t.angle[i]) - float(dec_m.angle[i])) % 360.0
            assert min(da, 360.0 - da) < 0.1, i
            assert abs(float(dec_t.shift_x[i])
                       - float(dec_m.shift_x[i])) < 1e-4
            agree += 1
    assert agree >= n - 1  # allow one bf16 tie swap


def test_template_overshooting_grid_matches_matmul(stack, refs):
    """Step-rounding can overshoot shift_rng (step 0.75, rng 1.9 ->
    grid value -2.25).  The geometry must pad from the ACTUAL grid
    values — a pad sized from the range would let lax.slice silently
    clamp the -2.25 template to the -1.25 roll (code-review r3 #1)."""
    cfg = _cfg(shift_step=0.75, shift_rng_x=1.9, shift_rng_y=1.9)
    assert np.abs(cfg.shift_x_vals).max() > 1.9  # overshoot present
    assert template_supported(cfg, K)
    params = AlignParams.zeros(stack.shape[0])
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res_t = template_search(jnp.asarray(stack), ref_fw, params, cfg)
    res_m = rotational_shift_search_mm(jnp.asarray(stack), ref_fw, params,
                                       cfg, fast=True)
    for i in range(stack.shape[0]):
        same = all(int(getattr(res_t, f)[i]) == int(getattr(res_m, f)[i])
                   for f in ("best_mirror", "best_sidx", "best_ref",
                             "best_aidx"))
        gap = abs(float(res_t.best_val[i]) - float(res_m.best_val[i]))
        assert same or gap < 5e-3 * abs(float(res_m.best_val[i])), i


def test_template_streamed_matches_materialized(stack, refs):
    """The streamed search (column chunks built on the fly from the
    padded template blocks, no materialized matrix) is bit-identical to
    the materialized path — both slice the same blocks."""
    cfg = _cfg(shift_step=0.5)  # fractional: exercises multi-block lookup
    params = AlignParams.zeros(stack.shape[0])
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res_m = template_search(jnp.asarray(stack), ref_fw, params, cfg,
                            stream=False)
    res_s = template_search(jnp.asarray(stack), ref_fw, params, cfg,
                            stream=True)
    for f in ("best_val", "best_row", "best_aidx", "best_sidx",
              "best_ref", "best_mirror"):
        np.testing.assert_array_equal(np.asarray(getattr(res_m, f)),
                                      np.asarray(getattr(res_s, f)), f)


def test_template_large_k_streams():
    """A K large enough that the materialized matrix exceeds the memory
    budget still passes the gate (the blocks fit; the search streams)."""
    from cryo_ralib_tpu.ops.template_search import (
        TEMPLATE_MATRIX_BUDGET_BYTES, _template_matrix_bytes)

    cfg = _cfg()
    big_k = 256
    assert _template_matrix_bytes(cfg, big_k) > TEMPLATE_MATRIX_BUDGET_BYTES
    assert template_supported(cfg, big_k)


def test_template_recovers_known_transforms(refs):
    """Structured stack (rotated/shifted/mirrored copies of the refs):
    the template engine recovers class, mirror and pose like the exact
    gather engine and the NumPy oracle (blob stacks are tie-dominated —
    even the gather sampler agrees only ~50% with the oracle there, so
    structured data is the meaningful contract)."""
    from cryo_ralib_tpu.ops.search import rotational_shift_search

    cfg = _cfg()
    r = np.random.default_rng(23)
    imgs, true_k = [], []
    for i in range(9):
        k = i % K
        ang = float(r.uniform(0, 360))
        sx, sy = int(r.integers(-2, 3)), int(r.integers(-2, 3))
        m = int(r.integers(0, 2))
        imgs.append(oracle.transform_np(refs[k].astype(np.float64), ang,
                                        sx, sy, m).astype(np.float32))
        true_k.append(k)
    imgs = np.stack(imgs)
    params = AlignParams.zeros(imgs.shape[0])
    ref_fw = prepare_ref_spectra(jnp.asarray(refs), cfg)
    res_t = template_search(jnp.asarray(imgs), ref_fw, params, cfg)
    res_g = rotational_shift_search(jnp.asarray(imgs), ref_fw, params, cfg)
    new_t = decode_params(res_t, params, cfg)
    assert (np.asarray(new_t.ref_id) == np.asarray(true_k)).mean() >= 8 / 9
    same = 0
    for i in range(imgs.shape[0]):
        same += (int(res_t.best_mirror[i]) == int(res_g.best_mirror[i])
                 and int(res_t.best_ref[i]) == int(res_g.best_ref[i]))
    assert same >= imgs.shape[0] - 1


def test_template_align_step_end_to_end(stack, refs):
    """align_step(sampler='template') produces the same assignments and
    class sums as the matmul sampler."""
    from cryo_ralib_tpu.models.steps import align_step

    cfg = _cfg()
    n = stack.shape[0]
    params = AlignParams.zeros(n)
    gidx = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones(n, jnp.float32)
    out_t = align_step(jnp.asarray(stack), jnp.asarray(refs), params, gidx,
                       valid, cfg, n_classes=K, sampler="template")
    out_m = align_step(jnp.asarray(stack), jnp.asarray(refs), params, gidx,
                       valid, cfg, n_classes=K, sampler="matmul")
    assert (np.asarray(out_t.params.ref_id)
            == np.asarray(out_m.params.ref_id)).mean() >= 1.0 - 1.0 / n
    np.testing.assert_array_equal(np.asarray(out_t.counts).sum(), n)
    assert np.all(np.isfinite(np.asarray(out_t.class_sums)))


def test_template_gspmd_mesh_streamed(stack, refs, monkeypatch):
    """The streamed (block-sliced) search partitions under GSPMD like
    the materialized one: force streaming by shrinking the matrix
    budget below this config's ~78 MB matrix (blocks are ~4 MB)."""
    import importlib

    # ops/__init__ re-exports the function under the module's name, so a
    # plain "import ... as" would bind the function — go via importlib
    ts_mod = importlib.import_module("cryo_ralib_tpu.ops.template_search")
    from cryo_ralib_tpu.models.steps import align_step, make_align_step
    from cryo_ralib_tpu.parallel.mesh import make_mesh, shard_stack

    monkeypatch.setattr(ts_mod, "TEMPLATE_MATRIX_BUDGET_BYTES", 10 << 20)
    cfg = _cfg()
    assert template_supported(cfg, K)  # blocks fit the shrunken budget
    assert ts_mod._template_matrix_bytes(cfg, K) > 10 << 20  # matrix not
    n = stack.shape[0]
    mesh = make_mesh(4)
    step = make_align_step(cfg, n_classes=K, mesh=mesh, sampler="template",
                           dist="gspmd", donate=False)
    imgs, gidx, valid = shard_stack(stack, mesh)
    out = step(imgs, jnp.asarray(refs),
               AlignParams.zeros(int(imgs.shape[0])), gidx, valid)
    ref_out = align_step(jnp.asarray(stack), jnp.asarray(refs),
                         AlignParams.zeros(n),
                         jnp.arange(n, dtype=jnp.int32),
                         jnp.ones(n, jnp.float32), cfg, n_classes=K,
                         sampler="template")
    np.testing.assert_array_equal(np.asarray(out.counts),
                                  np.asarray(ref_out.counts))
    np.testing.assert_allclose(np.asarray(out.class_sums),
                               np.asarray(ref_out.class_sums),
                               rtol=2e-2, atol=2e-2)


def test_template_gspmd_mesh(stack, refs):
    """The template step partitions under GSPMD over a dp mesh and
    matches the single-device run."""
    from cryo_ralib_tpu.models.steps import make_align_step
    from cryo_ralib_tpu.parallel.mesh import make_mesh, shard_stack

    cfg = _cfg()
    n = stack.shape[0]
    mesh = make_mesh(4)
    step = make_align_step(cfg, n_classes=K, mesh=mesh, sampler="template",
                           dist="gspmd", donate=False)
    imgs, gidx, valid = shard_stack(stack, mesh)
    params = AlignParams.zeros(int(imgs.shape[0]))
    out = step(imgs, jnp.asarray(refs), params, gidx, valid)

    from cryo_ralib_tpu.models.steps import align_step
    ref_out = align_step(jnp.asarray(stack), jnp.asarray(refs),
                         AlignParams.zeros(n),
                         jnp.arange(n, dtype=jnp.int32),
                         jnp.ones(n, jnp.float32), cfg, n_classes=K,
                         sampler="template")
    np.testing.assert_allclose(np.asarray(out.class_sums),
                               np.asarray(ref_out.class_sums),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(np.asarray(out.counts),
                                  np.asarray(ref_out.counts))
