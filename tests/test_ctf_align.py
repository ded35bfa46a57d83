"""CTF-aware alignment (ops/ctf_ops.py): golden-value unit tests and the
end-to-end restoration property.

The reference accepts --CTF and force-disables it
(test_mref_gpu_align.py:308); this capability implements the SPHIRE
semantics the flag was meant to enable (filt_ctf premultiplication +
Wiener average restoration), so correctness is pinned against the CTF
physics model (analysis.compute_ctf = compute_ctf_np,
src/utils_ralib.py:354-386) and against known inverse-problem behavior.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu.analysis.ctf import compute_ctf
from cryo_ralib_tpu.ops.ctf_ops import (CtfContext, class_ctf2_sum, ctf_rfft2,
                                        filt_ctf, rfft2_freqs, wiener_restore)
from cryo_ralib_tpu.utils.synthetic import asymmetric_templates


def test_ctf_rfft2_matches_compute_ctf():
    """The rfft2-grid CTF equals compute_ctf evaluated pointwise, for both
    the scalar and per-particle forms (incl. astigmatism)."""
    nx, apix = 32, 1.2
    freqs = rfft2_freqs(nx, apix).reshape(-1, 2)
    want = compute_ctf(freqs, 12000.0, 11000.0, 30.0, 300.0, 2.7, 0.1)
    got = ctf_rfft2(nx, apix, 12000.0, 11000.0, 30.0)
    np.testing.assert_allclose(got.reshape(-1), want, atol=1e-6)

    dfu = np.array([8000.0, 12000.0])
    dfv = np.array([8000.0, 11000.0])
    dfang = np.array([0.0, 30.0])
    batch = ctf_rfft2(nx, apix, dfu, dfv, dfang)
    assert batch.shape == (2, nx, nx // 2 + 1)
    np.testing.assert_allclose(batch[1].reshape(-1), want, atol=1e-6)
    want0 = compute_ctf(freqs, 8000.0, 8000.0, 0.0, 300.0, 2.7, 0.1)
    np.testing.assert_allclose(batch[0].reshape(-1), want0, atol=1e-6)


def test_filt_ctf_identity_and_composition():
    """ctf == 1 is the identity; applying ctf twice equals applying
    ctf^2 once (matmul-DFT round-trip exactness)."""
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.standard_normal((3, 24, 24)).astype(np.float32))
    ones = jnp.ones((3, 24, 13), jnp.float32)
    np.testing.assert_allclose(np.asarray(filt_ctf(imgs, ones)),
                               np.asarray(imgs), atol=1e-4)
    ctf = jnp.asarray(ctf_rfft2(24, 1.0, np.full(3, 15000.0),
                                np.full(3, 15000.0), np.zeros(3)))
    twice = filt_ctf(filt_ctf(imgs, ctf), ctf)
    once = filt_ctf(imgs, ctf * ctf)
    np.testing.assert_allclose(np.asarray(twice), np.asarray(once), atol=1e-3)


def test_class_ctf2_sum_matches_loop():
    rng = np.random.default_rng(1)
    ctf = jnp.asarray(rng.standard_normal((6, 8, 5)).astype(np.float32))
    rid = np.array([0, 1, 0, 2, 1, 0], np.int32)
    got = np.asarray(class_ctf2_sum(ctf, jnp.asarray(rid), 3))
    want = np.zeros((3, 8, 5), np.float32)
    for i, r in enumerate(rid):
        want[r] += np.asarray(ctf[i]) ** 2
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_wiener_reduces_to_mean():
    """With ctf == 1 and snr -> inf, the Wiener restore of a summed class
    equals the plain mean."""
    rng = np.random.default_rng(2)
    imgs = rng.standard_normal((5, 16, 16)).astype(np.float32)
    summed = jnp.asarray(imgs.sum(0))[None]
    ctf2 = jnp.full((1, 16, 9), 5.0)  # sum of ctf^2 = N * 1
    out = np.asarray(wiener_restore(summed, ctf2, snr=1e9))
    np.testing.assert_allclose(out[0], imgs.mean(0), atol=1e-4)


def test_ctf_context_restores_template():
    """Golden restoration: particles are a template imaged under CTFs with
    opposite-sign passbands (defocus spread); the plain average suffers
    sign cancellation, the CTF path restores the template.  This is the
    '--CTF changes results' guarantee."""
    nx, n = 48, 32
    tmpl = asymmetric_templates(1, nx)[0]
    rng = np.random.default_rng(3)
    dfu = rng.uniform(8000.0, 25000.0, n)
    ctf = ctf_rfft2(nx, 1.5, dfu, dfu, np.zeros(n))
    data = np.asarray(filt_ctf(jnp.asarray(np.broadcast_to(
        tmpl, (n, nx, nx))), jnp.asarray(ctf)))
    data = data + rng.normal(0, 0.02, data.shape).astype(np.float32)

    plain = data.mean(0)
    ctx = CtfContext(nx, dict(dfu=dfu, apix=1.5), snr=10.0)
    # the drivers premultiply before summing; Wiener then divides by
    # sum(ctf^2) + 1/snr
    pre = np.asarray(ctx.premultiply(data))
    restored = ctx.restore(jnp.asarray(pre.sum(0))[None])[0]

    def corr(a, b):
        a = a - a.mean(); b = b - b.mean()
        return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))

    c_plain = corr(plain, tmpl)
    c_rest = corr(restored, tmpl)
    assert c_rest > 0.95, c_rest
    assert c_rest > c_plain + 0.02, (c_rest, c_plain)


def test_ctf_context_chunked_equals_whole():
    """Streaming-scale contract: a small batch size (with a padded tail
    chunk) gives the same premultiply and Wiener restore as one batch."""
    rng = np.random.default_rng(9)
    nx, n, k = 32, 11, 2
    imgs = rng.standard_normal((n, nx, nx)).astype(np.float32)
    dfu = rng.uniform(8000, 25000, n)
    assign = rng.integers(0, k, n)
    summed = rng.standard_normal((k, nx, nx)).astype(np.float32)
    whole = CtfContext(nx, dict(dfu=dfu, apix=1.5), snr=5.0, batch=n)
    chunked = CtfContext(nx, dict(dfu=dfu, apix=1.5), snr=5.0, batch=4)
    np.testing.assert_allclose(chunked.premultiply(imgs),
                               whole.premultiply(imgs), atol=1e-5)
    np.testing.assert_allclose(chunked.restore(summed, assign),
                               whole.restore(summed, assign), atol=1e-5)


def test_load_ctf_params_star_defaults(tmp_path):
    """CLI CTF loader: a STAR file without DefocusV must default dfv=dfu
    (not 0 = extreme astigmatism), and the file's
    DetectorPixelSize/Magnification must supply apix when --apix is not
    given (code-review r2 findings)."""
    import argparse

    from cryo_ralib_tpu.cli.common import load_ctf_params

    star = tmp_path / "p.star"
    star.write_text(
        "data_\n\nloop_\n"
        "_rlnDefocusU #1\n_rlnDetectorPixelSize #2\n_rlnMagnification #3\n"
        "12000.0 5.0 29411.76\n15000.0 5.0 29411.76\n")
    args = argparse.Namespace(CTF=True, ctf_file=str(star), apix=None,
                              voltage=300.0, Cs=2.7, ac=0.1)
    p = load_ctf_params(args, 2)
    np.testing.assert_allclose(p["dfv"], p["dfu"])
    assert p["apix"] == pytest.approx(5.0 * 10000 / 29411.76, rel=1e-4)

    # explicit --apix wins over file metadata
    args.apix = 1.25
    assert load_ctf_params(args, 2)["apix"] == pytest.approx(1.25)

    # text path without --apix defaults to 1.0
    txt = tmp_path / "d.txt"
    txt.write_text("12000\n15000\n")
    args = argparse.Namespace(CTF=True, ctf_file=str(txt), apix=None,
                              voltage=300.0, Cs=2.7, ac=0.1)
    p = load_ctf_params(args, 2)
    assert p["apix"] == 1.0
    np.testing.assert_allclose(p["dfv"], p["dfu"])


def test_mref_driver_ctf_changes_results(rng, tmp_path):
    """The mref driver with CTF=True produces different (better-restored)
    references than CTF=False on CTF-corrupted data, and errors without
    ctf_params."""
    from cryo_ralib_tpu.models import mref_ali2d_tpu
    from cryo_ralib_tpu.utils.log import RunLogger

    nx, n, k = 48, 24, 2
    base = asymmetric_templates(k, nx)
    cls = rng.integers(0, k, n)
    dfu = rng.uniform(8000.0, 25000.0, n)
    ctf = ctf_rfft2(nx, 1.5, dfu, dfu, np.zeros(n))
    data = np.asarray(filt_ctf(jnp.asarray(base[cls]), jnp.asarray(ctf)))
    data = data + rng.normal(0, 0.05, data.shape).astype(np.float32)

    kw = dict(ou=18, xr=1, yr=1, ts=1, maxit=2,
              user_func_name="ref_ali2d_no_filter",
              log=RunLogger(None, quiet=True), sampler="gather")
    res_plain = mref_ali2d_tpu(data, base.copy(), **kw)
    res_ctf = mref_ali2d_tpu(data, base.copy(), CTF=True, snr=10.0,
                             ctf_params=dict(dfu=dfu, apix=1.5), **kw)
    assert not np.allclose(res_plain.references, res_ctf.references)

    with pytest.raises(ValueError, match="ctf_params"):
        mref_ali2d_tpu(data, base.copy(), CTF=True, **kw)

def test_per_particle_phase_shift_broadcasts():
    """Volta-style varying phase shifts per particle: the
    CTF model must differ per particle when the phase column varies."""
    from cryo_ralib_tpu.ops.ctf_ops import CtfContext

    nx = 16
    ctx = CtfContext(nx, dict(dfu=np.full(3, 15000.0),
                              phase_shift=np.array([0.0, 45.0, 90.0]),
                              apix=1.2))
    assert ctx.df.shape == (3, 4)
    chunks = list(ctx._chunks())
    ctf = np.asarray(ctx._ctf_chunk(chunks[0][2]))
    assert not np.allclose(ctf[0], ctf[1])
    # scalar phase reproduces the constant-column result
    ctx_c = CtfContext(nx, dict(dfu=np.full(3, 15000.0), phase_shift=45.0,
                                apix=1.2))
    ctf_c = np.asarray(ctx_c._ctf_chunk(list(ctx_c._chunks())[0][2]))
    np.testing.assert_allclose(ctf_c[1], ctf[1], atol=1e-6)


def test_load_ctf_params_requires_defocus(tmp_path):
    """A STAR file without _rlnDefocusU must error, not run an all-zero
    CTF model."""
    import argparse

    from cryo_ralib_tpu.cli.common import load_ctf_params

    star = tmp_path / "noctf.star"
    star.write_text("""
data_
loop_
_rlnImageName #1
_rlnDetectorPixelSize #2
1@a.mrcs 1.0
2@a.mrcs 1.0
""")
    args = argparse.Namespace(CTF=True, ctf_file=str(star), apix=None,
                              voltage=300.0, Cs=2.7, ac=0.1, snr=1.0)
    with pytest.raises(SystemExit):
        load_ctf_params(args, 2)


def test_load_ctf_params_star_phase_column(tmp_path):
    """Per-particle _rlnPhaseShift rows reach ctf_params intact."""
    import argparse

    from cryo_ralib_tpu.cli.common import load_ctf_params

    star = tmp_path / "ps.star"
    star.write_text("""
data_
loop_
_rlnImageName #1
_rlnDefocusU #2
_rlnDefocusV #3
_rlnDefocusAngle #4
_rlnPhaseShift #5
1@a.mrcs 12000 11000 30 0
2@a.mrcs 13000 12500 35 45
""")
    args = argparse.Namespace(CTF=True, ctf_file=str(star), apix=1.1,
                              voltage=300.0, Cs=2.7, ac=0.1, snr=1.0)
    p = load_ctf_params(args, 2)
    np.testing.assert_allclose(np.asarray(p["phase_shift"], float),
                               [0.0, 45.0])
