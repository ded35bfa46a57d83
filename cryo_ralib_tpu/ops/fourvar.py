"""2-D Fourier variance of an aligned particle stack (``varf2d``).

The reference's CPU twin computes ``vav, rvar = varf2d_MPI(myid, data,
tavg, mask, "a", CTF)`` per reffree iteration when ``--Fourvar`` is set,
then divides the average's spectrum by the variance
(``tavg = fft(Util.divn_img(fft(tavg), vav))``) and writes the variance
image as ``varf.hdf`` (test_reffree_gpu_align.py:777-831; varf2d itself
lives in SPHIRE ``sp_statistics``, outside the reference repo).  The GPU
path never implemented it.

Rebuild: per frequency bin of the rfft2 spectrum of each
*aligned* (transformed, masked) particle, accumulate the complex sum and
the power sum — two (H, F) f32 accumulator pairs that stream over
particle batches and psum over a dp mesh — and finalize the unbiased
sample variance

    var_k = (sum_i |f_ik|^2 - |sum_i f_ik|^2 / n) / (n - 1).

All transforms go through the matmul DFTs (ops/dft.py); nothing here
touches ``jnp.fft`` on the device path.  The average division and the
radial profile are (H, W)-sized host work.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..params import AlignParams
from .dft import rfft2_mm
from .fsc import _rfft2_weights, _shell_index


def fourier_moments(images, params: AlignParams, mask=None, valid=None,
                    engine: str = "shear", fast: bool = True):
    """Spectral moments of the aligned batch (jittable, psum-friendly).

    Applies each particle's alignment params, optionally multiplies the
    real-space mask (varf2d masks after interpolation), then accumulates
    rfft2 moments.

    Args:
      images: (N, H, W) raw particles.
      params: AlignParams with (N,) fields.
      mask: optional (H, W) real-space mask.
      valid: optional (N,) 0/1 weights (streaming pad exclusion).
      engine: "shear" (FFT-shear, the matmul engines' transform) or
        "exact" (bilinear ``transform_batch``, matches the CPU oracle
        bit-for-bit).
    Returns:
      (sum_re, sum_im, sum_sq, n): (H, F) f32 x3 and the scalar count.
    """
    if engine == "exact":
        from .transform import transform_batch

        t = transform_batch(images, params)
    else:
        from .transform import transform_batch_mm

        t = transform_batch_mm(images, params, fast=fast)
    if mask is not None:
        t = t * jnp.asarray(mask)[None]
    f = rfft2_mm(t)  # (N, H, F) complex64
    re, im = jnp.real(f), jnp.imag(f)
    if valid is None:
        n = jnp.float32(images.shape[0])
        w = None
    else:
        w = jnp.asarray(valid, jnp.float32)[:, None, None]
        n = jnp.sum(w)
    if w is None:
        return re.sum(0), im.sum(0), (re * re + im * im).sum(0), n
    return ((re * w).sum(0), (im * w).sum(0),
            ((re * re + im * im) * w).sum(0), n)


def finalize_variance(sum_re, sum_im, sum_sq, n):
    """Unbiased per-frequency sample variance from accumulated moments."""
    sum_re = np.asarray(sum_re, np.float64)
    sum_im = np.asarray(sum_im, np.float64)
    sum_sq = np.asarray(sum_sq, np.float64)
    n = float(n)
    var = (sum_sq - (sum_re ** 2 + sum_im ** 2) / n) / max(n - 1.0, 1.0)
    return np.maximum(var, 0.0)


def radial_variance(var):
    """Rotational average of the (H, F) variance — varf2d's ``rvar``.

    Hermitian-weighted mean per integer radius, length ``H//2 + 1``.
    """
    var = np.asarray(var, np.float64)
    h, f = var.shape
    w = h  # square images: full width equals height
    nbins = h // 2 + 1
    idx = _shell_index(h, w, nbins).ravel()
    mult = _rfft2_weights(h, w).ravel()
    num = np.bincount(idx, weights=var.ravel() * mult,
                      minlength=nbins + 1)[:nbins]
    cnt = np.bincount(idx, weights=mult, minlength=nbins + 1)[:nbins]
    return num / np.maximum(cnt, 1.0)


def variance_map(var):
    """Full-plane centered real image of the variance for ``varf.hdf``.

    The reference packs the complex variance image to a real one
    (``Util.pack_complex_to_real``) before writing; the equivalent view
    here is the hermitian unfold of the rfft2 half-plane, fftshifted so
    DC sits at the center.
    """
    var = np.asarray(var, np.float64)
    h, f = var.shape
    w = h
    full = np.zeros((h, w), np.float64)
    full[:, :f] = var
    # hermitian half: full[ky, kx] = var[-ky mod h, -kx mod w]
    kx = np.arange(f, w)
    src_kx = (w - kx) % w
    src_ky = (h - np.arange(h)) % h
    full[:, f:] = var[src_ky[:, None], src_kx[None, :]]
    return np.fft.fftshift(full).astype(np.float32)


@partial(jax.jit, static_argnames=("engine", "fast", "use_mask"))
def _moments_batch(im, p, v, mask, *, engine, fast, use_mask):
    return fourier_moments(im, p, mask=mask if use_mask else None,
                           valid=v, engine=engine, fast=fast)


def fourier_variance(data: np.ndarray, params: AlignParams, mask=None,
                     batch: int = 4096, engine: str = "shear",
                     fast: bool = True):
    """Host orchestration: chunked variance of a full (possibly
    larger-than-HBM) stack.  Returns ``(var (H, F), rvar (H//2+1,))``.
    """
    n, h, _w = data.shape
    b = min(batch, n)

    # module-level jit (not a fresh lambda per call): --Fourvar runs this
    # every reffree iteration, and a per-call lambda would defeat the jit
    # cache — one full retrace + recompile of the transform+rfft2 program
    # per iteration on a machine with no persistent XLA cache.  The mask
    # is a traced arg, so its VALUES may change without recompiling.
    use_mask = mask is not None
    mask_arr = (jnp.asarray(mask, jnp.float32) if use_mask
                else jnp.zeros((1, 1), jnp.float32))
    f = h // 2 + 1
    acc = [np.zeros((h, f), np.float64) for _ in range(3)]
    total = 0.0
    p_np = [np.asarray(x) for x in params]
    for start in range(0, n, b):
        end = min(start + b, n)
        m = end - start
        pad = b - m
        imgs = data[start:end]
        if pad:
            imgs = np.concatenate([imgs, np.zeros((pad, h, h), np.float32)])
        pb = AlignParams(*[
            np.concatenate([x[start:end],
                            np.zeros(pad, x.dtype)]) if pad else x[start:end]
            for x in p_np])
        valid = (np.arange(b) < m).astype(np.float32)
        sr, si, sq, cnt = _moments_batch(
            jnp.asarray(imgs), pb, jnp.asarray(valid), mask_arr,
            engine=engine, fast=fast, use_mask=use_mask)
        acc[0] += np.asarray(sr, np.float64)
        acc[1] += np.asarray(si, np.float64)
        acc[2] += np.asarray(sq, np.float64)
        total += float(cnt)
    var = finalize_variance(acc[0], acc[1], acc[2], total)
    return var.astype(np.float32), radial_variance(var).astype(np.float32)


def divide_by_variance(avg: np.ndarray, var: np.ndarray) -> np.ndarray:
    """``fft(Util.divn_img(fft(tavg), vav))``: divide the average's
    spectrum by the Fourier variance (host (H, W) work, numpy FFT).

    Zero-variance bins (possible only on degenerate synthetic data) keep
    the original coefficient instead of dividing by zero.
    """
    avg = np.asarray(avg, np.float64)
    var = np.asarray(var, np.float64)
    spec = np.fft.rfft2(avg)
    safe = np.where(var > 0.0, var, 1.0)
    return np.fft.irfft2(spec / safe, s=avg.shape).astype(np.float32)
