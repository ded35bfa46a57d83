"""Matmul-based DFTs, used in place of cuFFT.

The reference leans on cuFFT R2C/C2R plans for ring spectra and the ccf
table (cuda/gpu_aln_noref.cu:1585,2138).  Here the short transforms this
workload uses (ring_len=256 angles, <=few-hundred-pixel images) are
explicit DFT-by-matmul: one dense matmul that fuses with neighboring ops
and needs no special layout (the XLA CPU fft thunk rejects the non-major
layouts GSPMD produces under reference-axis sharding).  Whether
``jnp.fft`` (cuFFT) is faster per stage on the GPU is not measured yet.

Matrices are built once per (length) in float64 numpy, cached, and closed
over as literals in jitted code.  All matmuls run at HIGHEST precision
(full fp32) so spectra match ``np.fft`` to ~1e-6 relative.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

_HP = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def _rfft_mats(n: int):
    """(cos, -sin) matrices (n, n//2+1): X = x @ (C + iS)."""
    k = np.arange(n // 2 + 1)
    l = np.arange(n)[:, None]
    ang = -2.0 * np.pi * l * k / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@lru_cache(maxsize=None)
def _irfft_mats(n: int):
    """Real/imag synthesis matrices (n//2+1, n) for the normalized inverse:
    x_l = (1/n) sum_k m_k (Re X_k cos(2pi k l/n) - Im X_k sin(2pi k l/n))
    with hermitian multiplicity m_k = 2 except m_0 and m_{n/2} = 1."""
    f = n // 2 + 1
    k = np.arange(f)[:, None]
    l = np.arange(n)
    ang = 2.0 * np.pi * k * l / n
    mult = np.full((f, 1), 2.0)
    mult[0, 0] = 1.0
    if n % 2 == 0:
        mult[-1, 0] = 1.0
    cr = (mult * np.cos(ang) / n).astype(np.float32)
    ci = (-mult * np.sin(ang) / n).astype(np.float32)
    return cr, ci


@lru_cache(maxsize=None)
def _dft_mats(n: int):
    """Full complex DFT matrix as (cos, -sin) pair, (n, n)."""
    k = np.arange(n)
    l = np.arange(n)[:, None]
    ang = -2.0 * np.pi * l * k / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def rfft_mm(x, axis: int = -1, fast: bool = False):
    """np.fft.rfft-equivalent via two real matmuls. x real (..., n) -> complex64.

    ``fast`` runs the matmuls bf16 x bf16 -> f32 (tensor cores; ~0.4%
    relative error) instead of full f32."""
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    c, s = _rfft_mats(n)
    if fast:
        xb = x.astype(jnp.bfloat16)
        re = jnp.matmul(xb, jnp.asarray(c).astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        im = jnp.matmul(xb, jnp.asarray(s).astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        out = jax.lax.complex(re, im)
        if axis != -1:
            out = jnp.moveaxis(out, -1, axis)
        return out
    re = jnp.matmul(x, jnp.asarray(c), precision=_HP)
    im = jnp.matmul(x, jnp.asarray(s), precision=_HP)
    out = jax.lax.complex(re, im)
    if axis != -1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def irfft_mm(X, n: int, axis: int = -1, fast: bool = False,
             precision=None):
    """np.fft.irfft-equivalent (normalized) via one real matmul on [Re|Im].

    ``fast`` = bf16 x bf16 -> f32 (one bf16 pass, ~0.4% relative error);
    ``precision`` overrides the default HIGHEST for the f32 path (e.g.
    ``jax.lax.Precision.HIGH`` = 3-pass bf16, ~f32-accurate at half the
    HIGHEST cost)."""
    if axis != -1:
        X = jnp.moveaxis(X, axis, -1)
    cr, ci = _irfft_mats(n)
    mat = jnp.asarray(np.concatenate([cr, ci], axis=0))  # (2F, n)
    stacked = jnp.concatenate([jnp.real(X), jnp.imag(X)], axis=-1)
    if fast:
        out = jnp.matmul(stacked.astype(jnp.bfloat16),
                         mat.astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
    else:
        out = jnp.matmul(stacked, mat,
                         precision=_HP if precision is None else precision)
    if axis != -1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def rfft2_mm(img):
    """np.fft.rfft2-equivalent for (..., h, w) real input."""
    h, w = img.shape[-2], img.shape[-1]
    # rfft along w
    f = rfft_mm(img, axis=-1)  # (..., h, Fw) complex
    # full DFT along h (complex input): (C + iS) with real matmuls
    c, s = _dft_mats(h)
    cj = jnp.asarray(c)
    sj = jnp.asarray(s)
    re, im = jnp.real(f), jnp.imag(f)
    out_re = (jnp.einsum("...hf,hk->...kf", re, cj, precision=_HP)
              - jnp.einsum("...hf,hk->...kf", im, sj, precision=_HP))
    out_im = (jnp.einsum("...hf,hk->...kf", re, sj, precision=_HP)
              + jnp.einsum("...hf,hk->...kf", im, cj, precision=_HP))
    return jax.lax.complex(out_re, out_im)


def irfft2_mm(F, s: tuple[int, int]):
    """np.fft.irfft2-equivalent for (..., h, Fw) complex input, output (..., h, w)."""
    h, w = s
    # inverse full DFT along h: conjugate-transpose matrix / h
    c, sn = _dft_mats(h)
    cj = jnp.asarray(c) / h
    sj = jnp.asarray(-sn) / h  # conjugate
    re, im = jnp.real(F), jnp.imag(F)
    mid_re = (jnp.einsum("...kf,kh->...hf", re, cj, precision=_HP)
              - jnp.einsum("...kf,kh->...hf", im, sj, precision=_HP))
    mid_im = (jnp.einsum("...kf,kh->...hf", re, sj, precision=_HP)
              + jnp.einsum("...kf,kh->...hf", im, cj, precision=_HP))
    # irfft along w
    return irfft_mm(jax.lax.complex(mid_re, mid_im), w, axis=-1)
