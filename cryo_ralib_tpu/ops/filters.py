"""Fourier-space filters and shifts.

Equivalents of the SPHIRE/EMAN2 filters the reference drivers rely on:
``filt_tanl`` (the FSC-driven tangent low-pass used by the ``ref_ali2d``
user function and by ``cu_apply_tanl_filter_to_tex``,
cuda/gpu_aln_noref.cu:786-816), ``fshift`` (sub-pixel Fourier shift used
for average-centering, test_reffree_gpu_align.py:407), and a Butterworth
low-pass (``filt_btwl``, imported by the mref drivers).

All operate on (..., H, W) real batches via matmul-DFT rfft2 (ops/dft.py)
and are jit/vmap safe.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .dft import irfft2_mm, rfft2_mm


def _freq_grid(h: int, w: int):
    """|f| grid for rfft2 layout, in absolute units (0..~0.707 at corners).

    fx = kx/w for kx in 0..w//2 ; fy = ky/h signed.  Matches EMAN2's
    absolute frequency convention (cutoffs in [0, 0.5]).
    """
    fy = np.fft.fftfreq(h).astype(np.float32)  # ky/h signed
    fx = np.fft.rfftfreq(w).astype(np.float32)  # kx/w in [0, 0.5]
    return np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)


def tanl_response(freq: np.ndarray, cutoff: float, falloff: float) -> np.ndarray:
    """Tangent low-pass transfer function
    ``0.5*(tanh(c*(f+cutoff)) - tanh(c*(f-cutoff)))``, c = pi/(2*falloff*cutoff)
    (cuda/gpu_aln_noref.cu:805-814; http://sparx-em.org/sparxwiki/filt_tanl).
    """
    cutoff = float(cutoff)
    falloff = float(falloff)
    if cutoff <= 0.0 or falloff <= 0.0:
        return np.ones_like(freq)
    c = np.pi / (2.0 * falloff * cutoff)
    return (0.5 * (np.tanh(c * (freq + cutoff)) - np.tanh(c * (freq - cutoff)))).astype(np.float32)


def filt_tanl(img, cutoff: float, falloff: float):
    """Apply the tangent low-pass filter to (..., H, W) images."""
    img = jnp.asarray(img)
    h, w = img.shape[-2:]
    resp = jnp.asarray(tanl_response(_freq_grid(h, w), cutoff, falloff))
    f = rfft2_mm(img)
    return irfft2_mm(f * resp, s=(h, w)).astype(img.dtype)


def filt_tanl_dyn(img, cutoff, falloff):
    """``filt_tanl`` with *traced* cutoff/falloff (jit/scan-safe) — used by
    the device-resident iteration loop where the per-iteration cutoff
    schedule is data on device (the CUDA standalone's
    ``ref_free_alignment_2D_filter_references`` takes them as runtime
    args, cuda/gpu_aln_noref.cu:777-782)."""
    img = jnp.asarray(img)
    h, w = img.shape[-2:]
    freq = jnp.asarray(_freq_grid(h, w))
    cutoff = jnp.asarray(cutoff, jnp.float32)
    falloff = jnp.asarray(falloff, jnp.float32)
    c = jnp.pi / (2.0 * falloff * cutoff)
    resp = 0.5 * (jnp.tanh(c * (freq + cutoff)) - jnp.tanh(c * (freq - cutoff)))
    resp = jnp.where((cutoff > 0.0) & (falloff > 0.0), resp,
                     jnp.ones_like(resp))
    f = rfft2_mm(img)
    return irfft2_mm(f * resp, s=(h, w)).astype(img.dtype)


def filt_btwl(img, freq_low: float, freq_high: float):
    """Butterworth low-pass between pass-band ``freq_low`` and stop-band
    ``freq_high`` (EMAN2 ``filt_btwl`` semantics: -3dB at the pass band,
    eps=0.882, a derived from the band edges)."""
    img = jnp.asarray(img)
    h, w = img.shape[-2:]
    eps = 0.882
    aa = 10.624
    order = 2.0 * np.log10(eps / np.sqrt(aa * aa - 1.0)) / np.log10(freq_low / freq_high)
    rad = freq_low / (eps ** (2.0 / order))
    freq = _freq_grid(h, w)
    resp = (1.0 / np.sqrt(1.0 + (freq / rad) ** order)).astype(np.float32)
    f = rfft2_mm(img)
    return irfft2_mm(f * jnp.asarray(resp), s=(h, w)).astype(img.dtype)


def fshift(img, sx, sy):
    """Sub-pixel translation by Fourier phase ramp (EMAN2 ``fshift``).

    Shifts content by (+sx, +sy) pixels; works on (..., H, W), scalar or
    broadcastable per-image shifts.
    """
    img = jnp.asarray(img)
    h, w = img.shape[-2:]
    fy = jnp.asarray(np.fft.fftfreq(h).astype(np.float32))
    fx = jnp.asarray(np.fft.rfftfreq(w).astype(np.float32))
    sx = jnp.asarray(sx, jnp.float32)
    sy = jnp.asarray(sy, jnp.float32)
    phase = -2.0 * jnp.pi * (
        fy[:, None] * sy[..., None, None] + fx[None, :] * sx[..., None, None]
    )
    # lax.complex keeps complex64 (no complex128 promotion)
    import jax

    ramp = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    f = rfft2_mm(img)
    return irfft2_mm(f * ramp, s=(h, w)).astype(img.dtype)
