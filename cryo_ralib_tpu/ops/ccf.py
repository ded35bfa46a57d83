"""Ring-FFT cross-correlation spectra.

Equivalent of the reference's ``apply_FFT`` + ``cu_ccf_mult[_m]`` pipeline
(cuda/gpu_aln_noref.cu:1816-1881, kernels at :881-1143): polar rings are
rFFT'd along the angular axis; the rotational cross-correlation of subject
``s`` and reference ``r`` is ``sum_rings w_i * conj(S_i) * R_i`` and the
mirrored subject's correlation is its elementwise conjugate
(``conj(S_i * R_i)`` summed) — the conjugate trick that gives the mirror
search for free.

The per-frequency ring contraction is a small complex matmul; no
materialized (ring_len+2)-padded table exists —
the inverse FFT back to angle space happens on a chunk of shifts at a time
inside the fused search (see ``ops/search.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .dft import irfft_mm, rfft_mm


def ring_spectra(polar):
    """rFFT along the angular axis: (..., R, L) -> (..., R, L//2+1) complex64.

    Matches cuFFT R2C (unnormalized forward, cuda/gpu_aln_noref.cu:1816-1820)
    numerically, computed as a matmul DFT (see ops/dft.py).
    """
    return rfft_mm(polar, axis=-1)


def weight_ring_spectra(ref_f, ring_weights):
    """Fold the linear (i+1) ring weights into reference spectra.

    The CUDA kernel multiplies the weight inside the contraction loop
    (cuda/gpu_aln_noref.cu:978-981); folding it into the (small) reference
    spectra once is algebraically identical (see the kernel's own endnote,
    :995-1004) and saves work.
    ref_f: (K, R, F) complex; ring_weights: (R,) -> (K, R, F).
    """
    return ref_f * ring_weights[None, :, None].astype(ref_f.real.dtype)


def ccf_spectra(sbj_f, ref_fw):
    """Weighted rotational ccf spectra of every subject against every reference.

    Args:
      sbj_f:  (N, C, R, F) complex — subject ring spectra for C candidate
              shifts.
      ref_fw: (K, R, F) complex — reference ring spectra with ring weights
              folded in (``weight_ring_spectra``).
    Returns:
      (orig, mirr): each (N, C, K, F) complex.
        orig = sum_r conj(S) * R ; mirr = conj(sum_r S * R)
      (cu_ccf_mult_m math, cuda/gpu_aln_noref.cu:1009-1143).
    """
    hp = jax.lax.Precision.HIGHEST
    orig = jnp.einsum("ncrf,krf->nckf", jnp.conj(sbj_f), ref_fw, precision=hp)
    mirr = jnp.conj(jnp.einsum("ncrf,krf->nckf", sbj_f, ref_fw, precision=hp))
    return orig, mirr


def ccf_spectra_per_particle_ref(sbj_f, ref_fw, ref_id):
    """Variant of ``ccf_spectra`` where each particle correlates only with
    its currently assigned reference (``cu_ccf_mult``,
    cuda/gpu_aln_noref.cu:881-1005; the reference selects
    ``ref_batch_ptr[aln_param[i].ref_id]``).

    Args:
      sbj_f: (N, C, R, F); ref_fw: (K, R, F); ref_id: (N,) int32.
    Returns:
      (orig, mirr): each (N, C, 1, F) complex (K axis kept for a uniform
      downstream decode with ref_off semantics).
    """
    ref_sel = jnp.take(ref_fw, ref_id, axis=0)  # (N, R, F)
    hp = jax.lax.Precision.HIGHEST
    orig = jnp.einsum("ncrf,nrf->ncf", jnp.conj(sbj_f), ref_sel, precision=hp)[:, :, None, :]
    mirr = jnp.conj(jnp.einsum("ncrf,nrf->ncf", sbj_f, ref_sel, precision=hp))[:, :, None, :]
    return orig, mirr


def ccf_rows(orig_f, mirr_f, ring_len: int):
    """Inverse-FFT ccf spectra back to angle space.

    Returns (N, 2, C, K, L) real rows ordered [orig, mirr] on axis 1 so a
    flattened argmax reproduces the reference table's
    [mirror][shift][ref][angle] index order
    (``CcfResultTable``, cuda/gpu_aln_noref.cu:2172-2178).
    ``mirr_f=None`` (the ``--nomirror`` search) returns (N, 1, C, K, L)
    with only the original channel.

    Note: cuFFT C2R is unnormalized (values L x larger); we use the
    normalized inverse — a positive scale that cannot change any argmax or
    the parabolic peak offset.
    """
    if mirr_f is None:
        stacked = orig_f[:, None]                  # (N, 1, C, K, F)
    else:
        stacked = jnp.stack([orig_f, mirr_f], axis=1)  # (N, 2, C, K, F)
    return irfft_mm(stacked, n=ring_len, axis=-1)
