"""Even/odd class-average accumulation.

Equivalent of the reference's two accumulation paths — the CuPy
``kernel_sum_oe`` zero-copy sums (test_mref_gpu_align.py:48-80) and the
CUDA ``cu_average_batch[_m]`` kernels (cuda/gpu_aln_noref.cu:1199-1274).

The per-class masked sums become a single one-hot matmul over the
particle axis (no dynamic boolean gathers), which is also the
shape that ``psum``s cleanly across a particle-sharded mesh.

Parity convention: even/odd by the particle's *global stack index* parity
(``(start+img_idx)%2`` in ``cu_average_batch_m``; the CuPy path uses
batch-local parity, which coincides whenever batch starts are even).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def class_sum_oe(images, ref_id, n_classes: int, global_index=None, valid=None):
    """Per-class even/odd image sums and member counts.

    Args:
      images: (N, H, W) transformed (aligned) particles.
      ref_id: (N,) int32 class assignment.
      n_classes: static K.
      global_index: (N,) int32 global particle indices for parity;
        defaults to arange(N).
      valid: optional (N,) 0/1 mask excluding padding particles (stacks
        padded up to a multiple of the device-mesh size).

    Returns:
      sums:   (K, 2, H, W) float32 — [:, 0] even-parity sum, [:, 1] odd.
      counts: (K,) int32 class member counts (``get_num_ref`` equivalent,
              cuda/gpu_aln_noref.cu:384-386).
    """
    n, h, w = images.shape
    if global_index is None:
        global_index = jnp.arange(n, dtype=jnp.int32)
    parity = jnp.asarray(global_index, jnp.int32) % 2
    slot = ref_id * 2 + parity  # (N,) in [0, 2K)
    onehot = jax.nn.one_hot(slot, n_classes * 2, dtype=images.dtype)
    class_onehot = jax.nn.one_hot(ref_id, n_classes, dtype=jnp.int32)
    if valid is not None:
        onehot = onehot * jnp.asarray(valid, images.dtype)[:, None]
        class_onehot = class_onehot * jnp.asarray(valid, jnp.int32)[:, None]
    # HIGHEST: class sums accumulate in full f32 — reduced-precision
    # (bf16 or TF32) products visibly perturb the averages
    sums = jnp.einsum("nc,nhw->chw", onehot, images,
                      precision=jax.lax.Precision.HIGHEST)
    counts = jnp.sum(class_onehot, axis=0)
    return sums.reshape(n_classes, 2, h, w), counts


def class_sum_transform_mm(images, params, n_classes: int,
                           global_index=None, valid=None, fast: bool = True):
    """Fused FFT-shear transform + even/odd class sums.

    Algebraically identical to ``class_sum_oe(transform_batch_mm(images,
    params), ...)`` with the per-particle work minimized: the warp's
    final inverse DFT and the mirror column-flip are the same linear map
    for every particle, so the one-hot class sum runs on the pass-4
    *spectra* over (class, parity, mirror) slots and the inverse DFT /
    flip apply once to the (4K, P, F) sums.  This removes the (N, P, P)
    transformed-stack materialization + mirror select from device memory
    (reference analog: ``mref_align_run`` returns the transformed batch
    for CuPy sums, cuda/gpu_aln_noref.cu:389-416 + kernel_sum_oe).
    """
    from .transform import _flip_edge, _warp_spectrum

    n, h, w = images.shape
    if global_index is None:
        global_index = jnp.arange(n, dtype=jnp.int32)
    parity = jnp.asarray(global_index, jnp.int32) % 2
    ref_id = params.ref_id
    slot = (ref_id * 2 + parity) * 2 + params.mirror  # (N,) in [0, 4K)
    onehot = jax.nn.one_hot(slot, n_classes * 4, dtype=images.dtype)
    class_onehot = jax.nn.one_hot(ref_id, n_classes, dtype=jnp.int32)
    if valid is not None:
        onehot = onehot * jnp.asarray(valid, images.dtype)[:, None]
        class_onehot = class_onehot * jnp.asarray(valid, jnp.int32)[:, None]

    g, off, pad_to = _warp_spectrum(images, params, fast=fast)  # (N, P, F)
    hp = jax.lax.Precision.HIGHEST
    sr = jnp.einsum("nc,npf->cpf", onehot, jnp.real(g), precision=hp)
    si = jnp.einsum("nc,npf->cpf", onehot, jnp.imag(g), precision=hp)

    from .dft import irfft_mm

    cs = irfft_mm(jax.lax.complex(sr, si), n=pad_to, axis=-1)
    cs = cs[:, off:off + h, off:off + w].reshape(n_classes, 2, 2, h, w)
    sums = cs[:, :, 0] + _flip_edge(cs[:, :, 1], -1)
    counts = jnp.sum(class_onehot, axis=0)
    return sums.astype(jnp.float32), counts
