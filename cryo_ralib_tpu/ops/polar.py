"""Polar ring resampling of particle images.

Equivalent of ``cu_resample_to_polar``
(cuda/gpu_aln_noref.cu:818-879): every image is sampled on ``ring_num``
concentric rings of ``ring_len`` points each, centered at
``img_dim/2 + global_shift + per_particle_shift`` with bilinear
(clamp-to-edge) interpolation.  The CUDA kernel's ``+0.5`` texel offset is
the texture-coordinate convention for pixel centers and cancels out here —
we sample directly at float pixel coordinates.

Unlike the reference there is no (ring_len+2) padding for in-place FFTs;
XLA's rfft handles layout.
"""

from __future__ import annotations

import jax.numpy as jnp

from .interp import bilinear_sample


def polar_resample(images, coords, shift_x=None, shift_y=None):
    """Resample a stack of images into polar rings.

    Args:
      images: (N, H, W) float32.
      coords: (R, L, 2) polar sampling offsets from ``AlignConfig.polar_coords``
        (``[..., 0]`` = x, ``[..., 1]`` = y).
      shift_x, shift_y: per-particle total shifts.  Scalars, ``(N,)`` arrays,
        or ``(N, S)`` arrays to evaluate S candidate shifts per particle in
        one call (global + accumulated shift, pre-summed by the caller).

    Returns:
      (N, R, L) if shifts are scalar/per-particle, else (N, S, R, L).
    """
    n, h, w = images.shape
    r_num, r_len, _ = coords.shape
    cx = w // 2
    cy = h // 2

    if shift_x is None:
        shift_x = jnp.zeros((n,), images.dtype)
    if shift_y is None:
        shift_y = jnp.zeros((n,), images.dtype)
    shift_x = jnp.broadcast_to(jnp.asarray(shift_x, images.dtype), jnp.shape(shift_x) or (n,))
    shift_y = jnp.broadcast_to(jnp.asarray(shift_y, images.dtype), jnp.shape(shift_y) or (n,))

    multi_shift = shift_x.ndim == 2
    if not multi_shift:
        shift_x = shift_x[:, None]
        shift_y = shift_y[:, None]
    s = shift_x.shape[1]

    px = coords[..., 0].reshape(1, 1, -1)  # (1, 1, R*L)
    py = coords[..., 1].reshape(1, 1, -1)
    x = cx + shift_x[:, :, None] + px  # (N, S, R*L)
    y = cy + shift_y[:, :, None] + py
    out = bilinear_sample(images, y.reshape(n, -1), x.reshape(n, -1))
    out = out.reshape(n, s, r_num, r_len)
    if not multi_shift:
        out = out[:, 0]
    return out
