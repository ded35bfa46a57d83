"""SCF (self-correlation) alignment — ``random_method="SCF"``.

The CPU twin's SCF mode aligns rotation on the *self-correlation
function* of each image — translation-invariant, so rotation decouples
from the shift search — then recovers the translation with one 2-D
cross-correlation per rotation candidate (test_reffree_gpu_align.py:714:
SCF forces mode="H"; ``ali2d_single_iter`` dispatches to SPHIRE
``multalign2d_scf``, which lives outside the reference repo — the
semantics contract is defined by ``utils.oracle.align_particle_scf_np``
and mirrored exactly here).  The GPU reference never implemented it.

Mapping:

* scf via matmul DFTs (`ops/dft.py`): ``irfft2(|rfft2(img)|)`` — the
  amplitude of a real image is hermitian-even, so the half-plane
  amplitude *is* the rfft2 of the (real, centrosymmetric) scf; one
  static roll centers it.
* rotation: the standard polar ring-spectra ccf machinery at a
  zero-shift config (S=1) on the scf images — same decode conventions
  (H-mode bin step, mirror+180) as the main search, for free.
* translation: the scf's centrosymmetry leaves a 180-degree ambiguity,
  so each particle scores 2 candidate angles.  Instead of transforming
  every particle for every shift, the *reference* is inverse-transformed
  once per candidate (2 single-image transforms per particle) and the
  whole shift window comes out of one DFT cross-correlation map:

      score(s) = sum_z invref(z) * img(z + s),
      invref   = transform(ref, angle if mirror else -angle, mirror)

  which equals ``sum_y ref(y) * transform(img, angle, s, mirror)(y)``
  (for 2-D rotations ``M R(t) M = R(-t)`` gives the mirrored-branch
  sign).  Shifts are integer (the CPU twin casts ``int(xrng+0.5)``);
  order [candidate][sy][sx], first max — deterministic ties.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..params import AlignParams
from .dft import irfft2_mm, rfft2_mm
from .search import (SearchResult, decode_params, prepare_ref_spectra,
                     rotational_shift_search, rotational_shift_search_mm)
from .transform import transform_batch, transform_batch_mm


def scf_batch(images):
    """Centered self-correlation of a real image batch (N, H, W).

    ``utils.oracle.scf_np`` semantics: ifft2 of the Fourier amplitude,
    fftshifted so the (always-maximal) DC peak sits at the center.
    """
    h, w = images.shape[-2], images.shape[-1]
    amp = jnp.abs(rfft2_mm(images))          # (N, H, F) real
    s = irfft2_mm(amp, (h, w))               # hermitian-even -> real scf
    return jnp.roll(s, (h // 2, w // 2), axis=(-2, -1))


def _zero_shift_cfg(cfg: AlignConfig) -> AlignConfig:
    return dataclasses.replace(cfg, shift_rng_x=0.0, shift_rng_y=0.0)


def scf_align(images, ref, cfg: AlignConfig, sampler: str = "gather",
              fast: bool = True):
    """Full SCF alignment of a batch against one reference.

    Args:
      images: (N, H, W) particles.  ref: (H, W) current average.
      cfg: AlignConfig with mode="H" (the driver forces it, reference
        line 714); its shift ranges give the integer translation window.
      sampler: polar engine for the rotation stage ("gather" exact
        texture semantics / "matmul" tent matmuls).
    Returns:
      (AlignParams, peak (N,)) — ref_id fixed at 0, shifts clamped to
      ``cfg.shift_limit`` like the standard decode.
    """
    if cfg.mode != "H":
        raise ValueError("SCF requires mode='H' half rings "
                         "(test_reffree_gpu_align.py:714)")
    n, h, w = images.shape
    cfg0 = _zero_shift_cfg(cfg)
    zeros = AlignParams.zeros(n)

    # ---- stage 1: rotation (+ mirror) from the scf ring spectra
    sci = scf_batch(images)
    scr = scf_batch(ref[None])
    ref_fw = prepare_ref_spectra(scr, cfg0)
    if sampler == "matmul":
        res = rotational_shift_search_mm(sci, ref_fw, zeros, cfg0, fast=fast)
    else:
        res = rotational_shift_search(sci, ref_fw, zeros, cfg0)
    dec = decode_params(res, zeros, cfg0, update_ref=False)
    ang = dec.angle % 360.0
    mirror = dec.mirror

    # ---- stage 2: translation, one ccf map per 180-deg candidate
    img_f = rfft2_mm(images)                 # (N, H, F)
    xr = int(round(cfg.shift_rng_x))
    yr = int(round(cfg.shift_rng_y))
    dxs = np.arange(-xr, xr + 1)
    dys = np.arange(-yr, yr + 1)

    cand_scores = []
    cand_angles = []
    for k in range(2):
        cand = (ang + 180.0 * k) % 360.0
        inv_ang = jnp.where(mirror == 1, cand, -cand)
        inv_params = AlignParams(
            inv_ang.astype(jnp.float32),
            jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32),
            mirror, jnp.zeros(n, jnp.int32))
        ref_b = jnp.broadcast_to(ref[None], (n, h, w))
        if sampler == "matmul":
            # FFT-shear rotation (the matmul engine's transform; this
            # stage runs it on the full batch twice)
            invref = transform_batch_mm(ref_b, inv_params, fast=fast)
        else:
            invref = transform_batch(ref_b, inv_params)
        # score(s) = sum_z invref(z) img(z+s) = ifft2(conj(IR) * I)(s)
        cc = irfft2_mm(jnp.conj(rfft2_mm(invref)) * img_f, (h, w))
        # circulant map: entry s lives at (s mod h); one static roll puts
        # the [-yr..yr]x[-xr..xr] window at the top-left corner
        win = jnp.roll(cc, (yr, xr), axis=(-2, -1))[
            :, : 2 * yr + 1, : 2 * xr + 1]  # (N, Wy, Wx)
        cand_scores.append(win)
        cand_angles.append(cand)

    scores = jnp.stack(cand_scores, axis=1)  # (N, 2, Wy, Wx)
    flat = scores.reshape(n, -1)
    idx = jnp.argmax(flat, axis=1)
    peak = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    wy, wx = len(dys), len(dxs)
    xi = (idx % wx).astype(jnp.int32)
    rest = idx // wx
    yi = (rest % wy).astype(jnp.int32)
    ci = (rest // wy).astype(jnp.int32)

    angle = jnp.where(ci == 1, cand_angles[1], cand_angles[0])
    limit = cfg.shift_limit
    sx = jnp.clip(jnp.asarray(dxs, jnp.float32)[xi], -limit, limit)
    sy = jnp.clip(jnp.asarray(dys, jnp.float32)[yi], -limit, limit)
    params = AlignParams(angle=angle.astype(jnp.float32), shift_x=sx,
                         shift_y=sy, mirror=mirror,
                         ref_id=jnp.zeros(n, jnp.int32))
    return params, peak


def scf_search_result(params: AlignParams, peak, ring_len: int):
    """Wrap SCF output as a SearchResult-shaped record (diagnostics)."""
    n = params.angle.shape[0]
    return SearchResult(
        best_val=peak,
        best_row=jnp.zeros((n, ring_len), jnp.float32),
        best_aidx=jnp.zeros((n,), jnp.int32),
        best_sidx=jnp.zeros((n,), jnp.int32),
        best_ref=params.ref_id,
        best_mirror=params.mirror)
