"""Batch image transforms: apply alignment parameters / rot_shift2D.

Two interpolation flavors, matching the two the reference mixes:

* ``transform_batch`` — bilinear inverse-map, exactly
  ``cu_transform_batch`` (cuda/gpu_aln_noref.cu:1145-1197).  Used inside
  the alignment loop to build class averages.

* ``rot_shift2d`` — EMAN2 ``rot_scale_trans2D_background`` with *quadri*
  interpolation, the public batch transform op of notebook 02
  (``rot_shift_2d_cupy``); claimed ~5x vs CPU in README.md:62.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..params import AlignParams
from .dft import irfft_mm, rfft_mm
from .interp import bilinear_sample, quadri_sample


def transform_batch(images, params: AlignParams):
    """Apply (mirror -> rotate -> shift) inverse mapping, bilinear.

    Per target pixel p the source coordinate is computed exactly as in
    ``cu_transform_batch``:
      1. mirror:  src_x = nx - x (if mirror),
      2. rotate by +angle about (nx/2, ny/2),
      3. add (shift_x, shift_y),
    then a clamp-to-edge bilinear read (texture +0.5 offset cancels).

    Args:
      images: (N, H, W); params: AlignParams with (N,) fields.
    Returns:
      (N, H, W) transformed images.
    """
    n, h, w = images.shape
    yy, xx = jnp.meshgrid(
        jnp.arange(h, dtype=images.dtype), jnp.arange(w, dtype=images.dtype),
        indexing="ij",
    )
    xx = xx.reshape(1, -1)
    yy = yy.reshape(1, -1)
    mirror = params.mirror[:, None].astype(images.dtype)
    src_x = jnp.where(mirror == 1.0, w - xx, xx)
    src_y = jnp.broadcast_to(yy, (n, h * w))

    ang = jnp.deg2rad(params.angle)[:, None]
    c, s = jnp.cos(ang), jnp.sin(ang)
    ctr_x = w // 2
    ctr_y = h // 2
    ux = src_x - ctr_x
    uy = src_y - ctr_y
    rx = ux * c - uy * s + ctr_x + params.shift_x[:, None]
    ry = ux * s + uy * c + ctr_y + params.shift_y[:, None]
    out = bilinear_sample(images, ry, rx)
    return out.reshape(n, h, w)


def _flip_edge(arr, axis):
    """Index map i -> clamp(size - i): [last, size-1, size-2, ..., 1].

    The coordinate flip the reference's mirror/rotation math produces on
    an even grid (``src_x = nx - x`` with texture clamp,
    cuda/gpu_aln_noref.cu:1168): position 0 reads the clamped
    out-of-range sample (== last), the rest reverse.
    """
    last = jax.lax.slice_in_dim(arr, arr.shape[axis] - 1, arr.shape[axis],
                                axis=axis)
    body = jnp.flip(jax.lax.slice_in_dim(arr, 1, arr.shape[axis], axis=axis),
                    axis=axis)
    return jnp.concatenate([last, body], axis=axis)


def _translate_rows(img, t, fast: bool = False):
    """Per-row sub-pixel x-translation via DFT phase ramp.

    img: (N, P, P); t: (N, P) shift amounts (out[y, x] = in[y, x + t[y]],
    periodic).  Exact for bandlimited content; the caller pads so content
    never wraps.  ``fast`` = bf16 DFT matmuls (phase ramps stay f32).
    """
    p = img.shape[-1]
    f = rfft_mm(img, axis=-1, fast=fast)            # (N, P, F)
    k = jnp.arange(p // 2 + 1, dtype=jnp.float32)
    phase = 2.0 * jnp.pi * k[None, None, :] * t[:, :, None] / p
    ramp = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    return irfft_mm(f * ramp, n=p, axis=-1, fast=fast)


def _translate_cols(img, t, fast: bool = False):
    """Per-column sub-pixel y-translation (out[y, x] = in[y + t[x], x])."""
    return jnp.swapaxes(_translate_rows(jnp.swapaxes(img, -1, -2), t, fast),
                        -1, -2)


def _warp_spectrum(images, params: AlignParams, pad_to: int | None = None,
                   fast: bool = False):
    """Shear passes 1-3 of the FFT warp plus the forward half of pass 4.

    Returns ``(g, off, pad_to)`` where ``irfft_mm(g, n=pad_to, axis=-1)``
    is the pre-crop, pre-mirror transformed stack — the factorization
    that lets ``class_sum_transform_mm`` hoist the (shared, linear) final
    inverse DFT and mirror flip past the per-class sum.
    """
    n, h, w = images.shape
    assert h == w, "transform_batch_mm assumes square images"
    if pad_to is None:
        # content diagonal h*sqrt(2) must fit; round up to a multiple of 128
        pad_to = ((int(np.ceil(h * np.sqrt(2.0))) + 127) // 128) * 128
    c = w // 2

    ang = jnp.deg2rad(params.angle.astype(jnp.float32))
    # quadrant index k = round(angle / 90) mod 4, residual phi in [-45, 45)
    k90 = jnp.floor(ang / (jnp.pi / 2) + 0.5).astype(jnp.int32)
    phi = ang - k90.astype(jnp.float32) * (jnp.pi / 2)
    k90 = jnp.mod(k90, 4)

    # pre-rotate by 90k: all four variants, masked select
    r0 = images
    r1 = _flip_edge(jnp.swapaxes(images, -1, -2), -2)   # 90 deg
    r2 = _flip_edge(_flip_edge(images, -1), -2)          # 180 deg
    r3 = _flip_edge(jnp.swapaxes(images, -1, -2), -1)   # 270 deg
    sel = k90[:, None, None]
    base = jnp.where(sel == 0, r0, jnp.where(sel == 1, r1,
                     jnp.where(sel == 2, r2, r3)))

    # rotate the shift vector by -90k
    sx, sy = params.shift_x, params.shift_y
    sxr = jnp.select([k90 == 0, k90 == 1, k90 == 2], [sx, sy, -sx], -sy)
    syr = jnp.select([k90 == 0, k90 == 1, k90 == 2], [sy, -sx, -sy], sx)

    # zero-pad so the center lands on pad_to//2
    off = pad_to // 2 - c
    base = jnp.pad(base, ((0, 0), (off, pad_to - h - off),
                          (off, pad_to - w - off)))
    cp = jnp.float32(pad_to // 2)

    a = -jnp.tan(phi / 2.0)
    b = jnp.sin(phi)
    rows = jnp.arange(pad_to, dtype=jnp.float32)[None, :] - cp  # y - cy
    cols = jnp.arange(pad_to, dtype=jnp.float32)[None, :] - cp  # x - cx

    # pass 1: y-translate by syr (see docstring: img1 = img(p + s))
    out = _translate_cols(base, jnp.broadcast_to(syr[:, None], (n, pad_to)),
                          fast)
    # pass 2: x-translate by a*(y-cy) + sxr  (first shear + x shift)
    out = _translate_rows(out, a[:, None] * rows + sxr[:, None], fast)
    # pass 3: y-translate by b*(x-cx)
    out = _translate_cols(out, b[:, None] * cols, fast)
    # pass 4 forward: rfft + phase ramp for the x-translate a*(y-cy)
    f = rfft_mm(out, axis=-1, fast=fast)                 # (N, P, F)
    kf = jnp.arange(pad_to // 2 + 1, dtype=jnp.float32)
    t = a[:, None] * rows                                # (N, P)
    phase = 2.0 * jnp.pi * kf[None, None, :] * t[:, :, None] / pad_to
    g = f * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    return g, off, pad_to


def transform_batch_mm(images, params: AlignParams, pad_to: int | None = None,
                       fast: bool = False):
    """Gather-free ``transform_batch``: FFT-shear rotation as matmuls.

    Same warp as ``transform_batch`` (mirror -> rotate by +angle about
    the integer center -> shift), decomposed into matmul-friendly passes:

    1. quadrant: angle = 90k + phi, phi in [-45, 45); the 90k part is an
       exact grid permutation (transpose/edge-flip, matching the
       reference's ``nx - x`` clamp convention), the shift vector is
       rotated by -90k;
    2. residual phi: three centered shears
       R(phi) = Sx(-tan(phi/2)) Sy(sin phi) Sx(-tan(phi/2)), each a
       per-row/column sub-pixel translation done as a DFT-matmul phase
       ramp; the (sx, sy) shift rides the first two passes for free;
    3. images are zero-padded to ``pad_to`` (default: next multiple of
       128) so the periodic Fourier translations never wrap
       content.

    Interpolation is sinc (bandlimited) instead of the reference's
    bilinear texture reads — a different, sharper kernel; averages match
    to the interpolation difference (golden tests pin this down).
    """
    n, h, w = images.shape
    g, off, pad_to = _warp_spectrum(images, params, pad_to, fast)
    out = irfft_mm(g, n=pad_to, axis=-1, fast=fast)
    out = out[:, off:off + h, off:off + w]

    # mirror: out_m[y, x] = out[y, clamp(w - x)] (applied to the final
    # result; equivalent to the reference's pre-rotation src_x = nx - x)
    flipped = _flip_edge(out, -1)
    return jnp.where(params.mirror[:, None, None] == 1, flipped, out)


def rot_shift2d(images, angles, sx, sy, mirror=None, scale=None,
                engine: str = "auto"):
    """EMAN2 ``rot_shift2D``, batched — the public batch-transform op
    (notebook 02's ``rot_shift_2d_cupy``; README.md:62 claims ~5x vs CPU).

    Forward semantics: rotate by ``angle`` degrees about the center, shift
    by (sx, sy); mirror flips columns afterwards, leaving column 0 fixed
    for even sizes (``start = 1 - h % 2``) — the exact post-flip of the
    CuPy wrapper (notebook 02 cell 2).

    Engines:
      "quadri": quadri-background interpolation via gathers — exact
        notebook-02 parity (the CuPy kernel's structure).
      "shear": gather-free FFT-shear path (sinc interpolation) reusing
        ``transform_batch_mm`` — the identity
        ``R(a)(p-c-s)+c = R(a)(p-c)+c+(-R(a)s)`` maps this op onto the
        inverse-map transform; requires scale == 1.
      "auto": ``select_engine(mode="transform")``; quadri whenever a
        scale is given.

    Args:
      images: (N, H, W).
      angles, sx, sy: (N,) float arrays (degrees / pixels).
      mirror: optional (N,) 0/1.
      scale: optional (N,) scale factors (default 1; forces quadri).
    Returns:
      (N, H, W).
    """
    if engine == "auto":
        from ..models.steps import select_engine

        engine = ("quadri" if scale is not None
                  else select_engine(mode="transform"))
    if engine == "shear":
        if scale is not None:
            raise ValueError("shear engine requires scale=1 (None)")
        return _rot_shift2d_shear(images, angles, sx, sy, mirror)
    n, h, w = images.shape
    angles = jnp.asarray(angles, images.dtype)
    sx = jnp.asarray(sx, images.dtype)
    sy = jnp.asarray(sy, images.dtype)
    if scale is None:
        scale = jnp.ones((n,), images.dtype)
    else:
        scale = jnp.asarray(scale, images.dtype)
        scale = jnp.where(scale == 0.0, 1.0, scale)

    sx = _restrict2(sx, w)
    sy = _restrict2(sy, h)

    yy, xx = jnp.meshgrid(
        jnp.arange(h, dtype=images.dtype), jnp.arange(w, dtype=images.dtype),
        indexing="ij",
    )
    xx = xx.reshape(1, -1)
    yy = yy.reshape(1, -1)

    ang = jnp.deg2rad(angles)[:, None]
    cang, sang = jnp.cos(ang), jnp.sin(ang)
    xc = w // 2
    yc = h // 2
    shiftxc = xc + sx[:, None]
    shiftyc = yc + sy[:, None]
    inv_scale = 1.0 / scale[:, None]

    y = yy - shiftyc
    ycang = y * cang * inv_scale + yc
    ysang = -y * sang * inv_scale + xc
    x = xx - shiftxc
    xold = x * cang * inv_scale + ysang
    yold = x * sang * inv_scale + ycang

    out = quadri_sample(
        images, yold, xold,
        fallback_y=jnp.broadcast_to(yy, yold.shape),
        fallback_x=jnp.broadcast_to(xx, xold.shape),
    ).reshape(n, h, w)

    if mirror is not None:
        start = 1 - h % 2
        flipped = out.at[:, :, start:].set(jnp.flip(out[:, :, start:], axis=2))
        out = jnp.where(jnp.asarray(mirror).reshape(n, 1, 1) == 1, flipped, out)
    return out


def _rot_shift2d_shear(images, angles, sx, sy, mirror=None):
    """rot_shift2d via the FFT-shear warp: shift vector rotated into the
    post-rotation frame, notebook-style mirror post-flip."""
    n, h, w = images.shape
    angles = jnp.asarray(angles, jnp.float32)
    sx = _restrict2(jnp.asarray(sx, jnp.float32), w)
    sy = _restrict2(jnp.asarray(sy, jnp.float32), h)
    ang = jnp.deg2rad(angles)
    c, s = jnp.cos(ang), jnp.sin(ang)
    sxp = -(sx * c - sy * s)
    syp = -(sx * s + sy * c)
    p = AlignParams(angles, sxp, syp,
                    jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.int32))
    out = transform_batch_mm(images, p)
    if mirror is not None:
        start = 1 - h % 2
        flipped = out.at[:, :, start:].set(jnp.flip(out[:, :, start:], axis=2))
        out = jnp.where(jnp.asarray(mirror).reshape(n, 1, 1) == 1, flipped,
                        out)
    return out


def _restrict2(v, size):
    """EMAN2 ``restrict2``: ``while (x >= nx) x -= nx; while (x <= -nx) x += nx``
    (notebook 02 kernel).  For x >= nx this lands in [0, nx) (i.e. x mod nx);
    for x <= -nx it lands in (-nx, 0]."""
    size = float(size)
    v = jnp.where(v >= size, jnp.mod(v, size), v)
    v = jnp.where(v <= -size, -jnp.mod(-v, size), v)
    return v
