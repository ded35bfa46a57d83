"""Per-particle 2D alignment parameters and transform composition math.

Equivalent of the reference's ``AlignParam`` struct
(cuda/gpu_aln_common.h:77-83, mirrored in ctypes at
test_mref_gpu_align.py:112-135) plus the SPHIRE 2D-transform helpers the
drivers rely on (``combine_params2``, ``inverse_transform2``,
``set_params2D`` decode).  Instead of an array-of-structs in unified memory,
parameters live as a struct-of-arrays pytree so every field is a dense,
shardable ``jax.Array``.

Convention notes (EMAN2/SPHIRE "2D" transform): a params tuple
``(alpha, sx, sy, mirror)`` maps a source image to its aligned version by
rotating by ``alpha`` degrees counter-clockwise about the image center,
then shifting by ``(sx, sy)``, then (if ``mirror``) flipping along x.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class AlignParams(NamedTuple):
    """Struct-of-arrays alignment state for a stack of N particles.

    Fields mirror ``AlignParam`` (cuda/gpu_aln_common.h:77-83):
      angle:   (N,) float32 in-plane rotation, degrees (EMAN2 convention).
      shift_x: (N,) float32 accumulated x shift (applied pre-rotation).
      shift_y: (N,) float32 accumulated y shift.
      mirror:  (N,) int32 0/1 mirror flag.
      ref_id:  (N,) int32 assigned reference / class id.
    """

    angle: jax.Array
    shift_x: jax.Array
    shift_y: jax.Array
    mirror: jax.Array
    ref_id: jax.Array

    @staticmethod
    def zeros(n: int, ref_id: jax.Array | int = 0) -> "AlignParams":
        """Fresh params; matches ``pre_align_init`` which presets ref_id
        (cuda/gpu_aln_noref.cu:188-232)."""
        # distinct buffers per field: donated jit args must not alias
        rid = jnp.zeros((n,), jnp.int32) + jnp.asarray(ref_id, jnp.int32)
        return AlignParams(
            jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.int32),
            rid,
        )

    def to_numpy(self) -> dict:
        return {
            "angle": np.asarray(self.angle),
            "shift_x": np.asarray(self.shift_x),
            "shift_y": np.asarray(self.shift_y),
            "mirror": np.asarray(self.mirror),
            "ref_id": np.asarray(self.ref_id),
        }


def gpu_params_to_align2d(angle, shift_x, shift_y):
    """Decode raw search params into header-convention ``xform.align2d``.

    The search applies shifts *before* rotation, while the 2D header
    convention shifts *after*; the reference converts via
    ``(sx', sy') = R(-angle) @ (-sx, -sy)`` — see the "usually done in
    ormq()" blocks (test_mref_gpu_align.py:578-588,
    test_reffree_gpu_align.py:500-515).  Works on scalars or arrays.
    """
    ang = jnp.deg2rad(angle)
    c = jnp.cos(ang)
    s = -jnp.sin(ang)
    sx_neg = -shift_x
    sy_neg = -shift_y
    out_sx = sx_neg * c - sy_neg * s
    out_sy = sx_neg * s + sy_neg * c
    return out_sx, out_sy


def combine_params2(alpha1, sx1, sy1, mirror1, alpha2, sx2, sy2, mirror2):
    """Compose two 2D align transforms: result applies T1 then T2.

    Reimplements SPHIRE ``sp_utilities.combine_params2`` semantics (used by
    the CPU baselines, e.g. test_mref_gpu_align.py:777) with plain
    trigonometry instead of EMAN2 ``Transform`` objects.  All args may be
    arrays (numpy or jax); mirrors are 0/1 ints.

    With each transform in mirror-last canonical form ``T(p) = F^m (R(a) p + t)``
    (F = x-flip; EMAN2 sets mirror by negating the first matrix row), the
    composition is::

        mirror = m1 ^ m2
        alpha  = a1 + (-1)^m1 * a2
        t      = R((-1)^m1 * a2) @ t1 + F^m1 @ t2
    """
    xp = jnp if any(isinstance(a, jax.Array) for a in
                    (alpha1, sx1, sy1, mirror1, alpha2, sx2, sy2, mirror2)) else np
    m1 = xp.asarray(mirror1)
    m2 = xp.asarray(mirror2)
    a1 = xp.asarray(alpha1, dtype=np.float64 if xp is np else jnp.float32)
    a2 = xp.asarray(alpha2, dtype=np.float64 if xp is np else jnp.float32)
    sign1 = xp.where(m1 == 1, -1.0, 1.0)
    alpha = (a1 + sign1 * a2) % 360.0
    ang2 = xp.deg2rad(sign1 * a2)
    c2, s2 = xp.cos(ang2), xp.sin(ang2)
    rx = xp.asarray(sx1) * c2 - xp.asarray(sy1) * s2
    ry = xp.asarray(sx1) * s2 + xp.asarray(sy1) * c2
    sx = rx + sign1 * xp.asarray(sx2)
    sy = ry + xp.asarray(sy2)
    mirror = (m1 + m2) % 2
    return alpha, sx, sy, mirror


def inverse_transform2(alpha, sx, sy, mirror=0):
    """Invert a 2D align transform (SPHIRE ``inverse_transform2`` semantics,
    used by the CPU baseline at test_mref_gpu_align.py:756).

    With ``T(p) = F^m (R(a) p + t)`` the inverse in the same canonical form
    is ``mirror' = m``, ``alpha' = (-1)^(m+1) a``, ``t' = -F^m R(-a) t``.
    """
    xp = jnp if any(isinstance(a, jax.Array) for a in (alpha, sx, sy)) else np
    m = xp.asarray(mirror)
    a = xp.asarray(alpha)
    ang = xp.deg2rad(a)
    c, s = xp.cos(ang), xp.sin(ang)
    sxn = xp.asarray(sx)
    syn = xp.asarray(sy)
    # R(-a) @ t
    rx = c * sxn + s * syn
    ry = -s * sxn + c * syn
    inv_alpha = xp.where(m == 1, a % 360.0, (-a) % 360.0)
    inv_sx = xp.where(m == 1, rx, -rx)
    inv_sy = -ry
    return inv_alpha, inv_sx, inv_sy, m


def params_table(params: AlignParams) -> np.ndarray:
    """(N, 4) float table [alpha, sx, sy, mirror] in header convention,
    i.e. the rows written to ``initial2Dparams.txt``
    (test_reffree_gpu_align.py:560-569).

    alpha is wrapped into [0, 360): the raw decode can step outside
    (360 - theta with a parabolic offset, and a degenerate flat-peak fit
    can overshoot by several bins), but every reference header path goes
    through ``combine_params2``, which normalizes ``% 360``
    (sp_utilities semantics; see ``combine_params2`` above)."""
    sx, sy = gpu_params_to_align2d(params.angle, params.shift_x, params.shift_y)
    return np.stack(
        [
            np.asarray(params.angle, np.float64) % 360.0,
            np.asarray(sx, np.float64),
            np.asarray(sy, np.float64),
            np.asarray(params.mirror, np.float64),
        ],
        axis=1,
    )


def pixel_error_2D(params1, params2, r: float):
    """Mean pixel displacement between two 2D transforms over a disk of
    radius ``r`` (QC metric; SPHIRE ``pixel_error_2D`` semantics, used at
    test_reffree_gpu_align.py:527-538).

    For a pure rotation by d_alpha the RMS displacement over a disk of
    radius r is ``r*sqrt(1-cos(d))``; shifts add in quadrature.
    params are (alpha, sx, sy) triples of arrays or scalars.
    """
    a1, sx1, sy1 = params1
    a2, sx2, sy2 = params2
    xp = jnp if any(isinstance(v, jax.Array) for v in (a1, sx1, sy1, a2, sx2, sy2)) else np
    d = xp.deg2rad(xp.asarray(a1) - xp.asarray(a2))
    rot_term = (r * r) * (1.0 - xp.cos(d))
    return xp.sqrt(xp.abs(rot_term + (xp.asarray(sx1) - xp.asarray(sx2)) ** 2
                          + (xp.asarray(sy1) - xp.asarray(sy2)) ** 2))
