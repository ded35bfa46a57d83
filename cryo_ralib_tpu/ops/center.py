"""Image centering utilities (SPHIRE ``center_2D`` equivalents).

The reference's own CLI documents exactly two values for ``--center``:
"0 - if you do not want the average to be centered, 1 - center the
average (default=1)" (test_mref_gpu_align.py:1149); the reffree drivers
additionally use ``center == -1`` for the "average centering method"
(the mean per-particle shift subtracted from the new reference via
``fshift``, test_reffree_gpu_align.py:403-410 — that lives in the
drivers, not here).  ``user_func ref_ali2d`` forwards the flag to
SPHIRE's ``center_2D(tavg, method)`` for values > 0, but SPHIRE itself
is not part of the reference repo, so the finer method ids (2..7) have
no semantics the rebuild could verify against.

Policy: method 0 is a no-op, method 1 is
the positive-mass center-of-gravity centering below (the documented
"center the average" behavior), and every other id is rejected loudly
instead of being silently aliased — the same honor-or-reject contract
every other flag follows.
"""

from __future__ import annotations

import jax.numpy as jnp

from .filters import fshift


def center_of_gravity(img):
    """(sx, sy) center-of-gravity displacement of the positive part of the
    image relative to the EMAN2 center (h//2, w//2)."""
    img = jnp.asarray(img)
    h, w = img.shape[-2:]
    pos = jnp.maximum(img, 0.0)
    total = jnp.sum(pos, axis=(-2, -1))
    yy = jnp.arange(h, dtype=img.dtype)
    xx = jnp.arange(w, dtype=img.dtype)
    cy = jnp.sum(pos * yy[:, None], axis=(-2, -1)) / jnp.maximum(total, 1e-20)
    cx = jnp.sum(pos * xx[None, :], axis=(-2, -1)) / jnp.maximum(total, 1e-20)
    return cx - w // 2, cy - h // 2


def center_2D(img, method: int = 1):
    """Center an image; returns (centered_image, sx, sy) where (sx, sy) is
    the applied correction shift (image shifted by (-sx, -sy)).

    ``method`` follows the reference CLI contract: 0 = none, 1 = center
    the average (center-of-gravity of the positive part).  Any other id
    raises — the reference would dispatch it to a SPHIRE ``center_2D``
    method whose semantics are outside the reference repo, and this
    rebuild does not silently substitute.
    """
    if method <= 0:
        return jnp.asarray(img), 0.0, 0.0
    if method != 1:
        raise ValueError(
            f"--center={method} is not supported: the reference documents "
            "only 0 (off) and 1 (center the average); ids >1 dispatch to "
            "SPHIRE center_2D methods whose semantics are not part of the "
            "reference — use 0, 1 (or -1 for the reffree average-centering)"
        )
    sx, sy = center_of_gravity(img)
    return fshift(img, -sx, -sy), sx, sy
