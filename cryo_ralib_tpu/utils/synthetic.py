"""Synthetic particle stacks for tests, timing harnesses and demos.

Parity with the reference's fixture layer: the host-side random
``ImageStack`` (cuda/gpu_aln_common.cu:218-268), ``create_rnd_data``
(cuda/gpu_aln_noref.cu:2405-2415) and the ``generate_random_averages``
workflow seed of notebook 00.  Unlike the reference's uniform noise,
the structured generators make alignment recoverable, which is what the
driver tests assert.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def random_stack(n: int, nx: int, seed: int = 0) -> np.ndarray:
    """Uniform-noise stack (the C harnesses' ImageStack)."""
    rng = np.random.default_rng(seed)
    return rng.random((n, nx, nx), np.float32)


def class_templates(n_classes: int, nx: int) -> np.ndarray:
    """Well-separated rotationally-informative class templates: class k
    carries 2+k gaussian bumps on a ring of distinct radius, unit-sigma
    normalized."""
    yy, xx = np.mgrid[0:nx, 0:nx]
    cy = cx = nx // 2
    out = np.zeros((n_classes, nx, nx), np.float32)
    for k in range(n_classes):
        # cap the ring radius so features stay inside typical alignment
        # masks (ou ~ 0.4 nx) even for many classes
        r0 = nx * min(0.12 + k * 0.07, 0.30)
        img = np.zeros((nx, nx), np.float64)
        n_bumps = 2 + k
        for b in range(n_bumps):
            ang = 2 * np.pi * b / n_bumps + 0.5 * k
            by = cy + r0 * np.sin(ang)
            bx = cx + r0 * np.cos(ang)
            img += np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * 2.5 ** 2))
        img -= img.mean()
        img /= img.std()
        out[k] = img.astype(np.float32)
    return out


def asymmetric_templates(n_classes: int, nx: int) -> np.ndarray:
    """`class_templates` carry C_{2+k} *dihedral* symmetry (equally spaced
    identical bumps), which makes the decoded mirror/angle genuinely
    degenerate (equal-score argmax ties).  This variant adds two distinct
    off-ring bumps per class so every pose is unique — use it whenever a
    test asserts exact winner agreement."""
    base = class_templates(n_classes, nx).astype(np.float64)
    yy, xx = np.mgrid[0:nx, 0:nx]
    cy = cx = nx // 2
    for i in range(n_classes):
        for amp, r, ang in ((2.0, 0.18 * nx, 0.7 + i),
                            (1.2, 0.08 * nx, 2.9 + 2 * i)):
            by, bx = cy + r * np.sin(ang), cx + r * np.cos(ang)
            base[i] += amp * np.exp(-((yy - by) ** 2 + (xx - bx) ** 2)
                                    / (2 * 2.0 ** 2))
        base[i] -= base[i].mean()
        base[i] /= base[i].std()
    return base.astype(np.float32)


def blob_stack(n: int, nx: int, blobs: int = 3, noise: float = 0.05,
               seed: int = 0) -> np.ndarray:
    """Particle-like images: gaussian blobs in a disc plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:nx, 0:nx]
    imgs = np.zeros((n, nx, nx), np.float32)
    for i in range(n):
        img = np.zeros((nx, nx), np.float64)
        for _ in range(blobs):
            cy = rng.uniform(nx * 0.3, nx * 0.7)
            cx = rng.uniform(nx * 0.3, nx * 0.7)
            s = rng.uniform(1.5, 4.0)
            img += rng.uniform(0.5, 2.0) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        img += rng.normal(0, noise, (nx, nx))
        imgs[i] = img.astype(np.float32)
    return imgs


class PoseStack(NamedTuple):
    images: np.ndarray     # (N, H, W) float32
    class_ids: np.ndarray  # (N,) generating template index
    angles: np.ndarray     # (N,) in-plane rotation, degrees
    shifts: np.ndarray     # (N, 2) integer (sx, sy) pixel shifts
    mirrors: np.ndarray    # (N,) 0/1 mirror flags (all 0 unless mirror)


def pose_stack(templates: np.ndarray, n: int, max_shift: int = 2,
               noise: float = 0.02, seed: int = 0,
               mirror: bool = False) -> PoseStack:
    """Rotated/shifted (and, with ``mirror``, randomly mirrored) copies of
    templates plus white noise of std ``noise`` — ground truth for
    recovery tests, demos and the chip smoke test.  The transform is
    ``rot_shift2d`` (quadri engine, the notebook's exact kernel) on the
    default device."""
    import jax.numpy as jnp

    from ..ops.transform import rot_shift2d

    rng = np.random.default_rng(seed)
    k = templates.shape[0]
    cls = rng.integers(0, k, n)
    angs = rng.uniform(0, 360, n).astype(np.float32)
    sxs = rng.integers(-max_shift, max_shift + 1, n).astype(np.float32)
    sys_ = rng.integers(-max_shift, max_shift + 1, n).astype(np.float32)
    mirrors = (rng.integers(0, 2, n) if mirror
               else np.zeros(n, np.int64)).astype(np.int32)
    imgs = np.array(rot_shift2d(
        jnp.asarray(templates[cls]), jnp.asarray(angs), jnp.asarray(sxs),
        jnp.asarray(sys_), mirror=jnp.asarray(mirrors) if mirror else None,
        engine="quadri"))
    imgs += rng.normal(0, noise, imgs.shape).astype(np.float32)
    return PoseStack(imgs.astype(np.float32), cls, angs,
                     np.stack([sxs, sys_], 1), mirrors)


def scattered_stack(templates: np.ndarray, n: int, max_shift: int = 2,
                    noise: float = 0.02, seed: int = 0):
    """``pose_stack`` without mirrors.

    Returns (images, class_ids, angles, shifts).
    """
    return tuple(pose_stack(templates, n, max_shift, noise, seed)[:4])
