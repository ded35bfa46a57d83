"""CTF-aware alignment ops: premultiplication and Wiener averaging.

The reference *accepts* ``--CTF`` and force-disables it
(``CTF = False  # okay..?``, test_mref_gpu_align.py:308), so there is no
GPU behavior to reproduce — this module implements the SPHIRE CPU-side
semantics the flag was meant to enable (``sxali2d`` with CTF): each
particle is premultiplied by its CTF in Fourier space (``filt_ctf`` —
phase flip + amplitude weighting, which makes the PSF symmetric so the
rotational search is unbiased), and class averages are Wiener-restored by
dividing the summed spectrum by ``sum(ctf_i^2) + 1/snr``.

All transforms are matmul DFTs (ops/dft.py) — no jnp.fft on the device
path.  The CTF model itself is ``analysis.compute_ctf`` (the port of
``compute_ctf_np``, reference src/utils_ralib.py:354-386) evaluated on the
unshifted rfft2 frequency grid, so no fftshift round-trips are needed.

Approximation (standard for 2D class averaging, documented in
docs/design.md): the per-particle ctf^2 accumulation ignores the in-plane
alignment rotation — exact for astigmatism-free CTFs, and averaged out
over random particle orientations otherwise.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..analysis.ctf import compute_ctf
from .dft import irfft2_mm, rfft2_mm


def rfft2_freqs(nx: int, apix: float = 1.0) -> np.ndarray:
    """(nx, nx//2+1, 2) spatial-frequency grid (1/A) of the rfft2 layout
    produced by ``ops.dft.rfft2_mm``: axis -2 is the full (unshifted) DFT
    along y, axis -1 the real-FFT half along x."""
    fy = np.fft.fftfreq(nx) / apix
    fx = np.fft.rfftfreq(nx) / apix
    gx, gy = np.meshgrid(fx, fy)
    return np.stack([gx, gy], axis=-1)


def ctf_rfft2(nx: int, apix, dfu, dfv, dfang, voltage=300.0, cs=2.7,
              w=0.1, phase_shift=0.0, bfactor=None, xp=np):
    """Per-particle 2D CTF on the rfft2 grid.

    Args:
      dfu, dfv, dfang: scalars or (N,) defocus U/V (A) and astigmatism
        angle (deg).
      voltage (kV), cs (mm), w (amplitude contrast), phase_shift (deg),
        bfactor (A^2 or None): scalars.
    Returns (N, nx, nx//2+1) (or (nx, nx//2+1) for scalar defocus).
    """
    freqs = rfft2_freqs(nx, apix)
    shape = freqs.shape[:-1]
    flat = xp.asarray(freqs.reshape(-1, 2))
    ctf = compute_ctf(flat, dfu, dfv, dfang, voltage, cs, w,
                      phase_shift=phase_shift, bfactor=bfactor, xp=xp)
    if getattr(xp.asarray(dfu), "ndim", 0) == 0:
        return ctf.reshape(shape).astype(xp.float32)
    return ctf.reshape((-1,) + shape).astype(xp.float32)


def filt_ctf(images, ctf):
    """Premultiply real images by their CTFs in Fourier space
    (SPHIRE ``filt_ctf``): (N, H, W) x (N, H, Fw) -> (N, H, W)."""
    h, w = images.shape[-2:]
    return irfft2_mm(rfft2_mm(images) * ctf, (h, w))


def class_ctf2_sum(ctf, ref_id, n_classes: int):
    """Per-class sum of ctf^2: (N, H, Fw), (N,) -> (K, H, Fw).

    One-hot matmul like ``class_sum_oe`` — the GSPMD-friendly
    segment sum (no parity split: Wiener restores the *combined*
    average; FSC keeps using the plain even/odd sums)."""
    onehot = jax.nn.one_hot(ref_id, n_classes, dtype=ctf.dtype)  # (N, K)
    return jnp.einsum("nk,nhf->khf", onehot, ctf * ctf,
                      precision=jax.lax.Precision.HIGHEST)


def wiener_restore(summed, ctf2_sum, snr: float):
    """Wiener-restore a summed class average: divide its spectrum by
    ``sum(ctf^2) + 1/snr`` (the ``ctf_2_sum`` division of SPHIRE's
    CTF-aware ``ali2d``).  summed: (..., H, W); ctf2_sum: (..., H, Fw)."""
    h, w = summed.shape[-2:]
    spec = rfft2_mm(summed) / (ctf2_sum + 1.0 / float(snr))
    return irfft2_mm(spec, (h, w))


class CtfContext:
    """Driver-side CTF state: per-particle CTF stack resident on device,
    premultiplication and per-class Wiener restoration.

    Built once per run from per-particle defocus; drivers call
    ``premultiply(images)`` during preprocessing and
    ``restore(sums, assign)`` in the reference update.

    Scales to streaming-size stacks: only per-particle *defocus scalars*
    are stored; the (batch, H, Fw) CTF chunks are synthesized on device
    per fixed-size batch (one compile), so device memory stays
    O(batch * H * Fw) instead of O(N * H * Fw) — the same
    host-streaming contract as ``models/engine.py``.
    """

    def __init__(self, nx: int, ctf_params: dict, snr: float = 1.0,
                 batch: int = 2048):
        p = dict(ctf_params)
        dfu = np.atleast_1d(np.asarray(p.pop("dfu"), np.float64))
        dfv = np.atleast_1d(np.asarray(p.pop("dfv", dfu), np.float64))
        dfang = np.atleast_1d(np.asarray(p.pop("dfang", 0.0), np.float64))
        # phase shift is per-particle capable (Volta phase plates): it
        # rides the defocus table as a fourth column
        phase = np.atleast_1d(np.asarray(p.pop("phase_shift", 0.0),
                                         np.float64))
        n = max(dfu.size, dfv.size, dfang.size, phase.size)
        self.df = np.stack([np.broadcast_to(a, (n,)).astype(np.float64)
                            for a in (dfu, dfv, dfang, phase)],
                           axis=1)  # (N, 4)
        self.snr = float(snr)
        self.nx = nx
        self.n = n
        self.batch = min(batch, n)
        self.scalars = dict(apix=p.pop("apix", 1.0),
                            voltage=p.pop("voltage", 300.0),
                            cs=p.pop("cs", 2.7), w=p.pop("w", 0.1),
                            bfactor=p.pop("bfactor", None))
        if p:
            raise ValueError(f"unknown ctf_params keys: {sorted(p)}")
        flat = rfft2_freqs(nx, self.scalars["apix"]).reshape(-1, 2)
        self._freqs = jnp.asarray(flat, jnp.float32)
        sc = self.scalars

        def ctf_chunk(df):
            """(b, 4) [dfu, dfv, dfang, phase] rows -> (b, H, Fw) CTFs."""
            ctf = compute_ctf(self._freqs, df[:, 0], df[:, 1], df[:, 2],
                              sc["voltage"], sc["cs"], sc["w"],
                              phase_shift=df[:, 3],
                              bfactor=sc["bfactor"], xp=jnp)
            return ctf.reshape(-1, nx, nx // 2 + 1).astype(jnp.float32)

        self._ctf_chunk = jax.jit(ctf_chunk)
        self._premul = jax.jit(lambda im, df: filt_ctf(im, ctf_chunk(df)))
        self._ctf2 = jax.jit(
            lambda df, rid, k: class_ctf2_sum(ctf_chunk(df), rid, k),
            static_argnums=2)

    def _chunks(self):
        """Fixed-size (start, rows) chunks; the tail is padded so every
        call hits the same compiled program."""
        b = self.batch
        for i in range(0, self.n, b):
            sl = self.df[i:i + b]
            pad = b - sl.shape[0]
            if pad:
                sl = np.concatenate([sl, np.zeros((pad, 4))], axis=0)
            yield i, min(b, self.n - i), sl

    def premultiply(self, images) -> np.ndarray:
        """filt_ctf over the stack, streamed in fixed-size batches."""
        images = np.asarray(images, np.float32)
        if images.shape[0] != self.n:
            raise ValueError(f"{images.shape[0]} images vs {self.n} CTFs")
        out = np.empty(images.shape, np.float32)
        for i, nrows, df in self._chunks():
            im = images[i:i + self.batch]
            pad = self.batch - im.shape[0]
            if pad:
                im = np.concatenate(
                    [im, np.zeros((pad,) + im.shape[1:], np.float32)])
            out[i:i + nrows] = np.asarray(
                self._premul(jnp.asarray(im), jnp.asarray(df)))[:nrows]
        return out

    def restore(self, summed, assign=None):
        """Wiener-restore per-class summed averages.

        summed: (K, H, W) summed (even+odd, unnormalized) class images;
        assign: (N,) class ids (None -> all particles in class 0).
        """
        k = summed.shape[0]
        if assign is None:
            assign = np.zeros((self.n,), np.int32)
        assign = np.asarray(assign, np.int32)
        ctf2 = None
        for i, nrows, df in self._chunks():
            rid = assign[i:i + self.batch]
            pad = self.batch - rid.shape[0]
            if pad:
                # padded rows get class 0 but zero defocus -> compute_ctf
                # still yields nonzero values, so mask them via an
                # out-of-range class id (one_hot gives all-zero rows)
                rid = np.concatenate([rid, np.full((pad,), k, np.int32)])
            part = self._ctf2(jnp.asarray(df), jnp.asarray(rid), k)
            ctf2 = part if ctf2 is None else ctf2 + part
        return np.asarray(jax.jit(wiener_restore, static_argnums=2)(
            jnp.asarray(summed), ctf2, self.snr), np.float32)
