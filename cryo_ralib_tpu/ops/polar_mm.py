"""Gather-free polar resampling: bilinear interpolation as matmuls.

The reference's texture-read polar sampler (``cu_resample_to_polar``,
cuda/gpu_aln_noref.cu:818-879) is rebuilt here as dense matrix algebra
(the gather engine, ``ops/polar.py``, keeps the texture structure):

* Bilinear sampling of a *separable* coordinate offset is exactly a pair
  of "tent" (2-nonzero-per-row) matrix contractions:
  ``sample(img, y+py, x+px) = sum_{j,i} tent(y+py-j) tent(x+px-i) img[j,i]``.

* The search grid's candidate shifts are known at trace time, so for
  every distinct grid dy we precompute a constant tent matrix
  ``Wy[dy] : (Q, H)`` over all Q = ring_num*ring_len sample points, and
  likewise ``Wx[dx] : (Q, W)``.  One dy-group of candidates then costs
  one batched matmul ``T = img @ Wy[dy]^T`` plus a fused
  multiply-reduce against every ``Wx[dx]`` — no gathers anywhere.

* Per-particle *accumulated* shifts (iterations >= 2) are applied by a
  bilinear pre-translation, itself two tent matmuls with matrices built
  on the fly from iota comparisons.  For integer accumulated shifts
  (always the case when ``ts`` is integral) the tent matrices are
  permutations and the two-stage result is *exactly* the reference's
  one-stage bilinear sample; for fractional accumulated shifts the
  two-stage interpolation adds a sub-1% smoothing, comparable to the
  9-bit fixed-point lerp of the CUDA texture hardware.

Clamp-to-edge semantics match ``bilinear_sample`` (texture clamp mode).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

_HP = jax.lax.Precision.HIGHEST


def tent_rows(coords: np.ndarray, size: int) -> np.ndarray:
    """Constant bilinear-weight rows: (Q,) float coords -> (Q, size).

    Row q holds the clamp-to-edge bilinear weights of coordinate
    ``coords[q]`` over the integer grid 0..size-1 (two nonzeros, or one
    at the edges), i.e. ``rows @ v`` == bilinear interpolation of v.
    """
    v = np.clip(coords.astype(np.float64), 0.0, size - 1.0)
    j0 = np.floor(v).astype(np.int64)
    j1 = np.minimum(j0 + 1, size - 1)
    f = v - j0
    rows = np.zeros((coords.shape[0], size), np.float64)
    np.add.at(rows, (np.arange(len(v)), j0), 1.0 - f)
    np.add.at(rows, (np.arange(len(v)), j1), f)
    return rows.astype(np.float32)


@dataclass(frozen=True)
class PolarTables:
    """Precomputed constant sampling matrices for one AlignConfig.

    Attributes:
      wy: (n_dy, Q, H) tent weights of ``cy + ring_y[q] + dy``.
      wx: (n_dx, Q, W) tent weights of ``cx + ring_x[q] + dx``.
      ring_num, ring_len: polar grid shape (Q = ring_num * ring_len).
    """

    wy: np.ndarray
    wx: np.ndarray
    ring_num: int
    ring_len: int

    @property
    def n_dy(self) -> int:
        return self.wy.shape[0]

    @property
    def n_dx(self) -> int:
        return self.wx.shape[0]


def build_polar_tables(cfg) -> PolarTables:
    """Build PolarTables from an AlignConfig (numpy, host-side, cached by
    caller)."""
    coords = cfg.polar_coords  # (R, L, 2), [...,0]=x offset, [...,1]=y
    h = w = cfg.img_dim
    cx = w // 2
    cy = h // 2
    px = coords[..., 0].reshape(-1)
    py = coords[..., 1].reshape(-1)
    wy = np.stack([tent_rows(cy + py + dy, h) for dy in cfg.shift_y_vals])
    wx = np.stack([tent_rows(cx + px + dx, w) for dx in cfg.shift_x_vals])
    return PolarTables(wy=wy, wx=wx, ring_num=cfg.ring_num,
                       ring_len=cfg.ring_len)


def _tent_rows_traced(shift, size: int, dtype, offset: int = 0,
                      out_size: int | None = None):
    """(N,) traced shifts -> (N, out_size, size) tent matrices via iota
    comparisons (no gathers): M[n, a, b] = tent weight of
    (offset + a + shift_n) at b, clamp-to-edge.  ``offset``/``out_size``
    restrict the output rows to a window [offset, offset + out_size) of
    the target grid (the translate+window fusion of the template
    engine)."""
    if out_size is None:
        out_size = size
    a = jnp.arange(out_size, dtype=jnp.float32)[None, :] + float(offset)
    v = jnp.clip(a + shift[:, None].astype(jnp.float32), 0.0, size - 1.0)
    j0 = jnp.floor(v)
    f = v - j0  # (N, out_size)
    b = jnp.arange(size, dtype=jnp.float32)[None, None, :]
    j0e = j0[:, :, None]
    j1e = jnp.minimum(j0e + 1.0, size - 1.0)
    m = jnp.where(b == j0e, 1.0 - f[:, :, None], 0.0)
    m = m + jnp.where(b == j1e, f[:, :, None], 0.0)
    return m.astype(dtype)


def translate_bilinear_mm(images, shift_x, shift_y, fast: bool = False):
    """Bilinear-translate each image so that
    ``out[y, x] = bilinear(img, y + shift_y, x + shift_x)`` — the
    accumulated-shift recentering the CUDA kernel folds into its texture
    read (cuda/gpu_aln_noref.cu:861-863), as two tent matmuls.

    Exact (a pure row/column permutation) for integer shifts.

    ``fast`` runs bf16 x bf16 -> f32 (tensor cores) instead of the
    f32-HIGHEST 6-pass matmuls — for INTEGER shifts the one-hot tents
    make the result exactly the bf16 cast of the exact translate, which
    is bit-equivalent for any consumer that casts to bf16 anyway;
    fractional accumulated shifts add the usual ~0.4% bf16 tent noise
    (the same order as the CUDA texture lerp).
    """
    n, h, w = images.shape
    if fast:
        ty = _tent_rows_traced(jnp.asarray(shift_y), h, jnp.bfloat16)
        tx = _tent_rows_traced(jnp.asarray(shift_x), w, jnp.bfloat16)
        kw = dict(preferred_element_type=jnp.float32)
        out = jnp.einsum("nab,nbw->naw", ty, images.astype(jnp.bfloat16),
                         **kw)
        return jnp.einsum("naw,nxw->nax", out.astype(jnp.bfloat16), tx,
                          **kw)
    ty = _tent_rows_traced(jnp.asarray(shift_y), h, images.dtype)  # (N,H,H)
    tx = _tent_rows_traced(jnp.asarray(shift_x), w, images.dtype)  # (N,W,W)
    out = jnp.einsum("nab,nbw->naw", ty, images, precision=_HP)
    return jnp.einsum("naw,nxw->nax", out, tx, precision=_HP)


def translate_window_mm(images, shift_x, shift_y, lo: int, width: int,
                        fast: bool = True):
    """Fused accumulated-shift translate + central-window extraction:
    ``out[n, a, b] = bilinear(img_n, lo + a + shift_y_n,
    lo + b + shift_x_n)`` for a, b in [0, width) — algebraically
    ``translate_bilinear_mm(...)[:, lo:lo+width, lo:lo+width]`` but the
    tent matmuls only produce the window rows/columns (the template
    engine's pre-translate: the full-image translate would do
    ~(H/width)^2 x the work, at f32-HIGHEST).

    ``fast`` runs bf16 x bf16 -> f32 (tensor cores).  For integer shifts
    the tents are one-hot, so fast mode is exactly the bf16 cast of the
    exact window — bit-identical to what the bf16 search matmul consumed
    before; fractional accumulated shifts add the usual ~0.4% bf16
    interpolation noise (same order as the CUDA texture lerp).
    """
    n, h, w = images.shape
    dtype = jnp.bfloat16 if fast else images.dtype
    ty = _tent_rows_traced(jnp.asarray(shift_y), h, dtype,
                           offset=lo, out_size=width)   # (N, width, H)
    tx = _tent_rows_traced(jnp.asarray(shift_x), w, dtype,
                           offset=lo, out_size=width)   # (N, width, W)
    if fast:
        kw = dict(preferred_element_type=jnp.float32)
        out = jnp.einsum("nab,nbw->naw", ty, images.astype(jnp.bfloat16),
                         **kw)
        out = jnp.einsum("naw,nxw->nax", out.astype(jnp.bfloat16), tx, **kw)
        return out
    out = jnp.einsum("nab,nbw->naw", ty, images, precision=_HP)
    return jnp.einsum("naw,nxw->nax", out, tx, precision=_HP)


def polar_group_mm(img_t, wy_slice, wx_all, ring_num: int, ring_len: int,
                   fast: bool = False):
    """Sample one dy-group of shift candidates for a whole batch.

    Args:
      img_t: (N, H, W) pre-translated images.
      wy_slice: (Q, H) tent matrix for this dy.
      wx_all: (n_dx, Q, W) tent matrices for every dx.
      fast: run the big matmuls in bf16 with f32 accumulation (error
        magnitude matches the reference GPU's 9-bit texture lerp
        quantization).  False = full f32 (HIGHEST).

    Returns:
      (N, n_dx, R, L) float32 polar stacks.
    """
    n = img_t.shape[0]
    n_dx = wx_all.shape[0]
    if fast:
        img_c = img_t.astype(jnp.bfloat16)
        wy_c = wy_slice.astype(jnp.bfloat16)
        wx_c = wx_all.astype(jnp.bfloat16)
        kw = dict(preferred_element_type=jnp.float32)
    else:
        img_c, wy_c, wx_c = img_t, wy_slice, wx_all
        kw = dict(precision=_HP)
    # y-contraction: (N, Q, W)
    t = jnp.einsum("nhw,qh->nqw", img_c, wy_c, **kw)
    if fast:
        t = t.astype(jnp.bfloat16)
    # x-contraction, fused multiply-reduce per dx
    polar = jnp.einsum("nqw,cqw->ncq", t, wx_c, **kw)
    return polar.reshape(n, n_dx, ring_num, ring_len).astype(jnp.float32)


def polar_resample_mm(images, cfg):
    """Zero-shift polar resampling via the tent matmuls at full f32 —
    numerically equal to the bilinear gather (used for reference stacks;
    cu_resample_to_polar with
    shift=0, cuda/gpu_aln_noref.cu:396)."""
    coords = cfg.polar_coords
    h = w = cfg.img_dim
    q = cfg.ring_num * cfg.ring_len
    wy = jnp.asarray(tent_rows(h // 2 + coords[..., 1].reshape(-1), h))
    wx = jnp.asarray(tent_rows(w // 2 + coords[..., 0].reshape(-1), w))
    t = jnp.einsum("nhw,qh->nqw", images, wy, precision=_HP)
    pol = jnp.einsum("nqw,qw->nq", t, wx, precision=_HP)
    del q
    return pol.reshape(images.shape[0], cfg.ring_num, cfg.ring_len)
