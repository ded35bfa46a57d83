"""EMAN2-convention search: variable-length Numrinit rings + ringwe.

Production engine for ``AlignConfig(ring_scheme="eman2")`` — the CPU
twin's exact ring geometry (``Util.Polar2Dm`` over
``Numrinit(first_ring, last_ring, rstep)`` rings with ``ringwe``
weights, test_mref_gpu_align.py:741-750 / ``Util.multiref_polar_ali_2d``
at :771) rather than the reference GPU path's uniform-256 scheme.  The
semantics contract is ``utils.oracle.align_particle_eman_np``
(SURVEY.md §3.3).

Formulation: rings grouped by their (power-of-two) length —
a Numrinit plan has only ~log2(maxrin) distinct lengths — and each
group runs the standard dense pipeline at its own length:

    sample (tent matmuls or bilinear gather) -> matmul rDFT at L_g ->
    weighted conj-multiply vs the group's reference spectra

Each ring contributes its own harmonics (bins 0..L_g/2) into a shared
maxrin-bin ccf spectrum (``Util.Crosrng_ms`` accumulation), which one
matmul irDFT turns into the (mirror, shift, ref, maxrin) rows folded by
the shared running-best logic.  ``cfg.ring_len`` equals maxrin under
the eman2 scheme, so the standard ``decode_params`` (prb1d + 360-theta
flip + mirror+180 + shift clamp) applies unchanged.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..params import AlignParams
from .ccf import ring_spectra
from .dft import irfft_mm
from .polar import polar_resample
from .polar_mm import tent_rows, translate_bilinear_mm
from .search import SearchResult, _NEG_INF, _update_best


def eman_groups(cfg: AlignConfig):
    """Rings grouped by length: [(L_g, ring_idx (R_g,), coords
    (R_g, L_g, 2)), ...] in ascending L_g order.

    Ring at radius r sampled at angles ``2*pi*j/L_g`` about the image
    center — the ``Polar2Dm`` convention modeled by
    ``utils.oracle.polar_rings_np``."""
    assert cfg.ring_scheme == "eman2"
    rings = cfg.eman_rings
    by_len: dict[int, list[int]] = {}
    for i, (_r, ln) in enumerate(rings):
        by_len.setdefault(ln, []).append(i)
    groups = []
    for ln in sorted(by_len):
        idx = np.asarray(by_len[ln], np.int64)
        radii = np.asarray([rings[i][0] for i in idx], np.float64)[:, None]
        ang = 2.0 * np.pi * np.arange(ln, dtype=np.float64)[None, :] / ln
        x = np.cos(ang) * radii
        y = np.sin(ang) * radii
        coords = np.stack([x, y], axis=-1).astype(np.float32)
        groups.append((ln, idx, coords))
    return groups


def prepare_ref_spectra_eman(refs, cfg: AlignConfig):
    """References -> per-group weighted ring spectra
    [(K, R_g, L_g/2+1) complex64, ...] in ``eman_groups`` order.

    The ``ringwe`` weights are folded in (``Util.Applyws`` equivalent,
    test_mref_gpu_align.py:749)."""
    weights = cfg.eman_ring_weights
    maxrin = cfg.ring_len
    out = []
    for ln, idx, coords in eman_groups(cfg):
        # K is small: full-precision tent matmuls via the gather-free
        # sampler (numerically the bilinear gather)
        wy = jnp.asarray(tent_rows(
            cfg.img_dim // 2 + coords[..., 1].reshape(-1), cfg.img_dim))
        wx = jnp.asarray(tent_rows(
            cfg.img_dim // 2 + coords[..., 0].reshape(-1), cfg.img_dim))
        hp = jax.lax.Precision.HIGHEST
        t = jnp.einsum("khw,qh->kqw", refs, wy, precision=hp)
        pol = jnp.einsum("kqw,qw->kq", t, wx, precision=hp)
        pol = pol.reshape(refs.shape[0], idx.shape[0], ln)
        spec = ring_spectra(pol)                      # (K, R_g, F_g)
        wrow = np.repeat(weights[idx][:, None], ln // 2 + 1, axis=1)
        if ln < maxrin:
            # a short ring's Nyquist lands on an INTERIOR bin of the
            # maxrin ccf spectrum, which the final irfft doubles;
            # Applyws pre-halves it (sp_alignment.Applyws: 0.5*w when
            # numr3i != maxrin) so its net weight matches the long rings
            wrow[:, -1] *= 0.5
        w = jnp.asarray(wrow)[None]
        out.append(spec * w.astype(spec.real.dtype))
    return tuple(out)


def _group_tables(cfg: AlignConfig):
    """Per-group constant tent tables for the matmul sampler:
    [(L_g, wy (n_dy, Q_g, H), wx (n_dx, Q_g, W)), ...]."""
    h = w = cfg.img_dim
    cy, cx = h // 2, w // 2
    out = []
    for ln, _idx, coords in eman_groups(cfg):
        py = coords[..., 1].reshape(-1)
        px = coords[..., 0].reshape(-1)
        wy = np.stack([tent_rows(cy + py + dy, h) for dy in cfg.shift_y_vals])
        wx = np.stack([tent_rows(cx + px + dx, w) for dx in cfg.shift_x_vals])
        out.append((ln, wy, wx))
    return out


def rotational_shift_search_eman(
    images,
    ref_fwg,
    params: AlignParams,
    cfg: AlignConfig,
    sampler: str = "matmul",
    fast: bool = True,
    angle_mask=None,
) -> SearchResult:
    """Full (mirror x shift x ref x angle) search under the eman2 ring
    scheme.  Same SearchResult contract and priority order as the
    standard engines; ``ref_fwg`` comes from
    ``prepare_ref_spectra_eman``.

    ``sampler``: "matmul" = accumulated-shift pre-translate + constant
    tent matmuls (exact for integer accumulated shifts),
    "gather" = per-sample bilinear reads with the accumulated shift
    folded into the center (exact texture semantics).
    Both loop over the grid's dy values with all dx candidates per
    step (x-major global shift index, config.shifts order).
    """
    n = images.shape[0]
    maxrin = cfg.ring_len
    n_f = maxrin // 2 + 1
    k_dim = ref_fwg[0].shape[0]
    n_dx = len(cfg.shift_x_vals)
    n_dy = len(cfg.shift_y_vals)
    groups = eman_groups(cfg)
    hp = jax.lax.Precision.HIGHEST

    if sampler == "matmul":
        img_t = translate_bilinear_mm(images, params.shift_x, params.shift_y)
        tables = _group_tables(cfg)
        wy_dev = [jnp.asarray(wy) for _ln, wy, _wx in tables]
        wx_dev = [jnp.asarray(wx) for _ln, _wy, wx in tables]
    else:
        coords_dev = [jnp.asarray(c) for _ln, _i, c in groups]
    dys = jnp.asarray(cfg.shift_y_vals)
    dxs = jnp.asarray(cfg.shift_x_vals)

    init = SearchResult(
        best_val=jnp.full((n,), _NEG_INF, jnp.float32),
        best_row=jnp.zeros((n, maxrin), jnp.float32),
        best_aidx=jnp.zeros((n,), jnp.int32),
        best_sidx=jnp.zeros((n,), jnp.int32),
        best_ref=jnp.zeros((n,), jnp.int32),
        best_mirror=jnp.zeros((n,), jnp.int32),
    )

    def body(carry: SearchResult, yi):
        orig = jnp.zeros((n, n_dx, k_dim, n_f), jnp.complex64)
        mirr = jnp.zeros((n, n_dx, k_dim, n_f), jnp.complex64) \
            if cfg.mirror else None
        for g, (ln, idx, _coords) in enumerate(groups):
            f_g = ln // 2 + 1
            if sampler == "matmul":
                wy_g = wy_dev[g]                      # (n_dy, Q_g, H)
                wx_g = wx_dev[g]                      # (n_dx, Q_g, W)
                wy_slice = jax.lax.dynamic_index_in_dim(
                    wy_g, yi, axis=0, keepdims=False)
                if fast:
                    kw = dict(preferred_element_type=jnp.float32)
                    t = jnp.einsum("nhw,qh->nqw", img_t.astype(jnp.bfloat16),
                                   wy_slice.astype(jnp.bfloat16), **kw)
                    pol = jnp.einsum("nqw,cqw->ncq", t.astype(jnp.bfloat16),
                                     wx_g.astype(jnp.bfloat16), **kw)
                else:
                    t = jnp.einsum("nhw,qh->nqw", img_t, wy_slice,
                                   precision=hp)
                    pol = jnp.einsum("nqw,cqw->ncq", t, wx_g, precision=hp)
                pol = pol.reshape(n, n_dx, idx.shape[0], ln)
            else:
                sy = params.shift_y[:, None] + jnp.broadcast_to(
                    dys[yi], (n, n_dx))
                sx = params.shift_x[:, None] + dxs[None, :]
                pol = polar_resample(images, coords_dev[g], sx, sy)
            sbj_f = ring_spectra(pol.astype(jnp.float32))  # (N, C, R_g, F_g)
            rfw = ref_fwg[g]                               # (K, R_g, F_g)
            # Crosrng_ms accumulation: this group's harmonics land in the
            # shared maxrin spectrum's low bins (oracle ccf_rows_eman_np)
            o_g = jnp.einsum("ncrf,krf->nckf", jnp.conj(sbj_f), rfw,
                             precision=hp)
            orig = orig.at[..., :f_g].add(o_g)
            if cfg.mirror:
                m_g = jnp.conj(jnp.einsum("ncrf,krf->nckf", sbj_f, rfw,
                                          precision=hp))
                mirr = mirr.at[..., :f_g].add(m_g)
        stacked = orig[:, None] if mirr is None \
            else jnp.stack([orig, mirr], axis=1)      # (N, M, C, K, F)
        rows = irfft_mm(stacked, n=maxrin, axis=-1)
        if angle_mask is not None:
            rows = rows + jnp.asarray(angle_mask)
        global_sidx = jnp.arange(n_dx, dtype=jnp.int32) * n_dy + yi
        return _update_best(carry, rows, global_sidx), None

    if n_dy == 1:
        result, _ = body(init, jnp.int32(0))
    else:
        result, _ = jax.lax.scan(body, init,
                                 jnp.arange(n_dy, dtype=jnp.int32))
    return result
