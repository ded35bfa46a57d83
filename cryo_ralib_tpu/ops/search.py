"""Fused rotational + translational + mirror alignment search.

This is the JAX rewrite of the reference's hot loop
(``mref_align_run``/``pre_align_run``, cuda/gpu_aln_noref.cu:389-546):

    for each shift: polar-resample -> ring FFT -> ccf vs refs (+mirror)
    IFFT whole table -> per-particle argmax -> decode params

The CUDA version materializes the full ccf table
``(ring_len+2) * sbj * ref * shifts * 2`` floats and argmaxes it.  Here the
shift axis is processed in chunks inside a ``lax.scan`` that keeps a
*running* per-particle best — value, decoded indices, and the single
best angle row needed later for parabolic refinement — so device memory
never holds more than one chunk of ccf rows.  This removes the reference's
main memory ceiling (its N10 size-check machinery; SURVEY.md §7 "hard
parts").

All shapes are static; the scan length is ceil(S / chunk) with masked
padding, so one compilation serves every iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AlignConfig
from ..params import AlignParams
from .ccf import ccf_rows, ccf_spectra, ccf_spectra_per_particle_ref, ring_spectra, weight_ring_spectra
from .polar import polar_resample
from .polar_mm import PolarTables, build_polar_tables, polar_group_mm, translate_bilinear_mm

_NEG_INF = -3.0e38


def delta_angle_bins(ring_len: int, delta: float, mode: str = "F") -> np.ndarray:
    """Angle bins eligible under a discrete-angle (``delta``) search.

    The CPU twin's ``--dst`` flag makes every 4th iteration search only
    rotations that are multiples of ``delta`` degrees
    (``ali2d_single_iter(..., delta=dst)`` -> EMAN2
    ``Util.Crosrng_ms_delta``; schedule at
    test_reffree_gpu_align.py:841-846).  On the uniform ``ring_len``-bin
    ccf rows the equivalent is restricting the argmax to the bins nearest
    each multiple of delta within the ring span (360 deg for mode "F",
    180 for "H").  Returns the sorted unique int bin indices.
    """
    if delta <= 0.0:
        raise ValueError("delta must be positive")
    span = 360.0 if mode == "F" else 180.0
    step = span / ring_len
    angles = np.arange(0.0, span - 1e-9, delta)
    bins = np.unique(np.round(angles / step).astype(np.int64) % ring_len)
    return bins


def delta_angle_mask(ring_len: int, delta: float, mode: str = "F") -> np.ndarray:
    """Additive (L,) f32 mask: 0 at ``delta_angle_bins``, -inf elsewhere."""
    mask = np.full(ring_len, _NEG_INF, np.float32)
    mask[delta_angle_bins(ring_len, delta, mode)] = 0.0
    return mask


class SearchResult(NamedTuple):
    """Raw per-particle search outcome (pre-decode)."""

    best_val: jax.Array   # (N,) peak ccf value
    best_row: jax.Array   # (N, L) angle row of the winning (mirror, shift, ref)
    best_aidx: jax.Array  # (N,) int32 angle bin of the peak
    best_sidx: jax.Array  # (N,) int32 global shift-grid index
    best_ref: jax.Array   # (N,) int32 winning reference
    best_mirror: jax.Array  # (N,) int32 0/1


def prepare_ref_spectra(refs, cfg: AlignConfig):
    """References -> weighted ring spectra (K, R, F).

    Matches ``ref_batch->resample_to_polar(0,0,0) + apply_FFT`` at the top
    of every *_run call (cuda/gpu_aln_noref.cu:396-397) with the ring
    weights folded in.  Sampling runs as full-precision tent matmuls
    (== the bilinear gather numerically).
    """
    from .polar_mm import polar_resample_mm

    ref_polar = polar_resample_mm(refs, cfg)  # (K, R, L)
    ref_f = ring_spectra(ref_polar)
    return weight_ring_spectra(ref_f, jnp.asarray(cfg.ring_weights))


def rotational_shift_search(
    images,
    ref_fw,
    params: AlignParams,
    cfg: AlignConfig,
    shift_chunk: int = 8,
    per_particle_ref: bool = False,
    angle_mask=None,
) -> SearchResult:
    """Run the full (mirror x shift x ref x angle) search for one batch.

    Args:
      images: (N, H, W) float32 particle stack (HBM resident).
      ref_fw: (K, R, F) weighted reference ring spectra
              (``prepare_ref_spectra``).
      params: current AlignParams; accumulated shifts feed the resampling
              center exactly like ``u_aln_param[i].shift_x`` in
              ``cu_resample_to_polar`` (cuda/gpu_aln_noref.cu:861-863).
      cfg:    AlignConfig (shift grid, rings).
      shift_chunk: how many candidate shifts to materialize at once; purely
              a memory/perf knob, result is identical.
      per_particle_ref: use each particle's current ref only
              (``cu_ccf_mult`` semantics) instead of all refs.
      angle_mask: optional (L,) additive f32 mask restricting the angle
              argmax (``delta_angle_mask`` — the --dst discrete-angle
              search); decode with ``refine=False`` when set.

    Returns:
      SearchResult with the winning (value, row, angle bin, shift, ref,
      mirror) per particle.
    """
    n = images.shape[0]
    ring_len = cfg.ring_len
    shifts = cfg.shifts  # (S, 2) numpy
    s_total = shifts.shape[0]
    chunk = max(1, min(shift_chunk, s_total))
    n_chunks = math.ceil(s_total / chunk)
    pad = n_chunks * chunk - s_total

    shifts_padded = np.concatenate(
        [shifts, np.zeros((pad, 2), np.float32)], axis=0
    ).reshape(n_chunks, chunk, 2)
    valid = np.concatenate(
        [np.ones(s_total, np.float32), np.zeros(pad, np.float32)]
    ).reshape(n_chunks, chunk)

    coords = jnp.asarray(cfg.polar_coords)
    shifts_dev = jnp.asarray(shifts_padded)
    # additive mask: 0 for real shifts, -inf for padding
    mask_dev = jnp.asarray(np.where(valid > 0, 0.0, _NEG_INF).astype(np.float32))

    init = SearchResult(
        best_val=jnp.full((n,), _NEG_INF, jnp.float32),
        best_row=jnp.zeros((n, ring_len), jnp.float32),
        best_aidx=jnp.zeros((n,), jnp.int32),
        best_sidx=jnp.zeros((n,), jnp.int32),
        best_ref=jnp.zeros((n,), jnp.int32),
        best_mirror=jnp.zeros((n,), jnp.int32),
    )

    def body(carry: SearchResult, xs):
        chunk_idx, chunk_shifts, chunk_mask = xs
        # total shift per (particle, candidate): accumulated + global grid
        sx = params.shift_x[:, None] + chunk_shifts[None, :, 0]
        sy = params.shift_y[:, None] + chunk_shifts[None, :, 1]
        polar = polar_resample(images, coords, sx, sy)  # (N, C, R, L)
        sbj_f = ring_spectra(polar)
        if per_particle_ref:
            orig_f, mirr_f = ccf_spectra_per_particle_ref(sbj_f, ref_fw, params.ref_id)
        else:
            orig_f, mirr_f = ccf_spectra(sbj_f, ref_fw)
        if not cfg.mirror:
            mirr_f = None   # --nomirror: skip the mirrored channel
        rows = ccf_rows(orig_f, mirr_f, ring_len)  # (N, M, C, K, L)
        rows = rows + chunk_mask[None, None, :, None, None]
        if angle_mask is not None:
            rows = rows + jnp.asarray(angle_mask)
        global_sidx = chunk_idx * chunk + jnp.arange(chunk, dtype=jnp.int32)
        return _update_best(carry, rows, global_sidx), None

    xs = (jnp.arange(n_chunks, dtype=jnp.int32), shifts_dev, mask_dev)
    if n_chunks == 1:
        result, _ = body(init, (jnp.int32(0), shifts_dev[0], mask_dev[0]))
    else:
        result, _ = jax.lax.scan(body, init, xs)
    return result


def _update_best(carry: SearchResult, rows, global_sidx) -> SearchResult:
    """Fold one chunk of ccf rows into the running per-particle best.

    ``rows``: (N, M, C, K, L) ordered [orig, mirr] (M=1 when the mirror
    channel is disabled) / chunk-candidate / ref / angle; ``global_sidx``:
    (C,) int32 map from chunk candidate to the global shift-grid index.
    Flat argmax order (mirror, shift, ref, angle) matches the reference
    table layout (cuda/gpu_aln_noref.cu:2172-2178); strict '>' keeps the
    first-seen maximum across chunks, matching the left-to-right tie
    behavior of the reference row scan.
    """
    n, n_mirr, chunk, k, ring_len = rows.shape
    flat = rows.reshape(n, -1)
    idx = jnp.argmax(flat, axis=1)
    val = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]

    # decompose flat index ordered (mirror, chunk_pos, ref, angle)
    aidx = (idx % ring_len).astype(jnp.int32)
    rest = idx // ring_len
    ridx = (rest % k).astype(jnp.int32)
    rest = rest // k
    cidx = (rest % chunk).astype(jnp.int32)
    midx = (rest // chunk).astype(jnp.int32)

    row = jnp.take_along_axis(
        rows.reshape(n, n_mirr * chunk * k, ring_len),
        (idx // ring_len)[:, None, None], axis=1)[:, 0, :]

    better = val > carry.best_val
    sel_i = lambda new, old: jnp.where(better, new, old)
    return SearchResult(
        best_val=jnp.where(better, val, carry.best_val),
        best_row=jnp.where(better[:, None], row, carry.best_row),
        best_aidx=sel_i(aidx, carry.best_aidx),
        best_sidx=sel_i(jnp.take(jnp.asarray(global_sidx, jnp.int32), cidx),
                        carry.best_sidx),
        best_ref=sel_i(ridx, carry.best_ref),
        best_mirror=sel_i(midx, carry.best_mirror),
    )


def rotational_shift_search_mm(
    images,
    ref_fw,
    params: AlignParams,
    cfg: AlignConfig,
    tables: PolarTables | None = None,
    per_particle_ref: bool = False,
    fast: bool = True,
    angle_mask=None,
) -> SearchResult:
    """Gather-free variant of ``rotational_shift_search`` (the matmul
    engine).

    Identical search semantics, different sampling engine: the particle
    stack is bilinear-pre-translated by each particle's accumulated
    shift (``translate_bilinear_mm`` — exact for integer shifts), then a
    ``lax.scan`` over the distinct grid dy values samples all dx
    candidates of that dy with constant tent matmuls
    (``polar_group_mm``), runs the ring DFT ccf and folds the chunk into
    the running best.  Chunking is therefore fixed to one dy-group (all
    dx at once); global shift index = xi * n_dy_vals + yi per the
    x-major grid order (config.shifts).

    ``fast=True`` runs the sampling matmuls in bf16xf32 (tensor cores);
    the quantization error is the same order as the CUDA texture
    hardware's 9-bit lerp weights.
    """
    if tables is None:
        tables = build_polar_tables(cfg)
    n = images.shape[0]
    ring_len = cfg.ring_len
    n_dy = tables.n_dy

    img_t = translate_bilinear_mm(images, params.shift_x, params.shift_y)

    wy_stack = jnp.asarray(tables.wy)   # (n_dy, Q, H)
    wx_all = jnp.asarray(tables.wx)     # (n_dx, Q, W)

    init = SearchResult(
        best_val=jnp.full((n,), _NEG_INF, jnp.float32),
        best_row=jnp.zeros((n, ring_len), jnp.float32),
        best_aidx=jnp.zeros((n,), jnp.int32),
        best_sidx=jnp.zeros((n,), jnp.int32),
        best_ref=jnp.zeros((n,), jnp.int32),
        best_mirror=jnp.zeros((n,), jnp.int32),
    )

    def body(carry: SearchResult, xs):
        yi, wy_slice = xs
        polar = polar_group_mm(img_t, wy_slice, wx_all,
                               cfg.ring_num, ring_len, fast=fast)
        sbj_f = ring_spectra(polar)
        if per_particle_ref:
            orig_f, mirr_f = ccf_spectra_per_particle_ref(sbj_f, ref_fw, params.ref_id)
        else:
            orig_f, mirr_f = ccf_spectra(sbj_f, ref_fw)
        if not cfg.mirror:
            mirr_f = None   # --nomirror: skip the mirrored channel
        rows = ccf_rows(orig_f, mirr_f, ring_len)  # (N, M, n_dx, K, L)
        if angle_mask is not None:
            rows = rows + jnp.asarray(angle_mask)
        # x-major global order: sidx = xi * n_dy + yi
        global_sidx = jnp.arange(tables.n_dx, dtype=jnp.int32) * n_dy + yi
        return _update_best(carry, rows, global_sidx), None

    xs = (jnp.arange(n_dy, dtype=jnp.int32), wy_stack)
    if n_dy == 1:
        result, _ = body(init, (jnp.int32(0), wy_stack[0]))
    else:
        result, _ = jax.lax.scan(body, init, xs)
    return result


_SHC_BIG = 2**31 - 1


def _shc_init(n: int, ring_len: int):
    """Initial (SearchResult, best_prio) carry for the SHC fold."""
    return (
        SearchResult(
            best_val=jnp.full((n,), _NEG_INF, jnp.float32),
            best_row=jnp.zeros((n, ring_len), jnp.float32),
            best_aidx=jnp.zeros((n,), jnp.int32),
            best_sidx=jnp.zeros((n,), jnp.int32),
            best_ref=jnp.zeros((n,), jnp.int32),
            best_mirror=jnp.zeros((n,), jnp.int32),
        ),
        jnp.full((n,), jnp.int32(_SHC_BIG), jnp.int32),
    )


def _shc_fold(carry, rows, global_sidx, s_total: int, previousmax):
    """Fold one chunk of ccf rows into the running SHC pick.

    ``rows``: (N, M, C, K, L); ``global_sidx``: (C,) int32 global
    shift-grid indices of the chunk candidates.  The SHC rule keeps the
    candidate with the MINIMUM global priority ``(m * S + sidx) * K + k``
    whose peak-over-angles beats ``previousmax`` — chunk order therefore
    does not matter (the fold is a running min).
    """
    best, best_prio = carry
    n, n_mirr, chunk, k_dim, ring_len = rows.shape
    big = jnp.int32(_SHC_BIG)

    # per-candidate peak over angles; global priority per candidate
    rmax = jnp.max(rows, axis=-1)                    # (N, M, C, K)
    m_i = jnp.arange(n_mirr, dtype=jnp.int32)[:, None, None]
    c_g = jnp.asarray(global_sidx, jnp.int32)[None, :, None]
    k_i = jnp.arange(k_dim, dtype=jnp.int32)[None, None, :]
    prio = (m_i * s_total + c_g) * k_dim + k_i       # (M, C, K)

    passing = rmax > previousmax[:, None, None, None]
    pm = jnp.where(passing, prio[None], big)
    flatp = pm.reshape(n, -1)
    idx = jnp.argmin(flatp, axis=1)
    minp = jnp.take_along_axis(flatp, idx[:, None], axis=1)[:, 0]

    val = jnp.take_along_axis(rmax.reshape(n, -1), idx[:, None],
                              axis=1)[:, 0]
    row = jnp.take_along_axis(
        rows.reshape(n, n_mirr * chunk * k_dim, ring_len),
        idx[:, None, None], axis=1)[:, 0, :]
    aidx = jnp.argmax(row, axis=-1).astype(jnp.int32)

    # decode the *global* priority index (the sidx is already global)
    ridx = (minp % k_dim).astype(jnp.int32)
    rest = minp // k_dim
    sidx = (rest % s_total).astype(jnp.int32)
    midx = (rest // s_total).astype(jnp.int32)

    better = minp < best_prio
    sel = lambda new, old: jnp.where(better, new, old)
    new_best = SearchResult(
        best_val=sel(val, best.best_val),
        best_row=jnp.where(better[:, None], row, best.best_row),
        best_aidx=sel(aidx, best.best_aidx),
        best_sidx=sel(sidx, best.best_sidx),
        best_ref=sel(ridx, best.best_ref),
        best_mirror=sel(midx, best.best_mirror),
    )
    return (new_best, jnp.minimum(minp, best_prio))


def rotational_shift_search_shc(
    images,
    ref_fw,
    params: AlignParams,
    cfg: AlignConfig,
    previousmax,
    shift_chunk: int = 8,
    per_particle_ref: bool = False,
):
    """Stochastic-hill-climbing (SHC) variant of the search.

    Instead of the global argmax, each particle takes the FIRST candidate
    in the reference priority order (mirror, shift, ref) whose angle-row
    peak beats its ``previousmax`` — the ``random_method="SHC"`` rule of
    the CPU twin (test_reffree_gpu_align.py:519-524,724: particles carry
    a ``previousmax`` attr seeded at 1.0e-23; ``nope`` counts
    non-improvers).  Improvement granularity is a (mirror, shift, ref)
    candidate with its angle argmax, like EMAN2 ``Util.shc`` which scans
    candidates and compares each candidate's peak-over-angles; the
    reference scans in random order, this implementation is deterministic
    (priority order) — same hill-climbing contract, reproducible tests.

    This is the exact-gather sampling engine; the matmul and template
    engines are ``rotational_shift_search_shc_mm`` and
    ``ops.template_search.template_search_shc`` (same fold, same pick).

    Returns ``(SearchResult, found)`` where ``found`` is a (N,) bool mask;
    particles with no improving candidate keep zero-filled result fields
    and the caller must retain their old params (and previousmax).
    """
    n = images.shape[0]
    ring_len = cfg.ring_len
    shifts = cfg.shifts
    s_total = shifts.shape[0]
    chunk = max(1, min(shift_chunk, s_total))
    n_chunks = math.ceil(s_total / chunk)
    pad = n_chunks * chunk - s_total

    shifts_padded = np.concatenate(
        [shifts, np.zeros((pad, 2), np.float32)], axis=0
    ).reshape(n_chunks, chunk, 2)
    valid = np.concatenate(
        [np.ones(s_total, np.float32), np.zeros(pad, np.float32)]
    ).reshape(n_chunks, chunk)

    coords = jnp.asarray(cfg.polar_coords)
    shifts_dev = jnp.asarray(shifts_padded)
    mask_dev = jnp.asarray(np.where(valid > 0, 0.0, _NEG_INF).astype(np.float32))

    init = _shc_init(n, ring_len)

    def body(carry, xs):
        chunk_idx, chunk_shifts, chunk_mask = xs
        sx = params.shift_x[:, None] + chunk_shifts[None, :, 0]
        sy = params.shift_y[:, None] + chunk_shifts[None, :, 1]
        polar = polar_resample(images, coords, sx, sy)
        sbj_f = ring_spectra(polar)
        if per_particle_ref:
            orig_f, mirr_f = ccf_spectra_per_particle_ref(
                sbj_f, ref_fw, params.ref_id)
        else:
            orig_f, mirr_f = ccf_spectra(sbj_f, ref_fw)
        if not cfg.mirror:
            mirr_f = None
        rows = ccf_rows(orig_f, mirr_f, ring_len)  # (N, M, C, K, L)
        # padded candidates: -inf rows never beat previousmax
        rows = rows + chunk_mask[None, None, :, None, None]
        gs = chunk_idx * chunk + jnp.arange(chunk, dtype=jnp.int32)
        return _shc_fold(carry, rows, gs, s_total, previousmax), None

    xs = (jnp.arange(n_chunks, dtype=jnp.int32), shifts_dev, mask_dev)
    if n_chunks == 1:
        carry, _ = body(init, (jnp.int32(0), shifts_dev[0], mask_dev[0]))
    else:
        carry, _ = jax.lax.scan(body, init, xs)
    result, best_prio = carry
    return result, best_prio < _SHC_BIG


def rotational_shift_search_shc_mm(
    images,
    ref_fw,
    params: AlignParams,
    cfg: AlignConfig,
    previousmax,
    tables: PolarTables | None = None,
    per_particle_ref: bool = False,
    fast: bool = True,
):
    """Gather-free SHC search (the matmul engine).

    Same hill-climbing pick as ``rotational_shift_search_shc`` (the fold
    is shared), same sampling engine as ``rotational_shift_search_mm``:
    bilinear pre-translate + constant tent matmuls per dy-group.  The
    pick is a running min over global candidate priorities, so the
    dy-group chunk order is immaterial.
    """
    if tables is None:
        tables = build_polar_tables(cfg)
    n = images.shape[0]
    ring_len = cfg.ring_len
    n_dy = tables.n_dy
    s_total = cfg.n_shifts

    img_t = translate_bilinear_mm(images, params.shift_x, params.shift_y)
    wy_stack = jnp.asarray(tables.wy)
    wx_all = jnp.asarray(tables.wx)
    init = _shc_init(n, ring_len)

    def body(carry, xs):
        yi, wy_slice = xs
        polar = polar_group_mm(img_t, wy_slice, wx_all,
                               cfg.ring_num, ring_len, fast=fast)
        sbj_f = ring_spectra(polar)
        if per_particle_ref:
            orig_f, mirr_f = ccf_spectra_per_particle_ref(
                sbj_f, ref_fw, params.ref_id)
        else:
            orig_f, mirr_f = ccf_spectra(sbj_f, ref_fw)
        if not cfg.mirror:
            mirr_f = None
        rows = ccf_rows(orig_f, mirr_f, ring_len)  # (N, M, n_dx, K, L)
        gs = jnp.arange(tables.n_dx, dtype=jnp.int32) * n_dy + yi
        return _shc_fold(carry, rows, gs, s_total, previousmax), None

    xs = (jnp.arange(n_dy, dtype=jnp.int32), wy_stack)
    if n_dy == 1:
        carry, _ = body(init, (jnp.int32(0), wy_stack[0]))
    else:
        carry, _ = jax.lax.scan(body, init, xs)
    result, best_prio = carry
    return result, best_prio < _SHC_BIG


def decode_params(
    result: SearchResult, params: AlignParams, cfg: AlignConfig,
    update_ref: bool = True, refine: bool = True,
) -> AlignParams:
    """Turn a SearchResult into updated AlignParams.

    Reproduces ``CcfResultTable::compute_alignment_param`` and
    ``interpolate_angle`` (cuda/gpu_aln_noref.cu:2249-2314, 2352-2399):

    * shifts accumulate (``+=``) and clamp to ``+/-(img_dim-ring_num-2)``;
    * angle = parabolic refinement of the peak bin (SPARX ``Util::prb1d``
      7-point fit), then EMAN2-compatibility flip ``360 - angle`` and
      ``+180`` (mod 360) when mirrored.  In mode "H" the bin step is
      180/ring_len (EMAN2 ``ang_n`` half-ring convention); the same flip
      applies.

    ``refine=False`` skips the parabolic fit and returns the exact bin
    angle — required for discrete-angle (``angle_mask``) searches, whose
    winning row holds -inf at masked neighbor bins (and whose contract is
    an exact multiple of delta, ``Util.Crosrng_ms_delta`` semantics).
    """
    ring_len = cfg.ring_len
    step = cfg.angle_step

    base_angle = step * result.best_aidx.astype(jnp.float32)
    if refine:
        # 7-point window around the peak, circular in angle (modulo
        # ring_len, as in the CUDA code which wraps with % ring_len).
        # Gather-free: a one-hot of the peak bin dotted against 7 static
        # rolls of the row, no dynamic per-particle gather.
        onehot = (jnp.arange(ring_len, dtype=jnp.int32)[None, :]
                  == result.best_aidx[:, None]).astype(result.best_row.dtype)
        cols = []
        for i in range(-3, 4):
            # x_i[n] = row[n, (aidx+i) % L] = sum_a row[n, a] onehot[n, a-i]
            cols.append(jnp.sum(result.best_row * jnp.roll(onehot, i, axis=1),
                                axis=1))
        x = jnp.stack(cols, axis=1)  # (N, 7)

        c2 = (49.0 * x[:, 0] + 6.0 * x[:, 1] - 21.0 * x[:, 2] - 32.0 * x[:, 3]
              - 27.0 * x[:, 4] - 6.0 * x[:, 5] + 31.0 * x[:, 6])
        c3 = (5.0 * x[:, 0] - 3.0 * x[:, 2] - 4.0 * x[:, 3] - 3.0 * x[:, 4]
              + 5.0 * x[:, 6])
        frac = jnp.where(c3 != 0.0, step * (c2 / (2.0 * c3) - 4.0), 0.0)
        angle = 360.0 - (base_angle + frac)
    else:
        angle = 360.0 - base_angle
    mirrored = result.best_mirror == 1
    # the reference wraps into [0, 360) only on the mirrored branch
    # (cuda/gpu_aln_noref.cu:2306-2310); replicate exactly
    angle_m = angle + 180.0
    angle_m = jnp.where(angle_m >= 360.0, angle_m - 360.0, angle_m)
    angle = jnp.where(mirrored, angle_m, angle)

    # shift lookup as a one-hot matmul (gather-free)
    shift_grid = jnp.asarray(cfg.shifts)  # (S, 2)
    s_onehot = (jnp.arange(shift_grid.shape[0], dtype=jnp.int32)[None, :]
                == result.best_sidx[:, None]).astype(jnp.float32)
    ds = jnp.matmul(s_onehot, shift_grid,
                    precision=jax.lax.Precision.HIGHEST)  # (N, 2)
    dsx = ds[:, 0]
    dsy = ds[:, 1]
    limit = cfg.shift_limit
    new_sx = jnp.clip(params.shift_x + dsx, -limit, limit)
    new_sy = jnp.clip(params.shift_y + dsy, -limit, limit)

    return AlignParams(
        angle=angle.astype(jnp.float32),
        shift_x=new_sx,
        shift_y=new_sy,
        mirror=result.best_mirror,
        ref_id=result.best_ref if update_ref else params.ref_id,
    )
