"""Brute-force template-matmul search engine (``sampler="template"``).

The whole (mirror x shift x ref x angle) ccf table is computed as ONE
pixel-domain bf16 matmul (tensor cores on the GPU):

    ccf[n, m, s, k, l] = <img_t[n], T[m, s, k, l]>

where ``img_t`` is the accumulated-shift pre-translated particle
(``translate_bilinear_mm``, same first stage as the matmul sampler) and
``T`` is the bilinear-splat back-projection of the ring-weighted,
angle-rolled polar reference rings, spatially shifted by the integer
search-grid offset.  Because the splat uses the SAME tent algebra as
``ops/polar_mm.py``, this is algebraically the production ccf table —
not an approximation (tests/test_template.py checks winner parity
against ``rotational_shift_search_mm``).

Why a third engine:

* The frequency-domain ring contraction of the other engines is
  elementwise per frequency bin; the template formulation spends
  ~2.6 GFLOP/particle (90 px, K=8, S=49) of pure bf16 matmul instead —
  the shape cuBLAS and the tensor cores want.
* It is pure ``dot_general`` + ``fori_loop``, so it partitions under
  GSPMD over a particle mesh.
* Any ``img_dim``/``ring_len``/K runs; cost scales with the template
  window area.

Template build (per iteration — refs change): the correlation over the
ring angle t is done per frequency against the precomputed splat
spectra, so the per-iteration work is two small ring-contractions, one
inverse-DFT matmul, and the 49 shifted window slices:

    tb_orig[k, l, px] = sum_r irfft(ref_fw[k, r] * conj(SF[r, :, px]))[l]
    tb_mirr[k, l, px] = sum_r irfft(ref_fw[k, r] *      SF[r, :, px] )[-l % L]

(``ref_fw`` from ``prepare_ref_spectra`` is exactly the weighted ring
spectra this needs; SF is the rfft-over-t of the splat tensor
``Wy0[q,h] * Wx0[q,w]``.)  The normalized inverse DFT of ``ccf_rows``
cancels the unnormalized forward, so no extra scale appears.

Fractional shift grids (e.g. ``--ts=0.5``): every grid shift is
floor-decomposed into an integer pixel roll plus a sub-pixel remainder;
shifts sharing a remainder share one splat-spectra build with the tents
evaluated at ``coords + frac`` — the same tent algebra the matmul
sampler's per-shift tables use (ops/polar_mm.py:103-109), so the table
stays exact.  The gate caps the number of unique remainders at
``MAX_FRAC_GROUPS``.

Reference being replaced: the ``mref_align_run`` hot loop
(cuda/gpu_aln_noref.cu:389-416) — resample + FFT + ccf + argmax over
the CcfResultTable — collapsed into matmul + online argmax.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from .dft import irfft_mm, rfft_mm
from .polar_mm import tent_rows, translate_window_mm
from .search import SearchResult, _NEG_INF

# f32 contractions state their precision: an unspecified f32 product may
# run in TF32 (~3 decimal digits) on the GPU
_HP = jax.lax.Precision.HIGHEST

# soft budget for the padded template blocks (the search streams column
# chunks from them, so this only bounds residency)
TEMPLATE_MATRIX_BUDGET_BYTES = 6 << 30

# fractional shift grids: each unique fractional (fy, fx) remainder needs
# its own splat-spectra build per iteration (~30 GFLOP each — small next
# to the search matmul, but capped so a pathological grid can't turn the
# template build into the hot loop).  ts=0.5 grids need 4 groups,
# ts=0.25 sixteen.
MAX_FRAC_GROUPS = 16


def _split_shift(v: float) -> tuple[int, float]:
    """Floor-decompose a grid shift into (integer pixel roll, fractional
    tent remainder in [0, 1)), absorbing float fuzz at the boundary."""
    i = math.floor(v)
    f = v - i
    if f > 1.0 - 1e-9:
        i += 1
        f = 0.0
    return int(i), float(f)


def _frac_groups(cfg):
    """Group the x-major shift grid by fractional remainder.

    Returns (groups, decomp): ``groups`` maps a rounded (fy, fx) key to a
    representative exact (fy, fx); ``decomp`` lists, in the flat-table
    x-major shift order (config.shifts), each shift's
    (iy, ix, group key).  Integer grids produce the single group (0, 0).
    """
    groups: dict = {}
    decomp = []
    for dx in cfg.shift_x_vals:
        for dy in cfg.shift_y_vals:
            iy, fy = _split_shift(float(dy))
            ix, fx = _split_shift(float(dx))
            key = (round(fy, 6), round(fx, 6))
            groups.setdefault(key, (fy, fx))
            decomp.append((iy, ix, key))
    return groups, decomp


def template_geometry(cfg):
    """(window_start, window_width, pad) of the central square window
    that covers every ring sample under every grid shift plus the
    bilinear tent: radius max_radius + max_shift + 1.

    max_shift is the largest ACTUAL grid value, not ``shift_rng`` —
    step rounding in the inclusive grid can overshoot the range (e.g.
    step 0.75, rng 1.9 produces ±2.25), and a pad sized from the range
    would put slice origins outside the padded block, which
    ``lax.slice`` silently clamps to a wrong-shift template."""
    mx = float(max(np.abs(cfg.shift_x_vals).max(initial=0.0),
                   np.abs(cfg.shift_y_vals).max(initial=0.0)))
    rad = int(np.ceil(cfg.max_radius + mx + 1))
    c = cfg.img_dim // 2
    pad = int(np.ceil(mx))
    return c - rad, 2 * rad + 1, pad


def _template_matrix_bytes(cfg, n_classes: int) -> int:
    """Bytes of the fully materialized (C, Wpx) bf16 template matrix."""
    _, width, _ = template_geometry(cfg)
    n_mirror = 2 if cfg.mirror else 1
    return (n_mirror * cfg.n_shifts * n_classes * cfg.ring_len
            * width * width * 2)


def _template_blocks_bytes(cfg, n_classes: int) -> int:
    """Bytes of the padded (Fg, M, K, L, wp, wp) bf16 block stack."""
    groups, _ = _frac_groups(cfg)
    _, width, pad = template_geometry(cfg)
    n_mirror = 2 if cfg.mirror else 1
    return (len(groups) * n_mirror * n_classes * cfg.ring_len
            * (width + 2 * pad) ** 2 * 2)


def _splat_spectra_bytes(cfg) -> int:
    """Bytes of the (complex64) splat spectra across fractional groups —
    the persistent device residency of the step-level hoist (4.4 GB at
    256 px/ou=100; the batch planner must charge it)."""
    groups, _ = _frac_groups(cfg)
    _, width, _ = template_geometry(cfg)
    wpx = width * width
    if cfg.ring_scheme == "eman2":
        from .eman_search import eman_groups

        per = sum(len(idx) * (ln // 2 + 1)
                  for ln, idx, _c in eman_groups(cfg))
    else:
        per = cfg.ring_num * (cfg.ring_len // 2 + 1)
    return len(groups) * per * wpx * 8


def template_supported(cfg, n_classes: int) -> bool:
    """Geometry gate for the template engine.

    Requires the sampling window inside the image, the padded template
    blocks within the HBM budget (the search streams column chunks from
    the blocks when the full matrix would not fit — ``template_search``
    picks per config), and — for fractional shift grids — at most
    ``MAX_FRAC_GROUPS`` unique fractional remainders (each one is a
    separate per-iteration splat-spectra build).  Any
    ``img_dim``/``ring_len``/K is fine otherwise — including
    ``ring_scheme="eman2"``: variable Numrinit rings only change
    the template build (per-group splat spectra accumulated into the
    maxrin angle spectrum, Crosrng_ms algebra); the search matmul and
    decode are scheme-agnostic.
    """
    groups, _ = _frac_groups(cfg)
    if len(groups) > MAX_FRAC_GROUPS:
        return False
    lo, width, _ = template_geometry(cfg)
    if lo < 0 or lo + width > cfg.img_dim:
        return False
    return _template_blocks_bytes(cfg, n_classes) \
        <= TEMPLATE_MATRIX_BUDGET_BYTES


def _base_tents(cfg, lo, width, frac=(0.0, 0.0)):
    """Window tent matrices (Q, width) x2 at a fractional shift offset —
    numpy constants.  ``frac=(fy, fx)`` shifts every ring sample point by
    the sub-pixel remainder; the integer part of a grid shift is applied
    later as a pad+slice pixel roll of the finished template."""
    coords = cfg.polar_coords
    c = cfg.img_dim // 2
    wy = tent_rows(c - lo + coords[..., 1].reshape(-1) + frac[0], width)
    wx = tent_rows(c - lo + coords[..., 0].reshape(-1) + frac[1], width)
    return wy, wx


def splat_spectra(cfg, frac=(0.0, 0.0)):
    """rfft-over-t spectra of the splat tensor.

    "cuda" scheme: one (R, F, Wpx) complex64 array.  "eman2" scheme: a
    tuple with one (R_g, F_g, Wpx) array per ring-length group
    (``eman_search.eman_groups`` order) — each group's splat transforms
    over its OWN ring length L_g, so its harmonics land on the low bins
    of the shared maxrin angle spectrum exactly like the
    ``Util.Crosrng_ms`` accumulation in ``ops/eman_search.py``.

    Jittable; depends only on (cfg, frac).  Computed inside the step (the
    materialized array is ~250 MB for the 90 px config — too large to
    bake into the program as a constant, cheap to rebuild on device).
    """
    lo, width, _ = template_geometry(cfg)
    if cfg.ring_scheme == "eman2":
        from .eman_search import eman_groups

        c = cfg.img_dim // 2
        out = []
        for ln, _idx, coords in eman_groups(cfg):
            wy = tent_rows(c - lo + coords[..., 1].reshape(-1) + frac[0],
                           width)
            wx = tent_rows(c - lo + coords[..., 0].reshape(-1) + frac[1],
                           width)
            splat = jnp.einsum("qh,qw->qhw", jnp.asarray(wy),
                               jnp.asarray(wx), precision=_HP)
            splat = splat.reshape(-1, ln, width * width)
            sf = rfft_mm(splat.transpose(0, 2, 1))    # (R_g, Wpx, F_g)
            out.append(sf.transpose(0, 2, 1))         # (R_g, F_g, Wpx)
        return tuple(out)
    wy, wx = _base_tents(cfg, lo, width, frac)
    splat = jnp.einsum("qh,qw->qhw", jnp.asarray(wy), jnp.asarray(wx),
                       precision=_HP)
    splat = splat.reshape(cfg.ring_num, cfg.ring_len, width * width)
    sf = rfft_mm(splat.transpose(0, 2, 1))        # (R, Wpx, F)
    return sf.transpose(0, 2, 1)                  # (R, F, Wpx)


def splat_spectra_groups(cfg):
    """Per-frac-group splat spectra, in ``_frac_groups`` order — the
    hoistable cfg-only invariant for loops over fractional grids (a
    1-tuple for integer grids).  Pass the result as ``sf=`` to
    ``template_search``/``build_template_blocks``."""
    groups, _ = _frac_groups(cfg)
    return tuple(splat_spectra(cfg, frac=f) for f in groups.values())


def _ref_k(ref_fw) -> int:
    """K from either spectra form: (K, R, F) array (cuda scheme) or the
    per-ring-group tuple from ``prepare_ref_spectra_eman``."""
    if isinstance(ref_fw, (tuple, list)):
        return int(ref_fw[0].shape[0])
    return int(ref_fw.shape[0])


def _angle_spectra(ref_fw, cfg, sf_g):
    """Per-pixel angle spectra of the orig/mirror templates for one
    fractional group: ``(g, h)``, each (K, Wpx, F_max) complex64
    (``h`` is None without mirror).

    cuda scheme: one contraction against the (R, F, Wpx) splat spectra.
    eman2 scheme: ``ref_fw``/``sf_g`` are per-ring-group tuples; each
    group's harmonics (f < L_g/2+1) accumulate into the low bins of the
    shared maxrin spectrum — the pixel-domain image of the
    ``Util.Crosrng_ms`` accumulation in ``ops/eman_search.py`` (the
    ringwe weights and short-ring Nyquist pre-halving ride in via
    ``prepare_ref_spectra_eman``)."""
    if cfg.ring_scheme == "eman2":
        assert len(ref_fw) == len(sf_g), \
            (len(ref_fw), len(sf_g), "spectra/splat group count mismatch "
             "— sf built for a different ring plan?")
        n_f = cfg.ring_len // 2 + 1
        k_num = _ref_k(ref_fw)
        wpx = sf_g[0].shape[-1]
        g = jnp.zeros((k_num, wpx, n_f), jnp.complex64)
        h = jnp.zeros((k_num, wpx, n_f), jnp.complex64) \
            if cfg.mirror else None
        for spec, sfg in zip(ref_fw, sf_g):
            f_g = sfg.shape[1]
            g = g.at[..., :f_g].add(
                jnp.einsum("krf,rfp->kpf", spec, jnp.conj(sfg),
                           precision=_HP))
            if cfg.mirror:
                h = h.at[..., :f_g].add(
                    jnp.einsum("krf,rfp->kpf", spec, sfg, precision=_HP))
        return g, h
    g = jnp.einsum("krf,rfp->kpf", ref_fw, jnp.conj(sf_g), precision=_HP)
    h = (jnp.einsum("krf,rfp->kpf", ref_fw, sf_g, precision=_HP)
         if cfg.mirror else None)
    return g, h


def _normalize_sf(sf, order_len: int, cfg):
    """Resolve a user-passed ``sf`` into the per-frac-group tuple (or
    None to rebuild).  An eman2 entry is itself a tuple of per-ring-group
    arrays, so eman2 detection keys on the ELEMENT type."""
    if sf is None:
        return None
    if cfg.ring_scheme == "eman2":
        if (isinstance(sf, (tuple, list)) and len(sf) > 0
                and isinstance(sf[0], (tuple, list))):
            return tuple(sf) if len(sf) == order_len else None
        # a bare per-ring-group tuple == one fractional group's spectra
        return (tuple(sf),) if order_len == 1 else None
    if isinstance(sf, (tuple, list)):
        return tuple(sf) if len(sf) == order_len else None
    return (sf,) if order_len == 1 else None


def build_template_blocks(ref_fw, cfg, sf=None):
    """Weighted ring spectra -> padded per-frac template blocks.

    ``ref_fw``: (K, R, F) from ``prepare_ref_spectra`` (cuda scheme) or
    the per-ring-group tuple from ``prepare_ref_spectra_eman`` (eman2).

    Returns ``(tbps, fids, oys, oxs)``: ``tbps`` is the
    (Fg, M, K, L, wp, wp) bf16 stack of padded template blocks (one per
    fractional-remainder group; Fg=1 for integer grids), and the (S,)
    int32 lookup tables give, per x-major grid shift, its block id and
    the (y, x) slice origins that realize the shift's integer pixel
    roll.  Jittable; rebuilt every iteration (refs change).
    """
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    n_chan = 2 if cfg.mirror else 1
    lo, width, pad = template_geometry(cfg)
    groups, decomp = _frac_groups(cfg)
    # one padded template block per fractional group (integer grids: one)
    order = list(groups)
    # sf: a single spectra value (single-group grids) or the
    # splat_spectra_groups tuple (one entry per group, same order)
    sfs = _normalize_sf(sf, len(order), cfg)
    blocks = []
    for idx, key in enumerate(order):
        frac = groups[key]
        sf_g = sfs[idx] if sfs is not None else \
            splat_spectra(cfg, frac=frac)
        g, h = _angle_spectra(ref_fw, cfg, sf_g)
        # HIGH (3-pass bf16, ~f32-accurate) halves the irfft's HIGHEST
        # cost — the dominant build stage.  One bf16 pass is too noisy:
        # its ~0.4% template error flips near-tie angle winners on random
        # stacks (test_template_accumulated_fractional_shifts)
        _HI = jax.lax.Precision.HIGH
        tbo = irfft_mm(g, n=ring_len, precision=_HI)  # (K, Wpx, L)
        chans = [tbo]
        if cfg.mirror:
            tbm = irfft_mm(h, n=ring_len, precision=_HI)
            # angle index reversal (-l % L) = flip + roll (no gather)
            chans.append(jnp.roll(jnp.flip(tbm, axis=-1), 1, axis=-1))
        tb = jnp.stack(chans).transpose(0, 1, 3, 2)   # (M, K, L, Wpx)
        tb = tb.reshape(n_chan, k_num, ring_len, width, width)
        tb = tb.astype(jnp.bfloat16)
        blocks.append(jnp.pad(tb, ((0, 0), (0, 0), (0, 0), (pad, pad),
                                   (pad, pad))))
    tbps = jnp.stack(blocks)                      # (Fg, M, K, L, wp, wp)
    gid = {key: i for i, key in enumerate(order)}
    fids = np.asarray([gid[key] for _, _, key in decomp], np.int32)
    oys = np.asarray([pad - iy for iy, _, _ in decomp], np.int32)
    oxs = np.asarray([pad - ix for _, ix, _ in decomp], np.int32)
    # every slice origin must land inside the padded block — lax.slice
    # would silently clamp an out-of-range origin to a wrong template
    assert oys.min() >= 0 and oys.max() <= 2 * pad, (oys, pad)
    assert oxs.min() >= 0 and oxs.max() <= 2 * pad, (oxs, pad)
    return tbps, fids, oys, oxs


def build_template_matrix(ref_fw, cfg, sf=None):
    """Weighted ring spectra (K, R, F) -> (C, Wpx) bf16 template matrix.

    Column order [mirror][shift][ref][angle] — the reference table's
    flat priority order (cuda/gpu_aln_noref.cu:2172-2178).  Jittable;
    rebuilt every iteration (refs change).
    """
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    n_chan = 2 if cfg.mirror else 1
    _, width, _ = template_geometry(cfg)
    tbps, fids, oys, oxs = build_template_blocks(ref_fw, cfg, sf=sf)
    slabs = []
    # x-major shift order: sidx = xi * n_dy + yi (config.shifts); the
    # integer part of each shift is a pixel roll of its group's block
    for s in range(len(fids)):
        slabs.append(jax.lax.slice(
            tbps[fids[s]], (0, 0, 0, int(oys[s]), int(oxs[s])),
            (n_chan, k_num, ring_len, int(oys[s]) + width,
             int(oxs[s]) + width)))
    tm = jnp.stack(slabs, axis=1)                 # (M, S, K, L, w, w)
    return tm.reshape(n_chan * len(slabs) * k_num * ring_len,
                      width * width)


# columns per streamed chunk: the fastest of the sizes chip_smoke.py's
# phase 2 times (90 px, K=8, H100: 4096 columns 65.5k particles/s,
# 2048 50.3k, 1024 48.2k)
COL_CHUNK_TARGET = 4096


def _col_chunk(c_total: int, ring_len: int, target: int | None = None) -> int:
    """Largest divisor of c_total that is a multiple of ring_len and
    <= target (default ``COL_CHUNK_TARGET``)."""
    if target is None:
        target = COL_CHUNK_TARGET
    groups = c_total // ring_len
    best = ring_len
    for g in range(1, groups + 1):
        if groups % g == 0 and g * ring_len <= target:
            best = g * ring_len
    return best


def _online_argmax(img_win, cols_fn, c_total: int, chunk: int,
                   ring_len: int, angle_mask=None):
    """(N, Wpx) x columns streamed by ``cols_fn(i) -> (chunk, Wpx)`` ->
    per-particle (best_val, flat col index, winning (L,) angle row).

    Chunks are multiples of ring_len (``_col_chunk``), so the winning
    candidate's whole angle row lives in the chunk that produced it and
    is captured with a one-hot contraction — no separate row-recompute
    pass.  Ascending chunk order + strict '>' keeps the first-seen
    maximum — the flat table argmax priority.

    ``angle_mask`` is an optional (L,) additive f32 mask (the --dst
    discrete-angle search, ops/search.delta_angle_mask): every chunk is
    a whole number of angle rows, so the mask tiles across the chunk's
    column axis before the max/argmax (same fold as the XLA paths)."""
    n = img_win.shape[0]
    n_chunks = c_total // chunk
    n_groups = chunk // ring_len
    if angle_mask is not None:
        mask_tiled = jnp.tile(jnp.asarray(angle_mask, jnp.float32),
                              n_groups)[None, :]          # (1, chunk)

    def body(i, carry):
        best_val, best_idx, best_row = carry
        cols = cols_fn(i)
        # bf16 x bf16 -> f32: the tensor-core product
        scores = jnp.dot(img_win, cols.T,
                         preferred_element_type=jnp.float32)
        if angle_mask is not None:
            scores = scores + mask_tiled
        v = jnp.max(scores, axis=1)
        a = jnp.argmax(scores, axis=1).astype(jnp.int32)
        grp = a // ring_len                       # (N,) winning group
        onehot = (jnp.arange(n_groups, dtype=jnp.int32)[None, :]
                  == grp[:, None]).astype(scores.dtype)
        row = jnp.einsum("ngl,ng->nl",
                         scores.reshape(n, n_groups, ring_len), onehot,
                         precision=_HP)
        take = v > best_val
        return (jnp.where(take, v, best_val),
                jnp.where(take, a + i * chunk, best_idx),
                jnp.where(take[:, None], row, best_row))

    init = (jnp.full((n,), _NEG_INF, jnp.float32),
            jnp.zeros((n,), jnp.int32),
            jnp.zeros((n, ring_len), jnp.float32))
    if n_chunks == 1:
        return body(0, init)
    return jax.lax.fori_loop(0, n_chunks, body, init)


def _argmax_chunked(img_win, tm, ring_len: int, angle_mask=None):
    """Online argmax over a materialized (C, Wpx) template matrix."""
    c_total = tm.shape[0]
    chunk = _col_chunk(c_total, ring_len)

    def cols_fn(i):
        return jax.lax.dynamic_slice(tm, (i * chunk, 0),
                                     (chunk, tm.shape[1]))

    return _online_argmax(img_win, cols_fn, c_total, chunk, ring_len,
                          angle_mask=angle_mask)


def _stream_cols_fn(tbps, fids, oys, oxs, cfg, k_num: int, chunk: int):
    """Build the streamed-column chunk reader over the padded template
    blocks.  Each chunk group's (m, s, k) decomposes from its flat
    index; the shift's integer roll becomes a traced dynamic_slice
    origin from the per-shift lookup tables.  The sliced columns are
    bit-identical to the materialized matrix (both are the same slices
    of the same blocks)."""
    ring_len = cfg.ring_len
    s_num = cfg.n_shifts
    _, width, _ = template_geometry(cfg)
    n_groups = chunk // ring_len
    fids_d = jnp.asarray(fids)
    oys_d = jnp.asarray(oys)
    oxs_d = jnp.asarray(oxs)

    def cols_fn(i):
        parts = []
        for j in range(n_groups):
            g = i * n_groups + j                  # flat (m, s, k) group
            m = g // (s_num * k_num)
            rem = g % (s_num * k_num)
            s = rem // k_num
            k = rem % k_num
            blk = jax.lax.dynamic_slice(
                tbps, (jnp.take(fids_d, s), m, k, 0,
                       jnp.take(oys_d, s), jnp.take(oxs_d, s)),
                (1, 1, 1, ring_len, width, width))
            parts.append(blk.reshape(ring_len, width * width))
        return jnp.concatenate(parts, axis=0)

    return cols_fn


def _online_shc(img_win, cols_fn, c_total: int, chunk: int, ring_len: int,
                previousmax):
    """SHC pick over streamed template columns.

    The template column order [mirror][shift][ref][angle] IS the
    reference priority order, so each chunk group's flat index
    ``i * n_groups + g`` equals the global candidate priority
    ``(m * S + s) * K + k`` — the SHC rule (first candidate whose
    angle-peak beats ``previousmax``) is a running argmin over passing
    group indices.  Returns (best_prio, best_val, winning row)."""
    n = img_win.shape[0]
    n_chunks = c_total // chunk
    n_groups = chunk // ring_len
    big = jnp.int32(2**31 - 1)

    def body(i, carry):
        best_prio, best_val, best_row = carry
        cols = cols_fn(i)
        # bf16 x bf16 -> f32: the tensor-core product
        scores = jnp.dot(img_win, cols.T,
                         preferred_element_type=jnp.float32)
        sg = scores.reshape(n, n_groups, ring_len)
        gmax = jnp.max(sg, axis=-1)                   # (N, G)
        passing = gmax > previousmax[:, None]
        gprio = (jnp.arange(n_groups, dtype=jnp.int32)[None, :]
                 + i * n_groups)
        pm = jnp.where(passing, gprio, big)
        gidx = jnp.argmin(pm, axis=1)
        minp = jnp.take_along_axis(pm, gidx[:, None], axis=1)[:, 0]
        val = jnp.take_along_axis(gmax, gidx[:, None], axis=1)[:, 0]
        onehot = (jnp.arange(n_groups, dtype=jnp.int32)[None, :]
                  == gidx[:, None]).astype(sg.dtype)
        row = jnp.einsum("ngl,ng->nl", sg, onehot, precision=_HP)
        take = minp < best_prio
        return (jnp.where(take, minp, best_prio),
                jnp.where(take, val, best_val),
                jnp.where(take[:, None], row, best_row))

    init = (jnp.full((n,), big, jnp.int32),
            jnp.full((n,), _NEG_INF, jnp.float32),
            jnp.zeros((n, ring_len), jnp.float32))
    if n_chunks == 1:
        return body(0, init)
    return jax.lax.fori_loop(0, n_chunks, body, init)


def _search_operands(images, ref_fw, params, cfg, sf, stream):
    """Shared preamble of the full and SHC template searches: the bf16
    image window (accumulated shifts fused into the extraction by
    ``translate_window_mm``) plus the column reader — streamed block
    slices by default, or a materialized (C, Wpx) matrix with
    ``stream=False``.  Returns ``(win, cols_fn, c_total, chunk)``.

    Streaming is the default: the materialized path writes and re-reads
    the full matrix (2.6 GB at 90 px/K=8), where streaming's dynamic
    block slices ride the same memory read the search matmul needs
    anyway.  Both paths are bit-identical (same slices of the same
    blocks)."""
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    lo, width, _ = template_geometry(cfg)
    if stream is None:
        stream = True

    win = translate_window_mm(images, params.shift_x, params.shift_y,
                              lo, width)
    win = win.reshape(images.shape[0], -1).astype(jnp.bfloat16)
    n_chan = 2 if cfg.mirror else 1
    c_total = n_chan * cfg.n_shifts * k_num * ring_len
    chunk = _col_chunk(c_total, ring_len)
    if stream:
        tbps, fids, oys, oxs = build_template_blocks(ref_fw, cfg, sf=sf)
        cols_fn = _stream_cols_fn(tbps, fids, oys, oxs, cfg, k_num, chunk)
    else:
        tm = build_template_matrix(ref_fw, cfg, sf=sf)

        def cols_fn(i):
            return jax.lax.dynamic_slice(tm, (i * chunk, 0),
                                         (chunk, tm.shape[1]))

    return win, cols_fn, c_total, chunk


def template_search_shc(images, ref_fw, params, cfg, previousmax, sf=None,
                        stream: bool | None = None):
    """SHC (stochastic hill climbing) via the template matmul — the same
    pick as ``ops.search.rotational_shift_search_shc`` on the template
    engine (``random_method="SHC"`` semantics,
    test_reffree_gpu_align.py:519-524,724).

    Returns ``(SearchResult, found)``; non-improving particles carry
    zero-filled fields and must keep their previous params."""
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    s_num = cfg.n_shifts
    win, cols_fn, c_total, chunk = _search_operands(images, ref_fw, params,
                                                    cfg, sf, stream)
    prio, val, row = _online_shc(win, cols_fn, c_total, chunk, ring_len,
                                 previousmax)
    found = prio < jnp.int32(2**31 - 1)
    safe = jnp.where(found, prio, 0)
    ridx = (safe % k_num).astype(jnp.int32)
    rest = safe // k_num
    sidx = (rest % s_num).astype(jnp.int32)
    midx = (rest // s_num).astype(jnp.int32)
    aidx = jnp.argmax(row, axis=-1).astype(jnp.int32)
    return SearchResult(best_val=val, best_row=row, best_aidx=aidx,
                        best_sidx=sidx, best_ref=ridx,
                        best_mirror=midx), found


def template_search(images, ref_fw, params, cfg, sf=None,
                    stream: bool | None = None,
                    angle_mask=None) -> SearchResult:
    """Full (mirror x shift x ref x angle) search via the template
    matmul.  Drop-in replacement for ``rotational_shift_search_mm``
    (same SearchResult contract, same priority order).

    ``stream=None`` materializes the (C, Wpx) template matrix when it
    fits the HBM budget and streams column chunks straight from the
    padded template blocks otherwise (large K) — both produce
    bit-identical scores.  ``angle_mask`` restricts the angle argmax to
    discrete bins (the --dst search; decode with ``refine=False``)."""
    ring_len = cfg.ring_len
    k_num = _ref_k(ref_fw)
    s_num = cfg.n_shifts
    win, cols_fn, c_total, chunk = _search_operands(images, ref_fw, params,
                                                    cfg, sf, stream)
    best_val, idx, row = _online_argmax(win, cols_fn, c_total, chunk,
                                        ring_len, angle_mask=angle_mask)

    aidx = (idx % ring_len).astype(jnp.int32)
    rest = idx // ring_len
    ridx = (rest % k_num).astype(jnp.int32)
    rest = rest // k_num
    sidx = (rest % s_num).astype(jnp.int32)
    midx = (rest // s_num).astype(jnp.int32)
    return SearchResult(best_val=best_val, best_row=row, best_aidx=aidx,
                        best_sidx=sidx, best_ref=ridx, best_mirror=midx)
