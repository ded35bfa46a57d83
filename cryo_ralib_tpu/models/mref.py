"""Multireference 2D alignment driver.

Rewrite of ``mref_ali2d_gpu`` (test_mref_gpu_align.py:222-612) — the
reference's primary workload: K references, every particle aligned against
all of them with mirror + shift-grid search, class assignment by the ccf
argmax, even/odd class sums, vanished-class reseeding, per-class FSC
averaged across classes, ``ref_ali2d`` filtering, per-iteration
``aqm%03d.hdf`` class averages and ``drm%03d%04d.txt`` FSC files, final
header-convention parameter decode.

Design notes vs the reference:
* no ctypes/batch-size search/unified-memory plumbing — the fused jitted
  step with a sharded particle axis covers the whole GPU+MPI stack;
* assignments never leave the device except as the final (N,) int array;
* ``rand_seed`` drives the vanished-class reseeding RNG exactly like
  ``seed(rand_seed)`` + ``randint`` (test_mref_gpu_align.py:358,524).
"""

from __future__ import annotations

import os
import random as _random
from dataclasses import dataclass, field
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..params import params_table
from ..ops.fsc import fsc, write_fsc
from ..ops.masks import model_circle, normalize_mask
from ..io.eman_hdf import write_image
from ..io.star import write_text_row
from ..utils.log import RunLogger
from ..utils.profiling import annotate
from .checkpoint import load_checkpoint, save_checkpoint
from .engine import AlignmentEngine
from .user_functions import factory


@dataclass
class MrefResult:
    params: np.ndarray            # (N, 4) header convention [alpha, sx, sy, mirror]
    assignments: np.ndarray       # (N,) class ids
    references: np.ndarray        # (K, H, W) final references
    class_counts: np.ndarray      # (K,) final member counts
    members: list = field(default_factory=list)  # per-class particle id lists
    iterations: int = 0


def mref_ali2d_tpu(
    images: np.ndarray,
    refs: np.ndarray,
    outdir: str | None = None,
    maskfile: np.ndarray | None = None,
    ir: int = 1,
    ou: int = -1,
    rs: int = 1,
    xr: float = 0.0,
    yr: float = 0.0,
    ts: float = 1.0,
    center: int = -1,
    maxit: int = 0,
    CTF: bool = False,
    snr: float = 1.0,
    ctf_params: dict | None = None,
    user_func_name: str = "ref_ali2d",
    rand_seed: int = 1000,
    log: RunLogger | None = None,
    mesh=None,
    shift_chunk: int = 8,
    sampler: str = "auto",
    batch_size: int | None = None,
    resume: bool = False,
    ring_scheme: str = "cuda",
) -> MrefResult:
    """Multireference-align ``images`` against ``refs``.

    Flags mirror the reference CLI (test_mref_gpu_align.py:1142-1159).
    Note the reference GPU config uses ``xr`` for both shift axes even when
    ``--yr`` is given (test_mref_gpu_align.py:365-369); we honor ``yr``
    when it differs, falling back to the reference behavior for yr<0.

    ``CTF=True`` (capability beyond the reference, which force-disables
    the flag — test_mref_gpu_align.py:308): particles are premultiplied
    by their CTFs and references Wiener-restored with ``snr``
    (ops/ctf_ops.py).  Requires ``ctf_params`` with at least ``dfu``
    (per-particle defocus, A); see ``ops.ctf_ops.CtfContext``.
    """
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    log = log or RunLogger(outdir)
    user_func = factory[user_func_name]

    n, ny, nx = images.shape
    assert nx == ny, "images are assumed square"
    numref = refs.shape[0]
    last_ring = int(ou) if int(ou) != -1 else nx // 2 - 2
    max_iter = int(maxit) if int(maxit) else 10
    if yr is None or yr < 0:
        yr = xr

    # --ir/--rs build the ring template like the CPU twin's
    # ``Numrinit(first_ring, last_ring, rstep)`` radius plan
    # (test_mref_gpu_align.py:338; the reference GPU config ignores both)
    ir, rs = int(ir), int(rs)
    if ir < 1 or rs < 1 or ir > last_ring:
        raise ValueError(f"invalid ring plan: ir={ir} rs={rs} ou={last_ring}")
    if int(center) > 1:
        # fail at startup, not at the first reference update
        # (ops/center.py documents the honor-or-reject policy)
        raise ValueError(f"--center={int(center)} is not supported "
                         "(reference-documented values: 0, 1; -1 for the "
                         "reffree average centering)")
    n_rings = len(range(ir, last_ring + 1, rs))
    # ring_scheme="eman2": the CPU twin's variable Numrinit rings +
    # ringwe weights instead of the GPU uniform-256 scheme (opt-in,
    # ring_len is derived = maxrin there)
    cfg = AlignConfig(img_dim=nx, ring_num=n_rings, ring_len=256,
                      first_ring=ir, ring_step=rs, ring_scheme=ring_scheme,
                      shift_step=float(ts), shift_rng_x=float(xr),
                      shift_rng_y=float(yr))

    mask = maskfile if maskfile is not None else model_circle(last_ring, nx)
    mask_j = jnp.asarray(mask)

    ctf_ctx = None
    if CTF:
        if ctf_params is None:
            raise ValueError("CTF=True requires ctf_params (at least "
                             "per-particle 'dfu' defocus in A)")
        from ..ops.ctf_ops import CtfContext

        ctf_ctx = CtfContext(nx, ctf_params, snr=snr)
        images = ctf_ctx.premultiply(images)
        log.add("CTF premultiplication on, snr=%g" % snr)

    # preprocessing — note the EMAN2 normalize.mask semantics (the
    # reference's inline comments have them swapped): refs get no_sigma=1
    # (mean-subtract only), particles no_sigma=0 (scaled to N(0,1) under
    # the mask); test_mref_gpu_align.py:336,342.
    # (jitted: one device program each instead of op-by-op dispatch)
    _prep = jax.jit(partial(normalize_mask, no_sigma=False))
    _prep_ref = jax.jit(partial(normalize_mask, no_sigma=True))
    refi = np.asarray(_prep_ref(jnp.asarray(refs), mask_j), np.float32)
    data = np.asarray(_prep(jnp.asarray(images), mask_j), np.float32)

    rng = _random.Random(rand_seed)

    engine = AlignmentEngine(data, cfg, n_classes=numref, mesh=mesh,
                             sampler=sampler, update_ref=True,
                             batch_size=batch_size, shift_chunk=shift_chunk)
    if not engine.resident:
        log.add("streaming %d particles in batches of %d"
                % (n, engine.batch))

    counts = np.zeros(numref, np.int64)
    assign: np.ndarray = np.zeros(n, np.int64)
    members: list = [[] for _ in range(numref)]

    start_it = 0
    if resume and outdir:
        ck = load_checkpoint(outdir, rng)
        if ck is not None:
            start_it, ck_params, refi, _extra = ck
            start_it += 1
            engine.set_params(ck_params)
            log.add("resumed from checkpoint at iteration %d" % start_it)

    for it in range(start_it, max_iter):
        # named phase scopes for jax.profiler traces (NVTX parity with
        # the reference drivers, test_mref_gpu_align.py:89,329-590)
        with annotate("mref::align_iter"):
            out = engine.iterate(refi)
        sums = out.class_sums                  # (K, 2, H, W)
        counts = out.counts
        assign = engine.params_np().ref_id[:n].astype(np.int64)
        members = [list(np.nonzero(assign == j)[0]) for j in range(numref)]

        # ---- reference update (rank-0 logic in the original,
        #      test_mref_gpu_align.py:517-564)
        ave_fsc = None
        c_fsc = 0
        frsc = None
        new_refs = np.empty_like(refi)
        vanished = []
        if ctf_ctx is not None:
            # Wiener-restored combined averages (spectrum / (sum ctf^2 +
            # 1/snr)) replace the plain count-normalized sums; FSC below
            # still uses the raw even/odd halves.
            wiener = ctf_ctx.restore(np.asarray(sums[:, 0] + sums[:, 1]),
                                     assign)
        for j in range(numref):
            if counts[j] < 4:
                # vanished class: reseed with a random particle
                pick = rng.randint(0, n - 1)
                members[j] = [pick]
                new_refs[j] = data[pick]
                vanished.append(j)
            else:
                cur = fsc(sums[j, 0], sums[j, 1], 1.0)
                if outdir:
                    write_fsc(os.path.join(outdir, "drm%03d%04d.txt" % (it, j)),
                              *cur)
                new_refs[j] = (wiener[j] if ctf_ctx is not None
                               else (sums[j, 0] + sums[j, 1]) / float(counts[j]))
                if ave_fsc is None:
                    ave_fsc = np.array(cur[1], np.float64)
                    c_fsc = 1
                else:
                    ave_fsc += np.asarray(cur[1])
                    c_fsc += 1
                frsc = cur
        if ave_fsc is not None and ave_fsc.sum() != 0:
            ave_fsc /= float(c_fsc)
            frsc = (frsc[0], ave_fsc, frsc[2])

        refim = os.path.join(outdir, "aqm%03d.hdf" % it) if outdir else None
        # (H, W)-sized reference conditioning runs on the CPU backend:
        # a few small eager ops, not worth a device dispatch each
        with annotate("mref::ref_update"), \
                jax.default_device(jax.devices("cpu")[0]):
            for j in range(numref):
                if frsc is not None:
                    filtered, _cs = user_func([mask, center, new_refs[j],
                                               frsc])
                else:
                    filtered = new_refs[j]
                new_refs[j] = np.asarray(normalize_mask(
                    jnp.asarray(filtered), jnp.asarray(np.asarray(mask)),
                    no_sigma=True), np.float32)
        for j in range(numref):
            if refim:
                write_image(refim, new_refs[j], j, header={
                    "ave_n": int(counts[j]),
                    "members": sorted(float(m) for m in members[j]),
                })
        refi = new_refs

        if outdir:
            save_checkpoint(outdir, it, engine.params_np(), refi, rng=rng)
        log.add("ITERATION #%3d" % (it + 1))
        for j in range(numref):
            log.add("   group #%3d   number of particles = %7d"
                    % (j, int(counts[j])))
        if vanished:
            log.add("   reseeded vanished classes: %s" % vanished)

    # ---- final params in header convention (the "usually done in ormq()"
    # decode, test_mref_gpu_align.py:578-588)
    table = params_table(engine.params_np())
    if outdir:
        write_text_row(table, os.path.join(outdir, "final2Dparams.txt"))
    log.add("Finished mref_ali2d")
    return MrefResult(params=table, assignments=assign, references=refi,
                      class_counts=counts, members=members,
                      iterations=max_iter)
