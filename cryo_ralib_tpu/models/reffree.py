"""Reference-free 2D alignment driver (``ali2d`` / ISAC pre-alignment).

Rewrite of ``ali2d_base_gpu_isac_CLEAN``
(test_reffree_gpu_align.py:153-577): iteratively aligns every particle to
the running global average with the full rotation/shift/mirror search,
with FSC-driven tangent filtering, average centering, the ``a1`` dot
criterion, per-iteration QC (pixel error / mirror consistency) and the
same output artifacts (``aqc.hdf``, ``aqf.hdf``, ``aqfinal.hdf``,
``resolution%03d``, ``initial2Dparams.txt``).

Differences from the reference, by design:
* one jitted device step replaces the GPU-batch loop + MPI reduces; the
  mesh's data-parallel all-reduce *is* ``reduce_EMData_to_root``;
* the auto-stop criterion actually breaks the loop (the reference's CLEAN
  GPU variant computes ``again`` but never acts on it — we follow the CPU
  ``ali2d_base`` intent);
* host work per iteration is only the (H, W)-sized average conditioning.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..params import params_table, pixel_error_2D
from ..ops.filters import fshift
from ..ops.fsc import fsc_mask, write_fsc
from ..ops.masks import infomask, model_circle
from ..io.eman_hdf import write_image
from ..io.star import write_text_row
from ..utils.log import RunLogger
from ..utils.profiling import annotate
from .checkpoint import load_checkpoint, save_checkpoint
from .engine import AlignmentEngine
from .user_functions import factory


@dataclass
class RefFreeResult:
    params: np.ndarray          # (N, 4) [alpha, sx, sy, mirror] header convention
    average: np.ndarray         # final filtered average
    criteria: list = field(default_factory=list)
    pixel_errors: list = field(default_factory=list)
    mirror_consistency: list = field(default_factory=list)
    radial_variances: list = field(default_factory=list)  # Fourvar rvar/iter
    iterations: int = 0


def ali2d_base_tpu(
    images: np.ndarray,
    outdir: str | None = None,
    maskfile: np.ndarray | None = None,
    ir: int = 1,
    ou: int = -1,
    rs: int = 1,
    xr: float = 4.0,
    yr: float = -1.0,
    ts: float = 2.0,
    dst: float = 0.0,
    center: int = -1,
    maxit: int = 0,
    CTF: bool = False,
    Fourvar: bool = False,
    snr: float = 1.0,
    ctf_params: dict | None = None,
    user_func_name: str = "ref_ali2d",
    random_method: str = "",
    nomirror: bool = False,
    mode: str = "F",
    log: RunLogger | None = None,
    mesh=None,
    shift_chunk: int = 8,
    sampler: str = "auto",
    batch_size: int | None = None,
    resume: bool = False,
    ring_scheme: str = "cuda",
) -> RefFreeResult:
    """Align a particle stack to its iteratively refined global average.

    Args mirror the reference CLI flags (test_reffree_gpu_align.py:915-935);
    ``yr < 0`` means "use xr".  Unlike the reference GPU config — which
    passes ``xrng[0]`` for both axes regardless of --yr
    (test_reffree_gpu_align.py:318) — an explicit ``yr`` is honored here,
    matching the mref driver and the CLI's advertised surface.
    ``nomirror`` disables the mirrored-orientation
    channel; ``mode="H"`` searches half rings (rotations in [0, 180));
    ``random_method="SHC"`` enables stochastic hill climbing (particles
    accept the first candidate beating their ``previousmax``).
    ``Fourvar`` computes the 2-D Fourier variance of the aligned stack
    each iteration, divides the average's spectrum by it and writes
    ``varf.hdf`` — the CPU twin's ``varf2d_MPI`` behavior
    (test_reffree_gpu_align.py:777-831), which the reference GPU path
    never implemented.  ``dst`` is the CPU twin's discrete-angle delta:
    every 4th iteration (except the last 10) the rotation search is
    restricted to multiples of ``dst`` degrees with no parabolic
    refinement — the perturbation that shakes alignments out of local
    minima (schedule at test_reffree_gpu_align.py:841-846; the GPU
    reference hard-codes delta=0, line 307).
    """
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    log = log or RunLogger(outdir)
    user_func = factory[user_func_name]

    n, ny, nx = images.shape
    assert nx == ny, "images are assumed square"
    if random_method == "SCF":
        # SCF forces half rings (test_reffree_gpu_align.py:714)
        mode = "H"
    last_ring = int(ou) if int(ou) != -1 else nx // 2 - 2
    if yr is None or yr < 0:
        yr = xr
    max_iter = int(maxit) if int(maxit) else 10
    auto_stop = int(maxit) == 0

    # --ir/--rs ring plan, Numrinit(first_ring, last_ring, rstep)
    # semantics of the CPU twin (test_reffree_gpu_align.py:714)
    ir, rs = int(ir), int(rs)
    if ir < 1 or rs < 1 or ir > last_ring:
        raise ValueError(f"invalid ring plan: ir={ir} rs={rs} ou={last_ring}")
    if int(center) > 1:
        # fail at startup, not at the first reference update
        # (ops/center.py documents the honor-or-reject policy)
        raise ValueError(f"--center={int(center)} is not supported "
                         "(reference-documented values: -1, 0, 1)")
    n_rings = len(range(ir, last_ring + 1, rs))
    if ring_scheme == "eman2" and random_method:
        raise ValueError("ring_scheme='eman2' supports the standard "
                         "search only (no SHC/SCF)")
    cfg = AlignConfig(img_dim=nx, ring_num=n_rings, ring_len=256,
                      first_ring=ir, ring_step=rs, ring_scheme=ring_scheme,
                      shift_step=float(ts), shift_rng_x=float(xr),
                      shift_rng_y=float(yr), mode=mode,
                      mirror=not nomirror)

    mask = maskfile if maskfile is not None else model_circle(last_ring, nx)
    mask_j = jnp.asarray(mask)

    ctf_ctx = None
    if CTF:
        # capability beyond the reference (its flag exists but the GPU
        # path never uses it): filt_ctf premultiplication + Wiener
        # average restoration, the SPHIRE ali2d CTF semantics.
        if ctf_params is None:
            raise ValueError("CTF=True requires ctf_params (at least "
                             "per-particle 'dfu' defocus in A)")
        from ..ops.ctf_ops import CtfContext

        ctf_ctx = CtfContext(nx, ctf_params, snr=snr)
        images = ctf_ctx.premultiply(images)
        log.add("CTF premultiplication on, snr=%g" % snr)

    # preprocessing: subtract the mean under the mask
    # (Util.infomask + "data[im] -= st[0]", test_reffree_gpu_align.py:276-278)
    # (jitted: one device program instead of op-by-op dispatch)
    def _prep(imgs, mask):
        mean, _sigma = infomask(imgs, mask)
        return imgs - mean[:, None, None]

    data = np.asarray(jax.jit(_prep)(jnp.asarray(images), mask_j), np.float32)

    engine = AlignmentEngine(data, cfg, n_classes=1, mesh=mesh,
                             sampler=sampler, update_ref=False,
                             batch_size=batch_size, shift_chunk=shift_chunk,
                             random_method=random_method, delta=dst)
    if dst:
        log.add("Discrete angle used         : %d" % int(dst))
    if not engine.resident:
        log.add("streaming %d particles in batches of %d"
                % (n, engine.batch))

    result = RefFreeResult(params=np.zeros((n, 4)), average=np.zeros((nx, nx)))
    a0 = -1.0e22
    sx_sum = 0.0
    sy_sum = 0.0
    sums = None
    tavg = np.zeros((nx, nx), np.float32)
    total_iter = 0

    start_it = 0
    if resume and outdir:
        ck = load_checkpoint(outdir)
        if ck is not None:
            start_it, ck_params, tavg_ck, extra = ck
            start_it += 1
            engine.set_params(ck_params)
            tavg = tavg_ck[0]
            if random_method == "SHC" and "previousmax" in extra:
                engine.set_previousmax(np.asarray(extra["previousmax"]))
            sums = np.asarray(extra["sums"])
            a0 = float(extra["a0"])
            sx_sum = float(extra["sx_sum"])
            sy_sum = float(extra["sy_sum"])
            total_iter = start_it
            log.add("resumed from checkpoint at iteration %d" % start_it)

    def _delta_for(j: int) -> float:
        """--dst schedule (test_reffree_gpu_align.py:841-842): discrete
        angles every 4th iteration, except within the last 10."""
        if not dst or j < 0:
            return 0.0
        return dst if (j % 4 == 0 and (j + 1) <= max_iter - 10) else 0.0

    for it in range(start_it, max_iter):
        total_iter += 1
        # ---- build the new average from the previous iteration's sums
        if sums is None:
            # iteration 0: even/odd sums of the raw stack
            # (statistics.sum_oe, test_reffree_gpu_align.py:363-365)
            sums = np.stack([data[0::2].sum(0), data[1::2].sum(0)])[None]
        ave1, ave2 = sums[0, 0], sums[0, 1]
        if ctf_ctx is not None:
            tavg = ctf_ctx.restore(np.asarray(ave1 + ave2)[None])[0]
        else:
            tavg = ((ave1 + ave2) / n).astype(np.float32)

        log.add("Iteration #%4d" % total_iter)
        log.add("X range = %5.2f   Y range = %5.2f   Step = %5.2f"
                % (xr, yr, ts))

        if outdir:
            write_image(os.path.join(outdir, "aqc.hdf"), tavg, total_iter - 1)
            frsc = fsc_mask(ave1, ave2, mask, 1.0)
            write_fsc(os.path.join(outdir, "resolution%03d" % total_iter), *frsc)
        else:
            frsc = fsc_mask(ave1, ave2, mask, 1.0)

        # ---- Fourier variance of the aligned stack (varf2d semantics:
        # variance computed with the params that built these sums, the
        # average divided by it BEFORE the criterion,
        # test_reffree_gpu_align.py:777-787)
        if Fourvar:
            from ..ops.fourvar import (divide_by_variance, fourier_variance,
                                       variance_map)

            with annotate("reffree::fourvar"):
                vav, rvar = fourier_variance(data, engine.params_np(),
                                             mask=mask_j)
            tavg = divide_by_variance(tavg, vav)
            result.radial_variances.append(rvar)
            if outdir:
                write_image(os.path.join(outdir, "varf.hdf"),
                            variance_map(vav), total_iter - 1)

        # ---- stopping criterion on the unfiltered average
        # (EMAN2 "dot" cmp with negative=0 under the mask,
        #  test_reffree_gpu_align.py:394)
        a1 = float(np.sum(tavg * tavg * mask))
        log.add("Criterion %d = %15.8e" % (total_iter, a1))
        result.criteria.append(a1)

        # ---- user function: tangent filter (+ centering) — (H, W) host
        # work on the CPU backend (small eager ops)
        again = True
        cs = [0.0, 0.0]
        with annotate("reffree::ref_update"), \
                jax.default_device(jax.devices("cpu")[0]):
            if center == -1:
                tavg_f, cs = user_func([mask, 0, tavg, frsc])
                cs = [float(sx_sum) / n, float(sy_sum) / n]
                tavg_f = np.asarray(fshift(jnp.asarray(tavg_f),
                                           -cs[0], -cs[1]))
                log.add("Average center x = %10.3f        Center y = %10.3f"
                        % (cs[0], cs[1]))
            else:
                # after a discrete-angle iteration the reference disables
                # centering in the user function for one call
                # (ref_data[1]=0 when delta != 0,
                #  test_reffree_gpu_align.py:811-816)
                c_eff = 0 if _delta_for(it - 1) != 0.0 else center
                tavg_f, cs = user_func([mask, c_eff, tavg, frsc])
        tavg = np.asarray(tavg_f, np.float32)
        if outdir:
            write_image(os.path.join(outdir, "aqf.hdf"), tavg, total_iter - 1)
        if a1 < a0:
            if auto_stop:
                again = False
        else:
            a0 = a1
        if not again:
            break

        # ---- alignment against the new average
        old_tab = params_table(engine.params_np())
        delta_it = _delta_for(it)
        if delta_it:
            log.add("Iteration %d uses discrete angles (delta=%g)"
                    % (total_iter, delta_it))
        with annotate("reffree::align_iter"):
            out = engine.iterate(tavg[None], discrete=delta_it != 0.0)
        sums = out.class_sums
        sx_sum = out.sx_sum
        sy_sum = out.sy_sum
        if random_method == "SHC":
            log.add("SHC: %d / %d particles kept their previous orientation"
                    % (out.nope, n))

        # ---- QC: pixel error / mirror consistency vs previous params
        # (test_reffree_gpu_align.py:527-538)
        new_tab = params_table(engine.params_np())
        consistent = old_tab[:, 3] == new_tab[:, 3]
        errs = np.asarray(pixel_error_2D(
            (old_tab[:, 0], old_tab[:, 1], old_tab[:, 2]),
            (new_tab[:, 0], new_tab[:, 1], new_tab[:, 2]), last_ring))
        n_cons = int(consistent.sum())
        result.mirror_consistency.append(n_cons / n)
        result.pixel_errors.append(
            float(errs[consistent].sum() / max(n_cons, 1)))
        log.add("Mirror consistency %6.2f%%, mean pixel error %.4f"
                % (100.0 * n_cons / n, result.pixel_errors[-1]))
        if outdir:
            extra = {"sums": sums, "a0": a0,
                     "sx_sum": sx_sum, "sy_sum": sy_sum}
            if random_method == "SHC":
                extra["previousmax"] = engine.previousmax_np()
            save_checkpoint(outdir, it, engine.params_np(), tavg[None],
                            extra=extra)

    if outdir:
        write_image(os.path.join(outdir, "aqfinal.hdf"), tavg, 0)

    result.average = tavg
    result.iterations = total_iter
    result.params = params_table(engine.params_np())
    if outdir:
        write_text_row(result.params, os.path.join(outdir, "initial2Dparams.txt"))
    log.add("Finished ali2d_base")
    return result
