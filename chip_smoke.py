"""Smoke test of the alignment system on one NVIDIA GPU.

Drives the main path through the entry points a user calls, at the
reference's own headline recipe (rib80s: 90 px, K=8, xr=yr=3, ts=1,
ou=36, full mirror search; BASELINE.md, SURVEY.md §3.1), on a stack
generated from ``--seed``:

  phase 0  device, card name and power limit, versions, h5py, native
           I/O library, compile-cache directory
  phase 1  compile the "auto" step at the phase-3 shape and print its
           memory analysis
  phase 2  step rate of every engine the selector chooses among, per
           step mode (the numbers ``models.steps.select_engine``'s GPU
           preference follows), and the template column-chunk sizes
  phase 3  ``mref_ali2d_tpu`` end to end: N=32,768, 3 iterations, class
           recovery >= 99%
  phase 4  ``ali2d_base_tpu`` (reference-free, K=1) on the same stack
  phase 5  parity on the card: the auto engine against the gather engine
           at "highest" matmul precision, both against the numpy oracle,
           then the ``gpu``-marked tests

Usage, from the repository root:

    python chip_smoke.py            # one card, phases 0-5
    python chip_smoke.py --four     # phase 3 on a 4-card 'dp' mesh
                                    # against the same run on one card

Every phase prints its result on its own lines; any failure exits
non-zero.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
Without a GPU, or outside the repository, the script fails before it
prints any result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# rib80s smoke geometry
NX, K, OU, XR, TS = 90, 8, 36, 3.0, 1.0
N_STACK = 32768      # phase-3/4 particles
N_STEP = 8192        # phase-2 timing batch
N_PARITY = 2048      # phase-5 engine-vs-engine particles
N_ORACLE = 64        # phase-5 particles checked against the numpy oracle
MAXIT = 3
NOISE = 0.2          # white-noise std; the templates have unit RMS
MAX_SHIFT = 2        # true shifts are integers in [-2, 2]
REPS = 3             # timed calls per engine (median)
COL_CHUNKS = (1024, 2048, 4096, 8192)

# Phase-5 tolerances.  The bf16 engines are held to the search's own
# resolution, not to bitwise equality with an f32 reference:
#  - class and mirror decide the averages: identical, except near-ties —
#    particles the float64 oracle itself scores within NEAR_TIE of each
#    other for both picks.  bf16 operands keep 8 significant bits
#    (rounding <= 2^-9 per factor); over the 6,561-pixel template sum the
#    peak's relative error stays below 1e-3, so closer picks are decided
#    by rounding.  The smoke stack has such mirror near-ties (oracle
#    margins of 1e-5..2e-4 for ~0.5% of particles), and at most
#    MAX_TIE_SHARE of the particles (at least one) may be one;
#  - angle: half a degree, a third of the 1.41-degree ring bin — bf16
#    products move the parabolic refinement by far less, a wrong bin
#    moves it by a whole bin;
#  - shift: the grid is integral (ts=1), so any other winner is >= 1 px;
#  - class sums: 5% relative — the auto engine transforms with the
#    FFT-shear (sinc) warp and gather with bilinear texture reads, and
#    the two kernels differ by that much (tests/test_fastpath.py).
ANGLE_TOL_DEG = 0.5
SHIFT_TOL_PX = 0.5
NEAR_TIE = 1e-3
MAX_TIE_SHARE = 0.01
CLASS_SUM_RTOL = 0.05
RECOVERY_MIN = 0.99
# --four: each card compiles its own batch shape, and XLA may pick other
# matrix-product algorithms for it, so a near-tie may resolve the other
# way for a few particles; class sums add the same particles in another
# order, which f32 carries to ~1e-6.
FOUR_AGREE_MIN = 0.999
FOUR_SUM_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# comparisons (pure numpy; tested on the CPU)
# ---------------------------------------------------------------------------

def circular_deg(a, b) -> np.ndarray:
    """|a - b| on the circle, degrees."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 360.0
    return np.minimum(d, 360.0 - d)


def relative_diff(x, ref) -> float:
    """max |x - ref| / max |ref|."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


def _field(p, name) -> np.ndarray:
    return np.asarray(p[name] if isinstance(p, dict) else getattr(p, name))


def compare_params(got, want, angle_tol: float = ANGLE_TOL_DEG,
                   shift_tol: float = SHIFT_TOL_PX) -> dict:
    """Per-particle agreement of two parameter sets.  ``got``/``want``
    have fields or keys angle, shift_x, shift_y, mirror, ref_id.  Angles
    and shifts are compared where class and mirror agree; ``mismatch``
    lists the particles where they do not."""
    same = ((_field(got, "ref_id") == _field(want, "ref_id"))
            & (_field(got, "mirror") == _field(want, "mirror")))
    d_ang = circular_deg(_field(got, "angle"), _field(want, "angle"))
    d_sh = np.maximum(
        np.abs(_field(got, "shift_x") - _field(want, "shift_x")),
        np.abs(_field(got, "shift_y") - _field(want, "shift_y")))
    max_ang = float(d_ang[same].max(initial=0.0))
    max_sh = float(d_sh[same].max(initial=0.0))
    return dict(n=int(same.size), mismatch=np.nonzero(~same)[0].tolist(),
                max_dangle_deg=max_ang, max_dshift_px=max_sh,
                ok=bool(max_ang <= angle_tol and max_sh <= shift_tol))


def near_tie(scores, mirror: int, ref_id: int, tol: float = NEAR_TIE) -> bool:
    """True when the oracle's (M, K) pick scores put (mirror, ref_id)
    within ``tol`` (relative) of the best pick."""
    scores = np.asarray(scores, np.float64)
    best = scores.max()
    return bool(best - scores[mirror, ref_id] <= tol * abs(best))


def parity(name, got, want, oracle_scores: dict,
           max_tie_share: float = MAX_TIE_SHARE) -> dict:
    """``compare_params`` plus the near-tie rule: every class/mirror
    mismatch must be a near-tie for both picks under the oracle's scores
    (``oracle_scores[i]``, an (M, K) array), and at most
    ``max_tie_share`` of the particles (at least one) may differ."""
    c = compare_params(got, want)
    untied = [i for i in c["mismatch"]
              if not all(near_tie(oracle_scores[i], int(_field(p, "mirror")[i]),
                                  int(_field(p, "ref_id")[i]))
                         for p in (got, want))]
    allowed = max(1.0, max_tie_share * c["n"])
    c.update(name=name, near_ties=len(c["mismatch"]) - len(untied),
             untied=untied,
             ok=bool(c["ok"] and not untied
                     and len(c["mismatch"]) <= allowed))
    del c["mismatch"]
    return c


def class_recovery(assign, truth, k: int) -> float:
    """Share of particles in their generating class, under the best
    one-to-one relabelling of the k classes."""
    from scipy.optimize import linear_sum_assignment

    conf = np.zeros((k, k), np.int64)
    np.add.at(conf, (np.asarray(truth), np.asarray(assign)), 1)
    rows, cols = linear_sum_assignment(-conf)
    return float(conf[rows, cols].sum() / max(len(truth), 1))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def card_lines() -> list[str]:
    """``nvidia-smi``'s name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def time_calls(fn, args, reps: int = REPS) -> tuple[float, float]:
    """(first-call seconds incl. compile, median steady seconds)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))


class IterClock:
    """RunLogger stand-in that timestamps the log line a driver writes
    once per iteration."""

    def __init__(self, marker: str):
        self.marker = marker
        self.t0 = time.perf_counter()
        self.stamps: list[float] = []

    def add(self, msg: str):
        if str(msg).startswith(self.marker):
            self.stamps.append(time.perf_counter())

    def iteration_seconds(self) -> list[float]:
        edges = [self.t0] + self.stamps
        return [b - a for a, b in zip(edges, edges[1:])]


def rib80s_config(mode: str = "F"):
    from cryo_ralib_tpu.config import AlignConfig

    return AlignConfig(img_dim=NX, ring_num=OU, ring_len=256, mode=mode,
                       shift_step=TS, shift_rng_x=XR, shift_rng_y=XR)


def step_args(images):
    """(images, zero params, global index, valid) on the default device,
    as the resident driver places them."""
    from cryo_ralib_tpu.params import AlignParams
    from cryo_ralib_tpu.parallel.mesh import shard_stack

    imgs, gidx, valid = shard_stack(images, None)
    return imgs, AlignParams.zeros(imgs.shape[0]), gidx, valid


def params_np(p) -> dict:
    return {f: np.asarray(getattr(p, f)) for f in
            ("angle", "shift_x", "shift_y", "mirror", "ref_id")}


def _oracle_one(args):
    from cryo_ralib_tpu.utils import oracle

    return oracle.align_particle_scores_np(*args)


def oracle_align(images, templates, cfg, idx) -> dict:
    """The float64 numpy oracle on particles ``idx``, in a pool of
    worker processes that stay off JAX's devices: {i: (decoded, scores)}."""
    import concurrent.futures
    import multiprocessing

    jobs = [(np.asarray(images[i], np.float64),
             np.asarray(templates, np.float64), cfg.polar_coords,
             cfg.ring_weights, cfg.shifts, cfg.shift_limit) for i in idx]
    workers = max(1, min(len(jobs), os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return dict(zip(idx, ex.map(_oracle_one, jobs)))


def run_driver(name, fn, marker, *args, **kwargs):
    """Run one driver end to end; returns (result, per-iteration s)."""
    clock = IterClock(marker)
    res = fn(*args, log=clock, **kwargs)
    its = clock.iteration_seconds()
    check(len(its) == MAXIT, f"{name}: {len(its)} iterations, want {MAXIT}")
    return res, its


def print_rate(phase: str, name: str, n: int, its, card: str,
               cards: int = 1):
    steady = float(np.mean(its[1:]))
    print(f"{phase} {name}: iteration seconds "
          + " ".join(f"{t:.3f}" for t in its)
          + f" (first includes compilation); steady {steady:.3f} s/iter, "
          f"{n / steady:.1f} aligned particles/s"
          + (f", {n / steady / cards:.1f} per card" if cards > 1 else "")
          + f" [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase0(n_cards: int):
    import jax
    import jaxlib

    from cryo_ralib_tpu import native
    from cryo_ralib_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    check(len(devs) >= n_cards,
          f"need {n_cards} GPUs, JAX sees {len(devs)}")
    cards = card_lines()
    for ln in cards:
        print(f"phase0 card: {ln}")
    print(f"phase0 jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"devices: {len(devs)} x {devs[0].device_kind}")
    try:
        import h5py
        has_h5py = True
        print(f"phase0 h5py: {h5py.__version__}")
    except ImportError:
        has_h5py = False
        print("phase0 h5py: missing (drivers run with outdir=None)")
    print(f"phase0 native I/O library: "
          f"{'loaded' if native.available() else 'not built'}")
    print(f"phase0 compile cache: {cache}", flush=True)
    return cards[0], has_h5py


def make_stack(seed: int):
    from cryo_ralib_tpu.utils.synthetic import asymmetric_templates, pose_stack

    t0 = time.perf_counter()
    templates = asymmetric_templates(K, NX)
    stack = pose_stack(templates, N_STACK, max_shift=MAX_SHIFT, noise=NOISE,
                       seed=seed, mirror=True)
    print(f"data: {N_STACK} particles {NX} px, K={K}, seed {seed}, "
          f"{int(stack.mirrors.sum())} mirrored, generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return templates, stack


def phase1(templates, stack):
    import jax.numpy as jnp

    from cryo_ralib_tpu.models.steps import make_align_step, select_engine

    cfg = rib80s_config()
    engine = select_engine(cfg, K)
    imgs, params, gidx, valid = step_args(stack.images)
    step = make_align_step(cfg, K)   # the resident driver's step
    t0 = time.perf_counter()
    compiled = step.lower(imgs, jnp.asarray(templates), params, gidx,
                          valid).compile()
    ma = compiled.memory_analysis()
    print(f"phase1 auto engine: {engine}; compiled the N={N_STACK} step in "
          f"{time.perf_counter() - t0:.1f} s")
    print("phase1 memory_analysis: "
          + (", ".join(f"{a}={getattr(ma, a)}" for a in (
              "argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes"))
             if ma is not None else "None"), flush=True)


def phase2(templates, stack, card: str):
    import jax
    import jax.numpy as jnp

    from cryo_ralib_tpu.models.steps import (make_align_step,
                                             make_align_step_scf,
                                             make_align_step_shc,
                                             select_engine)
    from cryo_ralib_tpu.ops.transform import rot_shift2d

    # the module (the package re-exports its function of the same name)
    template_search = importlib.import_module(
        "cryo_ralib_tpu.ops.template_search")

    cfg = rib80s_config()
    sub = stack.images[:N_STEP]
    imgs, params, gidx, valid = step_args(sub)
    refs = jnp.asarray(templates)
    rates: dict = {}

    def report(mode, name, n, fn, args):
        first, dt = time_calls(fn, args)
        rates.setdefault(mode, {})[name] = n / dt
        print(f"phase2 {mode}/{name}: {n / dt:.1f} particles/s "
              f"({dt * 1e3:.2f} ms per {n}; first call {first:.1f} s) "
              f"[{card}]", flush=True)

    default_chunk = template_search.COL_CHUNK_TARGET
    try:
        for chunk in COL_CHUNKS:
            template_search.COL_CHUNK_TARGET = chunk
            step = make_align_step(cfg, K, sampler="template", donate=False)
            report("standard", f"template[cols={chunk}]", N_STEP, step,
                   (imgs, refs, params, gidx, valid))
    finally:
        template_search.COL_CHUNK_TARGET = default_chunk
    for sampler in ("matmul", "gather"):
        step = make_align_step(cfg, K, sampler=sampler, donate=False)
        report("standard", sampler, N_STEP, step,
               (imgs, refs, params, gidx, valid))

    pm = jnp.full((N_STEP,), 1.0e-23, jnp.float32)
    for sampler in ("template", "matmul", "gather"):
        step = make_align_step_shc(cfg, 1, sampler=sampler)
        report("shc", sampler, N_STEP, step,
               (imgs, refs[:1], params, gidx, valid, pm))

    cfg_h = rib80s_config(mode="H")
    for sampler in ("matmul", "gather"):
        step = make_align_step_scf(cfg_h, 1, sampler=sampler)
        report("scf", sampler, N_STEP, step,
               (imgs, refs[:1], params, gidx, valid))

    rng = np.random.default_rng(5)
    targs = tuple(jnp.asarray(a) for a in (
        rng.uniform(0, 360, N_STEP).astype(np.float32),
        rng.uniform(-3, 3, N_STEP).astype(np.float32),
        rng.uniform(-3, 3, N_STEP).astype(np.float32),
        rng.integers(0, 2, N_STEP).astype(np.int32)))
    for engine in ("shear", "quadri"):
        fn = jax.jit(lambda i, a, x, y, m, e=engine:
                     rot_shift2d(i, a, x, y, mirror=m, engine=e))
        report("transform", engine, N_STEP, fn, (imgs,) + targs)

    best = {mode: max(r, key=r.get) for mode, r in rates.items()}
    auto = {"standard": select_engine(cfg, K),
            "shc": select_engine(cfg, 1, mode="shc"),
            "scf": select_engine(cfg_h, 1, mode="scf"),
            "transform": select_engine(mode="transform")}
    for mode in auto:
        fastest = best[mode].split("[")[0]
        print(f"phase2 {mode}: fastest {best[mode]}, auto picks "
              f"{auto[mode]} ({'agrees' if fastest == auto[mode] else 'DIFFERS'})",
              flush=True)


def phase3(templates, stack, card: str, outdir, mesh=None, cards: int = 1,
           label: str = "phase3"):
    from cryo_ralib_tpu.models.mref import mref_ali2d_tpu

    res, its = run_driver(
        "mref", mref_ali2d_tpu, "ITERATION #", stack.images,
        templates.copy(), outdir=outdir, ou=OU, xr=XR, yr=XR, ts=TS,
        maxit=MAXIT, mesh=mesh)
    print_rate(label, "mref_ali2d_tpu", N_STACK, its, card, cards)
    rec = class_recovery(res.assignments, stack.class_ids, K)
    print(f"{label} class recovery: {rec:.5f} (min {RECOVERY_MIN})",
          flush=True)
    check(rec >= RECOVERY_MIN, f"{label}: class recovery {rec:.4f}")
    check(bool(np.isfinite(res.references).all()),
          f"{label}: non-finite references")
    return res


def phase4(stack, card: str, outdir):
    from cryo_ralib_tpu.models.reffree import ali2d_base_tpu

    res, its = run_driver(
        "reffree", ali2d_base_tpu, "Mirror consistency", stack.images,
        outdir=outdir, ou=OU, xr=XR, yr=XR, ts=TS, maxit=MAXIT)
    print_rate("phase4", "ali2d_base_tpu", N_STACK, its, card)
    check(bool(np.isfinite(res.average).all()
               and np.isfinite(res.params).all()),
          "phase4: non-finite average or parameters")
    print(f"phase4 mirror consistency per iteration: "
          + " ".join(f"{c:.4f}" for c in res.mirror_consistency),
          flush=True)


def phase5(templates, stack):
    import jax
    import jax.numpy as jnp

    from cryo_ralib_tpu.models.steps import make_align_step, select_engine

    cfg = rib80s_config()
    sub = stack.images[:N_PARITY]
    imgs, params, gidx, valid = step_args(sub)
    refs = jnp.asarray(templates)
    auto = make_align_step(cfg, K, donate=False)
    out_auto = auto(imgs, refs, params, gidx, valid)
    gather = make_align_step(cfg, K, sampler="gather", donate=False)
    with jax.default_matmul_precision("highest"):
        out_ref = gather(imgs, refs, params, gidx, valid)
    p_auto, p_ref = params_np(out_auto.params), params_np(out_ref.params)

    # the oracle arbitrates every mismatch and checks the first N_ORACLE
    pre = compare_params(p_auto, p_ref)["mismatch"]
    idx = sorted(set(range(N_ORACLE)) | set(pre))
    t0 = time.perf_counter()
    orc = oracle_align(sub, templates, cfg, idx)
    print(f"phase5 numpy oracle on {len(idx)} particles: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    scores = {i: orc[i][1] for i in idx}

    c = parity(f"auto ({select_engine(cfg, K)}) vs gather@highest", p_auto,
               p_ref, scores)
    rel = relative_diff(out_auto.class_sums, out_ref.class_sums)
    print(f"phase5 {c} on {N_PARITY}; class sums rel {rel:.2e} "
          f"(max {CLASS_SUM_RTOL})", flush=True)
    check(c["ok"], "phase5: auto engine disagrees with gather")
    check(rel <= CLASS_SUM_RTOL, f"phase5: class sums differ by {rel:.3g}")

    want = {f: np.asarray([orc[i][0][f] for i in range(N_ORACLE)])
            for f in ("angle", "shift_x", "shift_y", "mirror", "ref_id")}
    for name, p in (("auto", p_auto), ("gather", p_ref)):
        got = {f: v[:N_ORACLE] for f, v in p.items()}
        c = parity(f"{name} vs numpy oracle", got, want, scores)
        print(f"phase5 {c} on {N_ORACLE}", flush=True)
        check(c["ok"], f"phase5: {name} engine disagrees with the oracle")

    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    print(f"phase5 gpu-marked tests: exit code {int(rc)}", flush=True)
    check(int(rc) == 0, "phase5: gpu-marked tests failed")


def four_cards(templates, stack, card: str):
    """Phase 3 on a 4-card 'dp' mesh against the same run on one card."""
    from cryo_ralib_tpu.models.engine import AlignmentEngine
    from cryo_ralib_tpu.parallel.mesh import make_mesh

    cfg = rib80s_config()
    mesh = make_mesh(4)
    runs, sums = {}, {}
    for label, m, cards in (("one card", None, 1), ("four cards", mesh, 4)):
        runs[label] = phase3(templates, stack, card, None, mesh=m,
                             cards=cards, label=f"four[{label}]")
        eng = AlignmentEngine(stack.images, cfg, K, mesh=m)
        sums[label] = eng.iterate(templates).class_sums
    a, b = runs["one card"], runs["four cards"]
    agree = float(np.mean((a.assignments == b.assignments)
                          & (a.params[:, 3] == b.params[:, 3])))
    rel = relative_diff(sums["four cards"], sums["one card"])
    print(f"four: class+mirror agreement {agree:.6f} (min {FOUR_AGREE_MIN}); "
          f"first-iteration class sums rel {rel:.2e} (max {FOUR_SUM_RTOL})",
          flush=True)
    check(agree >= FOUR_AGREE_MIN, f"four: agreement {agree:.6f}")
    check(rel <= FOUR_SUM_RTOL, f"four: class sums differ by {rel:.3g}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run phase 3 on a 4-card mesh against one card")
    p.add_argument("--seed", type=int, default=0, help="data seed")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "chip_smoke"),
                   help="output directory of the drivers")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    try:
        import cryo_ralib_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    n_cards = 4 if args.four else 1
    t_start = time.perf_counter()
    try:
        card, has_h5py = phase0(n_cards)
        templates, stack = make_stack(args.seed)
        if args.four:
            four_cards(templates, stack, card)
        else:
            outdir = None
            if has_h5py:
                shutil.rmtree(args.out, ignore_errors=True)
                outdir = args.out
            phase1(templates, stack)
            phase2(templates, stack, card)
            phase3(templates, stack, card,
                   outdir and os.path.join(outdir, "mref"))
            phase4(stack, card, outdir and os.path.join(outdir, "reffree"))
            phase5(templates, stack)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
