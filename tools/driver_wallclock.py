"""Full-driver wall-clock check on a GPU (not a test).

Times the COMPLETE ``mref_ali2d_tpu`` protocol — alignment + per-class
FSC + tangent filtering + class-average HDF writes + checkpoints, all
artifacts — on a synthetic rib80s-like stack, warm (second run after
compiles are cached in-process).  This is the end-to-end product
number the step benches in bench.py deliberately exclude.

    python tools/driver_wallclock.py [--n=4096] [--maxit=6]

Writes nothing outside a temp dir.
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    kw = {a.split("=")[0][2:]: int(a.split("=")[1])
          for a in sys.argv[1:] if a.startswith("--")}
    n = kw.get("n", 4096)
    maxit = kw.get("maxit", 6)
    k, nx = 8, 90

    from cryo_ralib_tpu.models.mref import mref_ali2d_tpu
    from cryo_ralib_tpu.utils.synthetic import (class_templates,
                                                scattered_stack)

    base = class_templates(k, nx)
    imgs, cls, _, _ = scattered_stack(base, n, max_shift=2, seed=1)
    rng = np.random.default_rng(0)
    imgs = (imgs + rng.normal(0, 0.2, imgs.shape)).astype(np.float32)

    import jax
    print("backend:", jax.default_backend(), flush=True)

    times = []
    agree = None
    for rep in range(2):
        outdir = tempfile.mkdtemp(prefix="mref_wall_")
        try:
            t0 = time.perf_counter()
            res = mref_ali2d_tpu(imgs, base.astype(np.float32),
                                 outdir=outdir, ou=36, xr=3, yr=3, ts=1,
                                 maxit=maxit)
            dt = time.perf_counter() - t0
            times.append(dt)
            # label agreement up to class permutation: purity
            from cryo_ralib_tpu.analysis.metrics import purity_score

            agree = purity_score(cls, res.assignments)
            print(f"rep {rep}: {dt:.1f} s  ({n * maxit / dt:.0f} "
                  f"aligned particles/s incl. host tail), "
                  f"purity {agree:.3f}", flush=True)
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
    print(f"warm wall clock: {min(times):.1f} s  (N={n}, K={k}, "
          f"maxit={maxit}, purity {agree:.3f})")


if __name__ == "__main__":
    main()
