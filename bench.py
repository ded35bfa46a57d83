"""Benchmark: multireference alignment throughput on one GPU.

Workload mirrors the reference's headline benchmark (BASELINE.md): rib80s-like
90 px particles, K=8 references, xr=yr=3, ts=1 (49-point shift grid), ou=36
rings x 256 angles, full mirror search.

Prints ONE JSON line:
  metric      mref_particles_per_sec_per_chip
  value       sustained aligned particles/s on one GPU: the device-resident
              multi-iteration loop (6 mref iterations — search + transform
              + class sums + reference rebuild — per dispatch,
              models/device_loop.py), the same whole-run methodology the
              reference's published timings use
  vs_baseline null: no measured baseline exists on this card yet
  detail      the device as JAX reports it, the card's name and power
              limit (nvidia-smi), each row's rate and the engine it ran

Every engine comes from ``models.steps.select_engine``, the choice the
drivers make.  Timings end in ``jax.block_until_ready``.  Without a GPU
the script exits non-zero and prints no result.

Usage: python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial

import numpy as np

import jax

from cryo_ralib_tpu.config import AlignConfig
from cryo_ralib_tpu.models.steps import (make_align_step, make_align_step_scf,
                                         make_align_step_shc, select_engine)
from cryo_ralib_tpu.params import AlignParams

NX = 90
K = 8
N_DEV = 16384
N_SMALL = 8192
REPS = 3
CFG = AlignConfig(img_dim=NX, ring_num=36, ring_len=256,
                  shift_step=1.0, shift_rng_x=3.0, shift_rng_y=3.0)
# realistic box (160 px / ou=48) and big box (256 px / ou=100)
CFG160 = AlignConfig(img_dim=160, ring_num=48, ring_len=256,
                     shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0)
CFG256 = AlignConfig(img_dim=256, ring_num=100, ring_len=256,
                     shift_step=1.0, shift_rng_x=2.0, shift_rng_y=2.0)
# the EMAN2-exact variable-ring scheme at the headline geometry
CFG_EMAN = AlignConfig(img_dim=NX, ring_num=36, ring_scheme="eman2",
                       shift_step=1.0, shift_rng_x=3.0, shift_rng_y=3.0)
# a non-default --ir/--rs ring plan: radii 4,6,...,36
CFG_PLAN = AlignConfig(img_dim=NX, ring_num=17, ring_len=256,
                       first_ring=4, ring_step=2,
                       shift_step=1.0, shift_rng_x=3.0, shift_rng_y=3.0)
# SCF runs half rings
CFG_H = AlignConfig(img_dim=NX, ring_num=36, ring_len=256, mode="H",
                    shift_step=1.0, shift_rng_x=3.0, shift_rng_y=3.0)


def _inputs(device, n, k, nx, seed=0):
    rng = np.random.default_rng(seed)
    put = partial(jax.device_put, device=device)
    return (put(rng.standard_normal((n, nx, nx)).astype(np.float32)),
            put(rng.standard_normal((k, nx, nx)).astype(np.float32)),
            put(AlignParams.zeros(n)),
            put(np.arange(n, dtype=np.int32)),
            put(np.ones((n,), np.float32)))


def _median_seconds(fn, args, reps=REPS):
    jax.block_until_ready(fn(*args))        # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def step_pps(device, n, k=K, cfg=CFG, update_ref=True):
    """Single-dispatch step rate of the auto engine: (particles/s, engine)."""
    engine = select_engine(cfg, k)
    fn = make_align_step(cfg, k, update_ref=update_ref, donate=False)
    return n / _median_seconds(fn, _inputs(device, n, k, cfg.img_dim)), engine


def sustained_pps(device, n, n_iter=6, k=K, cfg=CFG):
    """Device-resident multi-iteration mref loop: (particles/s, engine)."""
    from cryo_ralib_tpu.models.device_loop import make_mref_device_loop

    loop = make_mref_device_loop(cfg, n_iter, k,
                                 np.full(n_iter, 0.25, np.float32))
    dt = _median_seconds(loop, _inputs(device, n, k, cfg.img_dim))
    return n * n_iter / dt, select_engine(cfg, k)


def shc_pps(device, n):
    """SHC step rate (random_method="SHC"), K=1 with a previousmax."""
    imgs, refs, params, gidx, valid = _inputs(device, n, 1, NX)
    pm = jax.device_put(np.full(n, 1.0e-23, np.float32), device)
    fn = make_align_step_shc(CFG, n_classes=1)
    dt = _median_seconds(fn, (imgs, refs, params, gidx, valid, pm))
    return n / dt, select_engine(CFG, 1, mode="shc")


def scf_pps(device, n):
    """SCF step rate (random_method="SCF"), half rings, K=1."""
    fn = make_align_step_scf(CFG_H, n_classes=1)
    dt = _median_seconds(fn, _inputs(device, n, 1, NX))
    return n / dt, select_engine(CFG_H, 1, mode="scf")


def rot_shift_pps(device, n):
    """Batch ``rot_shift2D`` rate (the notebook-02 CuPy transform)."""
    from cryo_ralib_tpu.ops.transform import rot_shift2d

    rng = np.random.default_rng(3)
    args = tuple(jax.device_put(a, device) for a in (
        rng.standard_normal((n, NX, NX)).astype(np.float32),
        rng.uniform(0, 360, n).astype(np.float32),
        rng.uniform(-3, 3, n).astype(np.float32),
        rng.uniform(-3, 3, n).astype(np.float32),
        rng.integers(0, 2, n).astype(np.int32)))
    fn = jax.jit(lambda i, a, x, y, m: rot_shift2d(i, a, x, y, mirror=m))
    return n / _median_seconds(fn, args), select_engine(mode="transform")


def card_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.splitlines()[0].strip()


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    from cryo_ralib_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rows = {
        "mref_sustained": (sustained_pps, dev, N_SMALL),
        "mref_step": (step_pps, dev, N_DEV),
        "reffree_step": (partial(step_pps, k=1, update_ref=False), dev,
                         N_SMALL),
        "rot_shift2d": (rot_shift_pps, dev, N_SMALL),
        "eman2_step": (partial(step_pps, cfg=CFG_EMAN), dev, N_SMALL),
        "eman2_sustained": (partial(sustained_pps, cfg=CFG_EMAN), dev,
                            N_SMALL),
        "ring_plan_step": (partial(step_pps, cfg=CFG_PLAN), dev, N_SMALL),
        "mref_k32_step": (partial(step_pps, k=32), dev, N_SMALL),
        "mref_k64_step": (partial(step_pps, k=64), dev, 4096),
        "mref_160px_step": (partial(step_pps, k=4, cfg=CFG160), dev, N_SMALL),
        "mref_256px_step": (partial(step_pps, k=4, cfg=CFG256), dev, 4096),
        "shc_step": (shc_pps, dev, N_SMALL),
        "scf_step": (scf_pps, dev, N_SMALL),
    }
    detail = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "card": card_name_and_power(),
              "config": "90px K=8 xr=yr=3 ts=1 ou=36 ring_len=256 mirror"}
    for name, (fn, *args) in rows.items():
        pps, engine = fn(*args)
        detail[name] = {"particles_per_s": pps, "engine": engine,
                        "n": args[-1]}
    print(json.dumps({
        "metric": "mref_particles_per_sec_per_chip",
        "value": detail["mref_sustained"]["particles_per_s"],
        "unit": "particles/s",
        "vs_baseline": None,
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
