"""Batch rotate/shift transforms (notebook 02 equivalent).

Compares the quadri-interpolation engine (notebook parity) with the
gather-free FFT-shear engine, checks their agreement, and reconstructs
class averages from alignment params — the notebook's workload.

    python examples/02_batch_transform.py
"""

import os
import sys

# make the repo importable when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

import jax
import jax.numpy as jnp

from cryo_ralib_tpu.models.steps import select_engine
from cryo_ralib_tpu.ops.transform import rot_shift2d
from cryo_ralib_tpu.utils.profiling import force
from cryo_ralib_tpu.utils.synthetic import class_templates, scattered_stack


def main():
    nx, n, k = 90, 1024, 4
    refs = class_templates(k, nx)
    imgs, cls, angs, shifts = scattered_stack(refs, n, max_shift=3, seed=3)
    imgs_j = jnp.asarray(imgs)
    # undo the generating transforms to reconstruct the class averages
    back_ang = jnp.asarray((360.0 - angs) % 360.0)
    zero = jnp.zeros(n, jnp.float32)

    engines = ["quadri", "shear"]
    print(f"rot_shift2d(engine='auto') on {jax.default_backend()}: "
          f"{select_engine(mode='transform')}")
    outs = {}
    for engine in engines:
        fn = jax.jit(lambda im, a: rot_shift2d(im, a, zero, zero,
                                               engine=engine))
        force(fn(imgs_j, back_ang))  # compile
        t0 = time.perf_counter()
        out = fn(imgs_j, back_ang)
        force(out)
        dt = time.perf_counter() - t0
        outs[engine] = np.asarray(out)
        print(f"{engine:>7}: {n / dt:10.0f} images/s")

    d = np.abs(outs["quadri"] - outs["shear"]).max()
    print(f"engine max abs difference: {d:.4f}")

    # class averages from the de-rotated stack
    avgs = np.stack([outs[engines[-1]][cls == j].mean(0) for j in range(k)])
    err = np.abs(avgs - refs).mean()
    print(f"class-average reconstruction error vs templates: {err:.4f}")


if __name__ == "__main__":
    main()
