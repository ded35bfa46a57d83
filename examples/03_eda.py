"""Exploratory analysis of alignment results (notebook 03 equivalent).

Aligns a synthetic stack, applies the params, reduces the aligned images
with TwoSDR and clusters the factors — reporting purity against the
generating classes.

    python examples/03_eda.py
"""

import os
import sys

# make the repo importable when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import numpy as np

import jax.numpy as jnp

from cryo_ralib_tpu.analysis import MPCA, TwoSDR, c_purity_score, purity_score
from cryo_ralib_tpu.models import mref_ali2d_tpu
from cryo_ralib_tpu.ops.transform import rot_shift2d
from cryo_ralib_tpu.utils.log import RunLogger
from cryo_ralib_tpu.utils.synthetic import class_templates, scattered_stack


def kmeans(x, k, iters=50, seed=0):
    """Tiny k-means (avoids a hard sklearn dependency)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        lab = d.argmin(1)
        for j in range(k):
            if (lab == j).any():
                centers[j] = x[lab == j].mean(0)
    return lab


def main():
    nx, n, k = 64, 600, 3
    refs = class_templates(k, nx)
    imgs, cls, _, _ = scattered_stack(refs, n, max_shift=2, seed=21)

    res = mref_ali2d_tpu(imgs, refs.copy(), ou=24, xr=2, yr=2, ts=1,
                         maxit=3, log=RunLogger(None, quiet=True))
    print(f"alignment purity: {purity_score(cls, res.assignments):.3f}")

    # build the aligned stack from the params (notebook 03 cell flow)
    p = res.params
    aligned = np.asarray(rot_shift2d(
        jnp.asarray(imgs), jnp.asarray(p[:, 0].astype(np.float32)),
        jnp.asarray(p[:, 1].astype(np.float32)),
        jnp.asarray(p[:, 2].astype(np.float32)),
        mirror=jnp.asarray(p[:, 3].astype(np.int32))))

    factors, Gt, At, Bt, mY = TwoSDR(aligned, 20, 20, 8)
    lab = kmeans(factors, k, seed=0)
    print(f"TwoSDR(20,20,8) k-means purity:  {purity_score(cls, lab):.3f}")
    print(f"                class purity:    {c_purity_score(cls, lab):.3f}")

    core, *_ = MPCA(aligned, 10, 10)
    lab2 = kmeans(core, k, seed=0)
    print(f"MPCA(10,10)     k-means purity:  {purity_score(cls, lab2):.3f}")


if __name__ == "__main__":
    main()
