"""Ring conventions: the CUDA uniform scheme vs EMAN2 Numrinit rings.

The reference GPU path aligns over uniform 256-sample rings with
radius-linear weights (cuda/gpu_aln_common.cu:39-62,
gpu_aln_noref.cu:978-981); its EMAN2/SPHIRE CPU twin uses variable
power-of-two ring lengths (``Numrinit``) with ``ringwe`` weights
(test_mref_gpu_align.py:741-750).  Both are production options here —
this example aligns the same synthetic stack under both schemes
(``ring_scheme="cuda"`` / ``"eman2"``) and quantifies how often they
agree on (class, mirror) and how far their angles differ, the SURVEY
§3.3 validation contract.

    python examples/07_ring_schemes.py
"""

import os
import sys

# make the repo importable when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

import numpy as np

from cryo_ralib_tpu.models import mref_ali2d_tpu
from cryo_ralib_tpu.rings import numrinit, ringwe
from cryo_ralib_tpu.utils.synthetic import asymmetric_templates, scattered_stack


def main():
    nx, k, n = 64, 3, 48
    base = asymmetric_templates(k, nx)
    imgs, true_cls, true_ang, _shifts = scattered_stack(base, n, max_shift=2,
                                                        seed=11)

    plan = numrinit(1, 20)
    print("Numrinit plan (radius, ring_len):", plan[:4], "...", plan[-2:])
    print("maxrin =", plan[-1][1], " ringwe[0..3] =",
          np.round(ringwe(plan)[:4], 3))

    results = {}
    for scheme in ("cuda", "eman2"):
        with tempfile.TemporaryDirectory() as td:
            res = mref_ali2d_tpu(
                imgs, base, outdir=os.path.join(td, scheme), ou=20,
                xr=2.0, ts=1.0, maxit=1, sampler="gather",
                ring_scheme=scheme, user_func_name="ref_ali2d_no_filter")
        results[scheme] = res
        acc = float((res.assignments == true_cls).mean())
        print(f"{scheme:6s}: class recovery vs ground truth = {acc:.3f}")

    a, b = results["cuda"], results["eman2"]
    agree_cls = float((a.assignments == b.assignments).mean())
    agree_mirror = float((a.params[:, 3] == b.params[:, 3]).mean())
    same = (a.assignments == b.assignments) & (a.params[:, 3]
                                               == b.params[:, 3])
    d = np.abs(a.params[same, 0] - b.params[same, 0])
    d = np.minimum(d, 360.0 - d)
    print(f"scheme agreement: class {agree_cls:.3f}, "
          f"mirror {agree_mirror:.3f}, "
          f"angle max|d| (same winner) = {d.max():.2f} deg")
    assert agree_cls >= 0.9, "schemes should agree on well-separated data"
    print("OK")


if __name__ == "__main__":
    main()
