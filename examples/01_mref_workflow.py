"""End-to-end multireference alignment workflow (notebook 00 equivalent).

Generates a synthetic particle stack from known class templates, writes
EMAN2-HDF files, runs the mref driver, and scores class recovery —
runnable on CPU or GPU.

    python examples/01_mref_workflow.py [outdir]
"""

import os
import sys

# make the repo importable when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

import numpy as np

from cryo_ralib_tpu.analysis import purity_score
from cryo_ralib_tpu.io.eman_hdf import read_hdf_stack, write_hdf_stack
from cryo_ralib_tpu.models import mref_ali2d_tpu
from cryo_ralib_tpu.utils.synthetic import class_templates, scattered_stack


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp()
    k, nx, n = 4, 90, 512

    print(f"generating {n} particles from {k} templates ...")
    refs = class_templates(k, nx)
    imgs, cls, angs, shifts = scattered_stack(refs, n, max_shift=3, seed=11)
    write_hdf_stack(f"{outdir}/stack.hdf", imgs)
    write_hdf_stack(f"{outdir}/refs.hdf", refs)

    print("aligning ...")
    res = mref_ali2d_tpu(imgs, refs.copy(), outdir=f"{outdir}/run",
                         ou=36, xr=3, yr=3, ts=1, maxit=4)

    print(f"class purity: {purity_score(cls, res.assignments):.3f}")
    # class-k templates are (2+k)-fold rotationally symmetric, so angles
    # are recoverable only modulo 360/(2+k)
    period = 360.0 / (2.0 + cls)
    d = np.abs(res.params[:, 0] - (360.0 - angs) % 360.0) % period
    d = np.minimum(d, period - d)
    print(f"median |angle error| (mod template symmetry): "
          f"{np.median(d):.2f} deg")
    print(f"class counts: {res.class_counts}")

    avgs, _ = read_hdf_stack(f"{outdir}/run/aqm003.hdf")
    print(f"final class averages: {avgs.shape} -> {outdir}/run/aqm003.hdf")


if __name__ == "__main__":
    main()
