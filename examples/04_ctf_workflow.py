"""CTF-aware multireference alignment (capability beyond the reference).

Simulates a defocus-series particle stack (each particle imaged under a
different CTF, so a plain average cancels structure at the zero
crossings), writes the stack + a defocus table, and runs the mref driver
twice — once plain, once with ``--CTF`` semantics (filt_ctf
premultiplication + Wiener-restored references, ops/ctf_ops.py) — and
compares reference quality against the ground-truth templates.

    python examples/04_ctf_workflow.py [outdir]

The reference parses --CTF and force-disables it
(test_mref_gpu_align.py:308); see docs/design.md "CTF-aware alignment".
"""

import os
import sys

# make the repo importable when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import tempfile

import numpy as np

from cryo_ralib_tpu.models import mref_ali2d_tpu
from cryo_ralib_tpu.utils.log import RunLogger
from cryo_ralib_tpu.utils.synthetic import asymmetric_templates, scattered_stack


def corr(a, b):
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp()
    os.makedirs(outdir, exist_ok=True)
    k, nx, n = 2, 64, 256
    apix = 1.5

    print(f"simulating {n} particles from {k} templates under a "
          "defocus series ...")
    import jax.numpy as jnp

    from cryo_ralib_tpu.ops.ctf_ops import ctf_rfft2, filt_ctf

    refs = asymmetric_templates(k, nx)
    imgs, cls, _, _ = scattered_stack(refs, n, max_shift=2, seed=7)
    rng = np.random.default_rng(7)
    dfu = rng.uniform(8000.0, 25000.0, n)          # 0.8-2.5 um defocus
    ctf = ctf_rfft2(nx, apix, dfu, dfu, np.zeros(n))
    data = np.asarray(filt_ctf(jnp.asarray(imgs), jnp.asarray(ctf)))
    data = (data + rng.normal(0, 0.05, data.shape)).astype(np.float32)
    np.savetxt(f"{outdir}/defocus.txt", dfu[:, None])
    print(f"wrote {outdir}/defocus.txt (CLI: --CTF --ctf_file ... "
          f"--apix {apix})")

    kw = dict(ou=24, xr=2, yr=2, ts=1, maxit=4,
              log=RunLogger(None, quiet=True))
    print("aligning WITHOUT CTF correction ...")
    plain = mref_ali2d_tpu(data, refs.copy(), outdir=f"{outdir}/plain", **kw)
    print("aligning WITH CTF correction (premultiply + Wiener) ...")
    ctfres = mref_ali2d_tpu(data, refs.copy(), outdir=f"{outdir}/ctf",
                            CTF=True, snr=10.0,
                            ctf_params=dict(dfu=dfu, apix=apix), **kw)

    for name, res in (("plain", plain), ("CTF", ctfres)):
        cs = [max(corr(res.references[j], refs[i]) for j in range(k))
              for i in range(k)]
        print(f"  {name:5s}: reference-vs-template correlation "
              + "  ".join(f"{c:.3f}" for c in cs))
    print(f"artifacts in {outdir}/plain and {outdir}/ctf")


if __name__ == "__main__":
    main()
