"""Aligned-stack export + class-average reconstruction (notebook-00 tail).

The reference's notebook-00 workflow ends with EMAN2 command-line glue
(/root/reference/notebook/00_tutorial_alignment.ipynb): ``sxheader.py
--params=xform.align2d --zero`` (reset header transforms),
``sxtransform2d.py`` (apply the alignment params to every particle) and
``e2proc2d.py`` (export the aligned stack / averages).  This script is
the one-command equivalent:

    params table -> aligned stack HDF (+ zeroed ``xform.align2d``
    headers, ``assign`` class attr) -> per-class average HDF

Usage:
    python examples/08_export_aligned.py stack.hdf params.txt outdir
    python examples/08_export_aligned.py            # synthetic demo

The params table is the drivers' whitespace format ``alpha sx sy mirror
[class]`` (header convention — ``initial2Dparams.txt`` rows,
test_reffree_gpu_align.py:560-569) or the 6-column EDA format ``idx
angle_psi shift_x shift_y mirror class`` (src/utils_ralib.py:30-34);
the column count disambiguates.  With no arguments it synthesizes a
stack, runs a short mref pass to produce params, then exports — the
full notebook-00 loop in one process.
"""

import os
import sys

# make the repo importable when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import numpy as np

import jax.numpy as jnp


def load_params(path: str):
    """(alpha, sx, sy, mirror, cls_or_None) from either table format."""
    data = np.loadtxt(path, ndmin=2)
    if data.shape[1] >= 6:           # idx angle_psi sx sy mirror class
        return (data[:, 1], data[:, 2], data[:, 3],
                data[:, 4].astype(np.int32), data[:, 5].astype(np.int32))
    if data.shape[1] >= 4:           # alpha sx sy mirror [class]
        cls = data[:, 4].astype(np.int32) if data.shape[1] >= 5 else None
        return (data[:, 0], data[:, 1], data[:, 2],
                data[:, 3].astype(np.int32), cls)
    raise SystemExit(f"params table {path!r} has {data.shape[1]} columns; "
                     "expected >=4 (alpha sx sy mirror [class]) or 6 "
                     "(idx angle_psi sx sy mirror class)")


def export_aligned(images: np.ndarray, alpha, sx, sy, mirror, cls,
                   outdir: str, batch: int = 4096):
    """Apply header-convention params to the raw stack and write the
    notebook-00 artifacts: ``aligned.hdf`` (transformed particles,
    zeroed ``xform.align2d`` + ``assign`` headers) and ``class_avgs.hdf``.
    """
    from cryo_ralib_tpu.io.eman_hdf import write_hdf_stack
    from cryo_ralib_tpu.ops.transform import rot_shift2d

    os.makedirs(outdir, exist_ok=True)
    n = images.shape[0]
    fn = jax.jit(rot_shift2d)
    aligned = np.empty_like(images, dtype=np.float32)
    for i0 in range(0, n, batch):
        sl = slice(i0, min(i0 + batch, n))
        aligned[sl] = np.asarray(fn(
            jnp.asarray(images[sl], jnp.float32),
            jnp.asarray(alpha[sl], jnp.float32),
            jnp.asarray(sx[sl], jnp.float32),
            jnp.asarray(sy[sl], jnp.float32),
            jnp.asarray(mirror[sl], jnp.int32)))

    # sxheader-zeroed transforms: the exported stack is already aligned,
    # so its headers carry the identity (plus the class assignment)
    zero_xf = {"alpha": 0.0, "tx": 0.0, "ty": 0.0, "mirror": 0,
               "scale": 1.0}
    headers = []
    for i in range(n):
        h = {"xform.align2d": zero_xf}
        if cls is not None:
            h["assign"] = int(cls[i])
        headers.append(h)
    stack_path = os.path.join(outdir, "aligned.hdf")
    write_hdf_stack(stack_path, aligned, headers=headers)

    avg_path = None
    if cls is not None:
        k = int(cls.max()) + 1 if n else 0
        counts = np.bincount(cls, minlength=k)
        avgs = np.zeros((k,) + images.shape[1:], np.float32)
        np.add.at(avgs, cls, aligned)
        avgs /= np.maximum(counts, 1)[:, None, None]
        avg_path = os.path.join(outdir, "class_avgs.hdf")
        write_hdf_stack(avg_path, avgs,
                        headers=[{"members": int(c)} for c in counts])
    return stack_path, avg_path, aligned


def main(argv):
    if len(argv) == 4:
        from cryo_ralib_tpu.cli.common import load_stack

        images, _ = load_stack(argv[1])
        alpha, sx, sy, mirror, cls = load_params(argv[2])
        if alpha.shape[0] != images.shape[0]:
            raise SystemExit(f"params rows ({alpha.shape[0]}) != stack "
                             f"size ({images.shape[0]})")
        outdir = argv[3]
    elif len(argv) == 1:
        # synthetic demo: generate -> align (mref driver) -> export
        import tempfile

        from cryo_ralib_tpu.models.mref import mref_ali2d_tpu
        from cryo_ralib_tpu.utils.synthetic import (class_templates,
                                                    scattered_stack)

        nx, n, k = 64, 256, 3
        refs = class_templates(k, nx)
        images, true_cls, _, _ = scattered_stack(refs, n, max_shift=2,
                                                 seed=8)
        outdir = tempfile.mkdtemp(prefix="export_aligned_")
        res = mref_ali2d_tpu(images, refs, outdir=os.path.join(outdir, "mref"),
                             ou=nx // 2 - 4, xr=2.0, ts=1.0, maxit=2)
        alpha, sx, sy = res.params[:, 0], res.params[:, 1], res.params[:, 2]
        mirror = res.params[:, 3].astype(np.int32)
        cls = res.assignments.astype(np.int32)
        agree = (cls == true_cls).mean()
        print(f"mref pass done; class agreement vs truth: {agree:.3f}")
    else:
        raise SystemExit(__doc__)

    stack_path, avg_path, aligned = export_aligned(
        np.asarray(images, np.float32), np.asarray(alpha),
        np.asarray(sx), np.asarray(sy),
        np.asarray(mirror, np.int32), cls, outdir)
    print(f"aligned stack:  {stack_path}  ({aligned.shape[0]} particles)")
    if avg_path:
        print(f"class averages: {avg_path}")

    # round-trip sanity: the exported stack reads back with zeroed
    # transforms and the class assignment intact
    from cryo_ralib_tpu.io.eman_hdf import read_hdf_stack

    back, headers = read_hdf_stack(stack_path)
    assert back.shape == aligned.shape
    np.testing.assert_allclose(back, aligned, atol=1e-6)
    if cls is not None:
        assert int(headers[0].get("assign", -1)) == int(cls[0])
    print("round-trip check ok")


if __name__ == "__main__":
    main(sys.argv)
