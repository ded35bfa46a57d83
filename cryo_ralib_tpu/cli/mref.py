"""Multireference 2D alignment CLI.

JAX replacement for ``mpirun -np N test_mref_gpu_align.py
stack refs outdir --ou=36 --xr=3 ...`` (reference README.md:54-59;
main() at test_mref_gpu_align.py:1136): same positional arguments, same
flags, same output artifacts (``aqm%03d.hdf`` class averages with
``members``/``ave_n`` headers, ``drm*`` FSC files, final params), no MPI
— multi-chip scaling comes from the particle-axis mesh.

Usage:
    python -m cryo_ralib_tpu.cli.mref stack.hdf refs.hdf outdir --ou=36 \
        --xr=3 --yr=3 --ts=1 --maxit=6
"""

from __future__ import annotations

import argparse


from .common import (add_common_flags, check_outdir, load_ctf_params,
                     load_mask, load_stack, make_mesh_arg,
                     print_device_info, writeback_headers)


def build_parser():
    p = argparse.ArgumentParser(
        prog="cryo-ralib-mref",
        description="Multireference 2D alignment (Cryo-RAlib rebuild)")
    p.add_argument("stack", help="particle stack (.hdf/.mrcs)")
    p.add_argument("refs", help="initial references (.hdf/.mrcs)")
    p.add_argument("outdir", help="output directory (must not exist)")
    p.add_argument("maskfile", nargs="?", default=None,
                   help="optional mask image replacing the default "
                        "model_circle(ou) (the reference's 4th positional, "
                        "test_mref_gpu_align.py:317-320)")
    return add_common_flags(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.gpu_info:
        print_device_info()
        return 0
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.resume:
        import os
        os.makedirs(args.outdir, exist_ok=True)
    else:
        check_outdir(args.outdir)

    from ..models.mref import mref_ali2d_tpu
    from ..utils.log import RunLogger

    log = RunLogger(args.outdir)
    log.print_begin_msg("mref_ali2d_tpu")
    images, _headers = load_stack(args.stack)
    refs, _ = load_stack(args.refs)
    mask = load_mask(args.maskfile, images.shape[-1])
    mesh = make_mesh_arg(args.devices)

    # unlike the reference (which force-disables CTF, ":308  # okay..?"),
    # --CTF here enables real premultiply+Wiener processing
    ctf_params = load_ctf_params(args, images.shape[0])
    res = mref_ali2d_tpu(
        images, refs, outdir=args.outdir, maskfile=mask,
        ir=args.ir, ou=args.ou, rs=args.rs,
        xr=args.xr, yr=args.yr, ts=args.ts,
        center=args.center, maxit=args.maxit,
        CTF=ctf_params is not None, ctf_params=ctf_params,
        snr=args.snr, user_func_name=args.function,
        rand_seed=args.rand_seed, log=log, mesh=mesh,
        sampler=args.sampler, resume=args.resume,
        ring_scheme=args.ring_scheme,
    )
    if args.header_writeback:
        writeback_headers(args.stack, res.params, res.assignments)
    log.print_end_msg("mref_ali2d_tpu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
