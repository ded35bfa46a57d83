"""Reference-free 2D alignment CLI (ISAC-style pre-alignment).

JAX replacement for ``mpirun test_reffree_gpu_align.py stack
outdir --ou=36 --ts=1`` (main() at test_reffree_gpu_align.py:911): same
arguments and artifacts (``aqc.hdf``, ``aqf.hdf``, ``aqfinal.hdf``,
``resolution%03d``, ``initial2Dparams.txt``).

Usage:
    python -m cryo_ralib_tpu.cli.reffree stack.hdf outdir --ou=36 --xr=2 --ts=1
"""

from __future__ import annotations

import argparse

from .common import (add_common_flags, check_outdir, load_ctf_params,
                     load_mask, load_stack, make_mesh_arg,
                     print_device_info, validate_reffree_flags,
                     writeback_headers)


def build_parser():
    p = argparse.ArgumentParser(
        prog="cryo-ralib-reffree",
        description="Reference-free 2D alignment (Cryo-RAlib rebuild)")
    p.add_argument("stack", help="particle stack (.hdf/.mrcs)")
    p.add_argument("outdir", help="output directory (must not exist)")
    p.add_argument("maskfile", nargs="?", default=None,
                   help="optional mask image replacing the default "
                        "model_circle(ou) (the reference's 3rd positional, "
                        "test_reffree_gpu_align.py:947)")
    return add_common_flags(p, reffree=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.gpu_info:
        print_device_info()
        return 0
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    validate_reffree_flags(args)
    if args.resume:
        import os
        os.makedirs(args.outdir, exist_ok=True)
    else:
        check_outdir(args.outdir)

    from ..models.reffree import ali2d_base_tpu
    from ..utils.log import RunLogger

    log = RunLogger(args.outdir)
    log.print_begin_msg("ali2d_base_tpu")
    images, _headers = load_stack(args.stack)
    mask = load_mask(args.maskfile, images.shape[-1])
    mesh = make_mesh_arg(args.devices)

    ctf_params = load_ctf_params(args, images.shape[0])
    res = ali2d_base_tpu(
        images, outdir=args.outdir, maskfile=mask,
        ir=args.ir, ou=args.ou, rs=args.rs,
        xr=args.xr, yr=args.yr, ts=args.ts,
        dst=args.dst, center=args.center, maxit=args.maxit,
        CTF=ctf_params is not None, ctf_params=ctf_params,
        Fourvar=args.Fourvar,
        snr=args.snr, user_func_name=args.function,
        random_method=args.random_method, nomirror=args.nomirror,
        mode=args.mode, log=log, mesh=mesh,
        sampler=args.sampler, resume=args.resume,
        ring_scheme=args.ring_scheme,
    )
    if args.header_writeback:
        writeback_headers(args.stack, res.params)
    log.print_end_msg("ali2d_base_tpu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
