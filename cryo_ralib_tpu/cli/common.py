"""Shared CLI plumbing for the alignment front-ends.

Replaces the reference's per-CLI ``main()`` prologue (MPI setup, GPU
communicator surgery, RAM-budgeted batched stack reads and the particle
re-scatter, test_mref_gpu_align.py:1136-1464): one process owns all
local GPUs, the stack is loaded once and sharded over a 'dp' mesh, and
there is nothing to scatter by hand.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _intish(s: str) -> int:
    """The reference parses its integer-valued flags as optparse floats
    (``--ou=36.0`` works there); accept the same spellings."""
    return int(float(s))


def _sched(s: str) -> float:
    """Shift-range/step value, accepting the reference reffree's
    space-separated schedule strings (``--xr="4 2 1 1"``).

    The reference parses these via ``get_input_from_string`` but pins
    ``N_step = 0`` in both its GPU driver and its CPU twin
    (test_reffree_gpu_align.py:355, :750 "#only test first"), so only
    the FIRST entry ever takes effect; this accepts the schedule
    spelling and reproduces exactly that behavior, loudly.
    """
    vals = [float(v) for v in s.replace(",", " ").split()]
    if not vals:
        raise argparse.ArgumentTypeError("empty shift range/step")
    if len(vals) > 1:
        print(f"NOTE: schedule {vals} accepted for compatibility; like "
              "the reference (N_step pinned to 0), only the first entry "
              f"({vals[0]}) is used", file=sys.stderr)
    return vals[0]


def add_common_flags(p: argparse.ArgumentParser, reffree: bool = False):
    """The reference optparse surface (test_mref_gpu_align.py:1142-1159,
    test_reffree_gpu_align.py:915-935), flag for flag — including each
    CLI's own defaults (mref: xr=0, ts=1, center=1; reffree: the
    schedule defaults "4 2 1 1"/"2 1 0.5 0.25" whose first entries are
    xr=4, ts=2, and center=-1)."""
    p.add_argument("--ir", type=_intish, default=1,
                   help="inner ring radius (Numrinit first_ring; the "
                        "reference GPU config ignores it)")
    p.add_argument("--ou", type=_intish, default=-1, help="outer ring radius")
    p.add_argument("--rs", type=_intish, default=1,
                   help="ring step (Numrinit rstep)")
    p.add_argument("--xr", type=_sched, default=4.0 if reffree else 0.0,
                   help="x shift search range (reffree accepts the "
                        "reference's schedule string; first entry used)")
    p.add_argument("--yr", type=_sched, default=-1.0,
                   help="y shift search range (<0: use xr, like the "
                        "reference GPU config)")
    p.add_argument("--ts", type=_sched, default=2.0 if reffree else 1.0,
                   help="shift search step (reffree accepts the "
                        "reference's schedule string; first entry used)")
    p.add_argument("--center", type=_intish, default=-1 if reffree else 1,
                   help="centering method (mref default 1 like the "
                        "reference CLI; reffree default -1 = average "
                        "centering)")
    p.add_argument("--maxit", type=_intish, default=0,
                   help="max iterations (0 = auto)")
    p.add_argument("--CTF", action="store_true",
                   help="CTF-aware alignment: premultiply particles by "
                        "their CTFs and Wiener-restore averages with --snr "
                        "(capability beyond the reference, which "
                        "force-disables this flag, "
                        "test_mref_gpu_align.py:308); requires --ctf_file")
    p.add_argument("--snr", type=float, default=1.0, help="SNR (CTF path)")
    p.add_argument("--ctf_file", default="",
                   help="per-particle CTF parameters: a RELION .star file "
                        "or a whitespace table with columns "
                        "'dfu [dfv [dfang]]' (A / A / deg)")
    p.add_argument("--apix", type=float, default=None,
                   help="pixel size in A (CTF path; default: the STAR "
                        "file's DetectorPixelSize/Magnification if "
                        "present, else 1.0)")
    p.add_argument("--voltage", type=float, default=300.0,
                   help="acceleration voltage in kV (CTF path)")
    p.add_argument("--Cs", type=float, default=2.7,
                   help="spherical aberration in mm (CTF path)")
    p.add_argument("--ac", type=float, default=0.1,
                   help="amplitude contrast ratio (CTF path)")
    p.add_argument("--function", default="ref_ali2d",
                   help="reference-preparation user function")
    p.add_argument("--rand_seed", type=int, default=1000,
                   help="seed for vanished-class reseeding")
    p.add_argument("--MPI", action="store_true",
                   help="accepted for compatibility; sharding replaces MPI")
    p.add_argument("--EQ", action="store_true",
                   help="accepted for compatibility (EQ variant unused)")
    p.add_argument("--gpu_devices", default="",
                   help="compatibility alias for --devices")
    p.add_argument("--gpu_info", action="store_true",
                   help="print accelerator info and exit (print_gpu_info)")
    p.add_argument("--devices", type=int, default=0,
                   help="number of devices to shard over (0 = all)")
    p.add_argument("--sampler", default="auto",
                   choices=["auto", "template", "matmul", "gather"],
                   help="sampling engine: template = pixel-domain "
                        "template matmul, matmul = tent-matmul, gather = "
                        "exact texture semantics; auto picks by platform "
                        "and geometry (models.steps.select_engine)")
    p.add_argument("--ring_scheme", default="cuda",
                   choices=["cuda", "eman2"],
                   help="polar ring convention: cuda = uniform 256-sample "
                        "rings with linear weights (the reference GPU "
                        "scheme, default); eman2 = variable Numrinit rings "
                        "+ ringwe weights (the EMAN2/SPHIRE CPU convention, "
                        "test_mref_gpu_align.py:741-750) for CPU-exact "
                        "numbers")
    p.add_argument("--resume", action="store_true",
                   help="continue from the checkpoint in outdir")
    p.add_argument("--header_writeback", action="store_true",
                   help="write final params into the input stack headers "
                        "(xform.align2d / assign), like the bdb_cuda CLI")
    if reffree:
        p.add_argument("--nomirror", action="store_true",
                       help="disable the mirrored-orientation search "
                            "channel (CPU-twin semantics, "
                            "test_reffree_gpu_align.py:921)")
        p.add_argument("--dst", type=float, default=0.0,
                       help="discrete-angle delta: every 4th iteration "
                            "(except the last 10) the rotation search is "
                            "restricted to multiples of this angle "
                            "(CPU-twin ali2d_single_iter(delta=dst) "
                            "semantics, test_reffree_gpu_align.py:841-846; "
                            "the GPU reference hard-codes 0)")
        p.add_argument("--Fourvar", action="store_true",
                       help="compute the 2-D Fourier variance of the "
                            "aligned stack each iteration, divide the "
                            "average by it and write varf.hdf (varf2d "
                            "semantics, test_reffree_gpu_align.py:777-831)")
        p.add_argument("--mode", default="F", choices=["F", "H"],
                       help="full or half rings: 'H' searches rotations in "
                            "[0, 180) only (EMAN2 half-ring convention)")
        p.add_argument("--random_method", default="", choices=["", "SHC", "SCF"],
                       help="SHC = stochastic hill climbing (first "
                            "candidate beating the particle's previousmax); "
                            "SCF = self-correlation alignment (rotation "
                            "from the shift-invariant scf, then a 2-D ccf "
                            "translation; forces half rings)")
        p.add_argument("--randomize", action="store_true",
                       help="accepted for compatibility (parsed but never "
                            "read in the reference either, "
                            "test_reffree_gpu_align.py:933)")
        p.add_argument("--orient", action="store_true",
                       help="accepted for compatibility (parsed but never "
                            "read in the reference either, "
                            "test_reffree_gpu_align.py:934)")
    return p


def validate_reffree_flags(args):
    """Fail loudly on flags that are not implemented.

    ``--mode=H``, ``--nomirror``, ``--random_method=SHC/SCF``,
    ``--Fourvar`` and ``--dst`` are all real capability (the
    reference GPU path silently ignores them; its CPU twin ``ali2d_base``
    honors them, test_reffree_gpu_align.py:714,724,777-831,841-846,921).
    The only remaining rejection is the undefined --dst + --random_method
    combination (the CPU twin's delta applies to the standard search
    only).
    """
    problems = []
    if args.dst != 0.0 and args.random_method:
        problems.append("--dst with --random_method (the CPU twin's "
                        "delta only applies to the standard search)")
    if problems:
        print("ERROR: unsupported flag(s) — the reference GPU path ignores "
              "these silently; this rebuild rejects them instead:\n  "
              + "\n  ".join(problems), file=sys.stderr)
        raise SystemExit(2)


def load_ctf_params(args, n: int) -> dict | None:
    """Build the ``ctf_params`` dict for the drivers from --CTF/--ctf_file.

    Returns None when --CTF is off; raises on --CTF without a file or on
    a particle-count mismatch.
    """
    if not args.CTF:
        return None
    if not args.ctf_file:
        print("ERROR: --CTF requires --ctf_file (per-particle defocus)",
              file=sys.stderr)
        raise SystemExit(2)
    path = args.ctf_file
    if path.lower().endswith(".star"):
        from ..io.star import Starfile, parse_ctf_star

        star = Starfile.load(path)
        # angpix=None lets parse_ctf_star derive apix from the file's
        # DetectorPixelSize/Magnification; --apix overrides
        rows = parse_ctf_star(star.df, d=0, angpix=args.apix)
        # parse_ctf_star zero-fills absent columns; a missing DefocusU
        # would silently run an all-zero (nonsense) CTF model
        if "_rlnDefocusU" not in star.df or not np.any(rows[:, 2]):
            print(f"ERROR: {path} has no usable _rlnDefocusU column — "
                  "cannot build a CTF model", file=sys.stderr)
            raise SystemExit(2)
        apix = float(rows[0, 1])
        dfu, dfang = rows[:, 2], rows[:, 4]
        # dfv=0 would mean extreme astigmatism, so an absent DefocusV
        # defaults to dfu
        dfv = rows[:, 3] if "_rlnDefocusV" in star.df else dfu
        voltage = float(rows[0, 5]) or args.voltage
        cs = float(rows[0, 6]) or args.Cs
        w = float(rows[0, 7]) or args.ac
        # per-particle phase shift (Volta phase plates): keep the full
        # column; CtfContext broadcasts it
        phase_shift = rows[:, 8]
    else:
        # ndmin=2 keeps a single-column file as (N, 1), not a row vector
        rows = np.loadtxt(path, dtype=np.float64, ndmin=2)
        apix = args.apix if args.apix is not None else 1.0
        dfu = rows[:, 0]
        dfv = rows[:, 1] if rows.shape[1] > 1 else dfu
        dfang = rows[:, 2] if rows.shape[1] > 2 else np.zeros_like(dfu)
        voltage, cs, w, phase_shift = args.voltage, args.Cs, args.ac, 0.0
    if dfu.shape[0] != n:
        print(f"ERROR: {dfu.shape[0]} CTF rows for {n} particles",
              file=sys.stderr)
        raise SystemExit(2)
    return dict(dfu=dfu, dfv=dfv, dfang=dfang, apix=apix,
                voltage=voltage, cs=cs, w=w, phase_shift=phase_shift)


def print_device_info():
    """``print_gpu_info`` / ``--gpu_info`` equivalent
    (cuda/gpu_aln_common.cu:165)."""
    import jax

    for i, d in enumerate(jax.devices()):
        print(f"device {i}: {d.device_kind} ({d.platform})")


def load_stack(path: str):
    """Read a particle stack by extension: EMAN2-HDF (.hdf), MRC(S)."""
    from ..io.eman_hdf import read_hdf_stack
    from ..io.mrc import read_mrc

    if path.startswith("bdb:"):
        # EMAN2 BDB container (the bdb CLI's input format,
        # test_mref_cheng_yu_bdb_cuda.py:1363-1375) — read through the
        # system libdb; loud conversion guidance if that is unavailable
        from ..io.bdb import read_bdb_stack

        try:
            images, headers = read_bdb_stack(path)
        except FileNotFoundError:
            raise
        except (RuntimeError, ValueError, OSError, KeyError) as e:
            # missing libdb, foreign layout (no maxrec/data_path), or a
            # corrupt btree all get the same actionable guidance
            raise ValueError(
                f"{e}; convert to HDF first, e.g. "
                f"`e2proc2d.py {path} stack.hdf` — then pass stack.hdf"
            ) from e
        return np.asarray(images, np.float32), headers
    ext = os.path.splitext(path)[1].lower()
    if ext in (".hdf", ".h5", ".hdf5"):
        images, headers = read_hdf_stack(path)
        return np.asarray(images, np.float32), headers
    if ext in (".mrc", ".mrcs"):
        data = read_mrc(path)
        if data.ndim == 2:
            data = data[None]
        return np.asarray(data, np.float32), [{} for _ in range(len(data))]
    raise ValueError(f"unsupported stack format: {path}")


def load_mask(path: str | None, nx: int):
    """Optional maskfile positional (the reference loads it with
    ``get_image``, test_mref_gpu_align.py:317-320 /
    test_reffree_gpu_align.py:947): first image of the file, which must
    match the particle box size."""
    if not path:
        return None
    imgs, _ = load_stack(path)
    mask = np.asarray(imgs[0], np.float32)
    if mask.shape != (nx, nx):
        print(f"ERROR: maskfile {path} is {mask.shape}, stack box is "
              f"({nx}, {nx})", file=sys.stderr)
        raise SystemExit(2)
    return mask


def check_outdir(outdir: str):
    """The reference hard-errors when the output directory exists
    (test_mref_gpu_align.py:1344)."""
    if os.path.exists(outdir):
        print(f"ERROR: output directory {outdir} exists", file=sys.stderr)
        raise SystemExit(1)
    os.makedirs(outdir)


def make_mesh_arg(n_devices: int):
    """The --devices mesh: None for one device, else a 'dp' mesh over
    the first ``n_devices`` (0 = all).  Asking for more devices than
    exist is an error, not a smaller run."""
    import jax

    from ..parallel.mesh import make_mesh

    total = len(jax.devices())
    if n_devices <= 0:
        n_devices = total
    if n_devices > total:
        print(f"ERROR: --devices={n_devices} but only {total} "
              f"{jax.devices()[0].platform} device(s) exist",
              file=sys.stderr)
        raise SystemExit(2)
    if n_devices == 1:
        return None
    return make_mesh(n_devices)


def writeback_headers(stack_path: str, table: np.ndarray, assign=None):
    """Final header write-back (``set_params2D`` + ``assign`` attr,
    test_mref_cheng_yu_bdb_cuda.py:155-210) — HDF stacks and ``bdb:``
    containers."""
    updates = []
    for i in range(table.shape[0]):
        upd = {"xform.align2d": {
            "alpha": float(table[i, 0]), "tx": float(table[i, 1]),
            "ty": float(table[i, 2]), "mirror": int(table[i, 3]),
            "scale": 1.0}}
        if assign is not None:
            upd["assign"] = int(assign[i])
        updates.append(upd)
    if stack_path.startswith("bdb:"):
        from ..io.bdb import update_bdb_headers

        update_bdb_headers(stack_path, updates)
        return
    from ..io.eman_hdf import update_headers

    update_headers(stack_path, updates)
