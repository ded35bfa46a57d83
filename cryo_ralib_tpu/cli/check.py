"""Environment checker.

Parity with the reference's ``lib_check.py`` (SPHIRE import / pydusa MPI
init / nvcc presence, run by install.sh:21): verifies the JAX install,
accelerator visibility, the matmul-DFT compute path, sharding on a
virtual mesh, optional deps (h5py, matplotlib, sklearn) and the native
I/O library.

Usage: python -m cryo_ralib_tpu.cli.check [--mesh N]
"""

from __future__ import annotations

import argparse


def _ok(name, detail=""):
    print(f"  [ok]   {name}" + (f" — {detail}" if detail else ""))


def _fail(name, detail=""):
    print(f"  [FAIL] {name}" + (f" — {detail}" if detail else ""))


def main(argv=None):
    p = argparse.ArgumentParser(prog="cryo-ralib-check")
    p.add_argument("--mesh", type=int, default=0,
                   help="also run a sharded step over an N-device mesh")
    args = p.parse_args(argv)
    failures = 0

    print("cryo_ralib_tpu environment check")
    try:
        import numpy as np
        _ok("numpy", np.__version__)
    except ImportError as e:
        _fail("numpy", str(e)); failures += 1
        return 1

    try:
        import jax

        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        devs = jax.devices()
        _ok("jax", f"{jax.__version__}; devices: "
            + ", ".join(f"{d.device_kind}({d.platform})" for d in devs))
    except Exception as e:  # noqa: BLE001
        _fail("jax", str(e)); failures += 1
        return 1

    # matmul-DFT path (ops/dft.py: the transforms the search runs)
    try:
        import jax.numpy as jnp

        from ..ops.dft import rfft_mm

        x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
        got = np.asarray(jnp.real(rfft_mm(jnp.asarray(x))))
        want = np.real(np.fft.rfft(x, axis=-1))
        assert np.allclose(got, want, atol=1e-3), "DFT mismatch"
        _ok("matmul-DFT compute path")
    except Exception as e:  # noqa: BLE001
        _fail("matmul-DFT compute path", str(e)); failures += 1

    try:
        import h5py
        _ok("h5py (EMAN2-HDF I/O)", h5py.__version__)
    except ImportError:
        _fail("h5py (EMAN2-HDF I/O)", "missing — .hdf stacks unavailable")
        failures += 1

    from .. import native
    if native.available():
        _ok("native I/O library", "libcryoralib_io.so")
    else:
        print("  [--]   native I/O library not built (numpy fallback active)")

    for mod, what in [("matplotlib", "plots"), ("sklearn", "EDA extras")]:
        try:
            __import__(mod)
            _ok(f"{mod} ({what})")
        except ImportError:
            print(f"  [--]   {mod} ({what}) not installed — optional")

    try:
        from ..config import AlignConfig
        from ..models.steps import align_step
        from ..params import AlignParams

        import jax.numpy as jnp
        cfg = AlignConfig(img_dim=32, ring_num=10, ring_len=32,
                          shift_step=1.0, shift_rng_x=1.0, shift_rng_y=1.0)
        rng = np.random.default_rng(0)
        out = align_step(jnp.asarray(rng.standard_normal((4, 32, 32)),
                                     jnp.float32),
                         jnp.asarray(rng.standard_normal((2, 32, 32)),
                                     jnp.float32),
                         AlignParams.zeros(4), jnp.arange(4), jnp.ones(4),
                         cfg=cfg, n_classes=2)
        assert int(np.asarray(out.counts).sum()) == 4
        _ok("alignment step (single device)")
    except Exception as e:  # noqa: BLE001
        _fail("alignment step", repr(e)); failures += 1

    if args.mesh:
        devs = jax.devices()
        if len(devs) < args.mesh:
            _fail("mesh", f"--mesh {args.mesh} needs {args.mesh} devices, "
                  f"{len(devs)} {devs[0].platform} device(s) exist")
            failures += 1
        else:
            from ..parallel.mesh import make_mesh

            make_mesh(args.mesh, devices=devs)
            _ok(f"{args.mesh}-device mesh constructible")

    print("all checks passed" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
