"""Format-drift canary: realistic RELION project layout end to end.

Runs the examples/05 flow on a small project: MRC header round trip,
``index@stack.mrcs`` resolution via LazyImage offsets, optics-derived
apix, per-particle CTF rows (incl. Volta phase shifts) and a CTF-aware
mref alignment.
"""

import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

_spec = importlib.util.spec_from_file_location(
    "relion_ingest_example",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "examples", "05_relion_ingest.py"))
ex = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ex)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("relion"))
    star, mrcs, cls, templates = ex.build_project(outdir, n=24, nx=48, k=2)
    return outdir, star, mrcs, cls


def test_star_stack_round_trip(project):
    outdir, star_path, mrcs_path, _cls = project
    from cryo_ralib_tpu.io.mrc import parse_header, read_mrc
    from cryo_ralib_tpu.io.star import Starfile

    hdr = parse_header(mrcs_path)
    assert hdr.D == 48
    data = read_mrc(mrcs_path)
    star = Starfile.load(star_path)
    via_star = np.stack(star.get_particles(datadir=outdir, lazy=False))
    # the index@file resolution must hit the exact same frames
    np.testing.assert_array_equal(via_star, np.asarray(data, np.float32))
    # the CLI loader path too (it crashed on .mrcs input before r3 —
    # read_mrc returns a bare array, not (data, header))
    from cryo_ralib_tpu.cli.common import load_stack

    cli_data, headers = load_stack(mrcs_path)
    np.testing.assert_array_equal(cli_data, np.asarray(data, np.float32))
    assert len(headers) == 24


def test_optics_apix_and_ctf_rows(project):
    outdir, star_path, _mrcs, _cls = project
    from cryo_ralib_tpu.io.star import Starfile, parse_ctf_star

    star = Starfile.load(star_path)
    rows = parse_ctf_star(star.df, d=48, angpix=None)
    # apix = 1e4 * DetectorPixelSize / Magnification
    assert abs(float(rows[0, 1]) - 1.34) < 1e-3
    assert np.all(rows[:, 2] > 0)            # defocus U present
    assert np.unique(rows[:, 8]).size > 1    # per-particle phase shifts


def test_ingest_and_align(project):
    outdir, star_path, _mrcs, cls = project
    res, apix = ex.ingest_and_align(star_path, outdir, k=2)
    assert abs(apix - 1.34) < 1e-3
    assert res.params.shape == (24, 4)
    assert int(res.class_counts.sum()) == 24
    assert np.all(np.isfinite(res.params))
