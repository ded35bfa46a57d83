"""EMAN2 BDB container I/O: real libdb round trips + CLI ingest.

Closes the last P6 gap: ``bdb:`` stacks are read
directly (cryo_ralib_tpu/io/bdb.py binds the system libdb through the
DB 1.85 compat API) instead of erroring with conversion guidance.
Fixtures are written with the same libdb, so the btree format under
test is the real one.
"""

import os

import numpy as np
import pytest

from cryo_ralib_tpu.io import bdb

pytestmark = pytest.mark.skipif(bdb._load_libdb() is None,
                                reason="no libdb with DB 1.85 API")


def _spec(tmp_path, name="stack"):
    return f"bdb:{tmp_path}#{name}"


def test_parse_bdb_path(tmp_path):
    d, f = bdb.parse_bdb_path("bdb:proj/particles#stack")
    assert d == os.path.join("proj/particles", "EMAN2DB")
    assert f.endswith("stack.bdb")
    d2, f2 = bdb.parse_bdb_path("bdb:stack")
    assert d2 == os.path.join(".", "EMAN2DB")


def test_bdb_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((6, 16, 16)).astype(np.float32)
    spec = _spec(tmp_path)
    bdb.write_bdb_stack(spec, imgs, headers=[{"apix_x": 1.5}] * 6)
    got, headers = bdb.read_bdb_stack(spec)
    np.testing.assert_array_equal(got, imgs)
    assert headers[0]["apix_x"] == 1.5
    assert headers[3]["data_n"] == 3
    # the side file uses the EMAN2 naming convention
    assert os.path.exists(tmp_path / "EMAN2DB" / "stack_16x16x1")


def test_bdb_header_writeback(tmp_path):
    imgs = np.zeros((3, 8, 8), np.float32)
    spec = _spec(tmp_path)
    bdb.write_bdb_stack(spec, imgs)
    bdb.update_bdb_headers(spec, [
        {"xform.align2d": {"alpha": 10.0 * i}, "assign": i}
        for i in range(3)])
    _got, headers = bdb.read_bdb_stack(spec)
    assert headers[2]["assign"] == 2
    assert headers[1]["xform.align2d"]["alpha"] == 10.0


def test_bdb_foreign_generation_keys(tmp_path):
    """Containers written by real EMAN2 use key pickles this module never
    emits: py2-era EMAN2 stores str keys as protocol-2 SHORT_BINSTRING,
    py3 EMAN2 uses ``dumps(key, -1)`` (protocol >= 4).  Reads and header
    write-back must decode keys rather than byte-match re-pickled ones."""
    import pickle

    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((3, 8, 8)).astype(np.float32)
    spec = _spec(tmp_path, "py2like")
    dbdir, dbfile = bdb.parse_bdb_path(spec)
    os.makedirs(dbdir, exist_ok=True)
    side = "py2like_8x8x1"
    with open(os.path.join(dbdir, side), "wb") as f:
        f.write(np.ascontiguousarray(imgs, "<f4").tobytes())

    # py2 cPickle protocol-2 encoding of the str 'maxrec':
    # PROTO 2, SHORT_BINSTRING len=6 'maxrec', BINPUT 0, STOP
    py2_maxrec_key = b"\x80\x02U\x06maxrecq\x00."
    assert pickle.loads(py2_maxrec_key, encoding="latin1") == "maxrec"

    with bdb.Db185(dbfile, create=True) as db:
        for i in range(3):
            hdr = {"nx": 8, "ny": 8, "nz": 1, "data_path": side,
                   "data_n": i, "apix_x": 1.2}
            # py3 EMAN2 generation: dumps(key, -1) -> protocol >= 4
            db.put(pickle.dumps(i, 4), pickle.dumps(hdr, 4))
        db.put(py2_maxrec_key, pickle.dumps(2, 4))

    got, headers = bdb.read_bdb_stack(spec)
    np.testing.assert_array_equal(got, imgs)
    assert headers[1]["apix_x"] == 1.2

    # write-back must update the EXISTING protocol-4 records in place,
    # not insert duplicates under protocol-2 keys
    bdb.update_bdb_headers(spec, [{"assign": i} for i in range(3)])
    with bdb.Db185(dbfile) as db:
        n_keys = sum(1 for _ in db.items())
    assert n_keys == 4  # 3 image records + maxrec, no duplicates
    _got, headers = bdb.read_bdb_stack(spec)
    assert [h["assign"] for h in headers] == [0, 1, 2]


def test_load_stack_accepts_bdb(tmp_path):
    from cryo_ralib_tpu.cli.common import load_stack

    imgs = np.random.default_rng(0).standard_normal((4, 12, 12)).astype(
        np.float32)
    spec = _spec(tmp_path)
    bdb.write_bdb_stack(spec, imgs)
    got, headers = load_stack(spec)
    np.testing.assert_array_equal(got, imgs)
    assert len(headers) == 4


def test_bdb_to_hdf_converter(tmp_path):
    import tools.bdb_to_hdf as conv
    from cryo_ralib_tpu.io.eman_hdf import read_hdf_stack

    imgs = np.random.default_rng(1).standard_normal((5, 10, 10)).astype(
        np.float32)
    spec = _spec(tmp_path)
    bdb.write_bdb_stack(spec, imgs, headers=[{"ctf_defocus": 2.1}] * 5)
    dst = str(tmp_path / "out.hdf")
    assert conv.main([spec, dst]) == 0
    got, headers = read_hdf_stack(dst)
    np.testing.assert_allclose(np.asarray(got), imgs, atol=0)
    assert "data_path" not in headers[0]


def test_reffree_cli_on_bdb_stack(tmp_path):
    """End-to-end: bdb: input through the reffree CLI with write-back."""
    from cryo_ralib_tpu.cli import reffree as cli_reffree

    rng = np.random.default_rng(9)
    nx = 32
    base = np.zeros((nx, nx), np.float32)
    base[10:22, 14:18] = 1.0
    imgs = np.stack([base + 0.05 * rng.standard_normal((nx, nx))
                     for _ in range(8)]).astype(np.float32)
    spec = _spec(tmp_path, "parts")
    bdb.write_bdb_stack(spec, imgs)
    outdir = str(tmp_path / "out")
    rc = cli_reffree.main([spec, outdir, "--ou=12", "--xr=1", "--ts=1",
                           "--maxit=2", "--sampler=gather",
                           "--function=ref_ali2d_no_filter",
                           "--header_writeback"])
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "initial2Dparams.txt"))
    _got, headers = bdb.read_bdb_stack(spec)
    assert "xform.align2d" in headers[0]
