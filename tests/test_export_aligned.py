"""Notebook-00 closing glue (examples/08): params table -> aligned stack
export + class-average reconstruction."""

import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

_spec = importlib.util.spec_from_file_location(
    "export_aligned_example",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "examples", "08_export_aligned.py"))
ex = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ex)


def test_load_params_formats(tmp_path):
    # 4-column driver format (alpha sx sy mirror)
    p4 = tmp_path / "p4.txt"
    np.savetxt(p4, np.asarray([[10.0, 1.0, -1.0, 0], [350.0, 0.0, 2.0, 1]]))
    a, sx, sy, m, cls = ex.load_params(str(p4))
    assert cls is None and m.dtype == np.int32
    np.testing.assert_allclose(a, [10.0, 350.0])
    # 6-column EDA format (idx angle_psi sx sy mirror class)
    p6 = tmp_path / "p6.txt"
    np.savetxt(p6, np.asarray([[0, 10.0, 1.0, -1.0, 0, 2],
                               [1, 350.0, 0.0, 2.0, 1, 0]]))
    a, sx, sy, m, cls = ex.load_params(str(p6))
    np.testing.assert_array_equal(cls, [2, 0])
    np.testing.assert_allclose(sx, [1.0, 0.0])
    with pytest.raises(SystemExit, match="columns"):
        p2 = tmp_path / "p2.txt"
        np.savetxt(p2, np.asarray([[1.0, 2.0]]))
        ex.load_params(str(p2))


def test_export_aligned_round_trip(tmp_path):
    """Undoing the generating transforms must reconstruct the class
    templates, and the exported stack must read back with zeroed
    ``xform.align2d`` headers + ``assign`` attrs (the sxheader-zeroed
    aligned-stack contract of notebook 00)."""
    from cryo_ralib_tpu.io.eman_hdf import read_hdf_stack
    from cryo_ralib_tpu.utils.synthetic import class_templates, scattered_stack

    nx, n, k = 48, 32, 2
    refs = class_templates(k, nx)
    imgs, cls, angs, shifts = scattered_stack(refs, n, max_shift=0, seed=4)
    # header-convention inverse of a pure rotation: alpha = 360 - ang
    alpha = (360.0 - angs) % 360.0
    zero = np.zeros(n, np.float32)
    outdir = str(tmp_path / "exp")
    stack_path, avg_path, aligned = ex.export_aligned(
        imgs.astype(np.float32), alpha, zero, zero,
        np.zeros(n, np.int32), cls.astype(np.int32), outdir)
    back, headers = read_hdf_stack(stack_path)
    np.testing.assert_allclose(back, aligned, atol=1e-6)
    import json

    # dict attrs round-trip as JSON strings (io/eman_hdf._encode_attr)
    xf = json.loads(headers[0]["xform.align2d"])
    assert float(xf["alpha"]) == 0.0 and int(xf["mirror"]) == 0
    assert [int(h["assign"]) for h in headers] == list(cls)
    avgs, avg_headers = read_hdf_stack(avg_path)
    assert avgs.shape == (k, nx, nx)
    counts = np.asarray([int(h["members"]) for h in avg_headers])
    np.testing.assert_array_equal(counts, np.bincount(cls, minlength=k))
    # de-rotated averages reconstruct the templates (interior mask: the
    # transform's edge background differs from the clean template)
    yy, xx = np.mgrid[0:nx, 0:nx]
    mask = (yy - nx // 2) ** 2 + (xx - nx // 2) ** 2 <= (nx // 2 - 4) ** 2
    for j in range(k):
        err = np.abs((avgs[j] - refs[j]) * mask).mean()
        assert err < 0.05, (j, err)
