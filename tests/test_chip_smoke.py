"""chip_smoke.py and bench.py on a machine without a GPU: both refuse to
run, and the smoke test's comparison functions hold on small inputs."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0, proc.stdout
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    proc = _run([script], REPO)
    _no_result(proc)
    assert "GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _no_result(_run(["chip_smoke.py"], str(tmp_path)))


def _params(n=6, seed=0):
    r = np.random.default_rng(seed)
    return {"angle": r.uniform(0, 360, n), "shift_x": r.integers(-2, 3, n),
            "shift_y": r.integers(-2, 3, n), "mirror": r.integers(0, 2, n),
            "ref_id": r.integers(0, 4, n)}


def test_compare_params_identical_and_wrapped():
    p = _params()
    assert cs.compare_params(p, p)["ok"]
    q = dict(p, angle=(p["angle"] + 359.8) % 360.0)   # -0.2 deg, wrapped
    c = cs.compare_params(q, p)
    assert c["ok"] and c["max_dangle_deg"] == pytest.approx(0.2)


@pytest.mark.parametrize("field,delta,key", [
    ("angle", 0.6, "max_dangle_deg"),
    ("shift_x", 1, "max_dshift_px"),
])
def test_compare_params_flags_angle_and_shift(field, delta, key):
    p = _params()
    q = dict(p, **{field: p[field] + np.where(np.arange(6) == 2, delta, 0)})
    c = cs.compare_params(q, p)
    assert not c["ok"] and c[key] > 0 and c["mismatch"] == []


@pytest.mark.parametrize("field", ["mirror", "ref_id"])
def test_compare_params_lists_class_mirror_mismatch(field):
    p = _params()
    q = dict(p, **{field: p[field] + np.where(np.arange(6) == 2, 1, 0)})
    # angles and shifts of a mismatched particle are not compared
    q["angle"] = q["angle"] + np.where(np.arange(6) == 2, 90.0, 0.0)
    c = cs.compare_params(q, p)
    assert c["ok"] and c["mismatch"] == [2]


def _tie_scores(p, i, margin):
    """(2, 4) oracle pick scores whose best is p's pick for particle i,
    with every other pick ``margin`` (relative) below it."""
    scores = np.full((2, 4), 100.0 * (1.0 - margin))
    scores[p["mirror"][i], p["ref_id"][i]] = 100.0
    return scores


@pytest.mark.parametrize("margin,ok", [(2e-4, True), (5e-3, False)])
def test_parity_accepts_only_near_ties(margin, ok):
    p = _params(n=200)
    q = {k: v.copy() for k, v in p.items()}
    q["mirror"][7] = 1 - q["mirror"][7]
    scores = {7: _tie_scores(p, 7, margin)}
    c = cs.parity("test", q, p, scores)
    assert c["ok"] is ok
    assert (c["near_ties"], c["untied"]) == ((1, []) if ok else (0, [7]))


def test_parity_bounds_the_share_of_ties():
    p = _params(n=20)
    q = {k: v.copy() for k, v in p.items()}
    q["mirror"][:2] = 1 - q["mirror"][:2]
    scores = {i: _tie_scores(p, i, 1e-5) for i in range(2)}
    c = cs.parity("test", q, p, scores)       # 10% of particles tie-swap
    assert c["near_ties"] == 2 and not c["ok"]
    assert cs.parity("test", q, p, scores, max_tie_share=0.1)["ok"]
    # one tie is always allowed, however few the particles
    q["mirror"][1] = p["mirror"][1]
    assert cs.parity("test", q, p, scores)["ok"]


def test_oracle_scores_match_align_particle():
    from cryo_ralib_tpu import AlignConfig
    from cryo_ralib_tpu.utils import oracle
    from cryo_ralib_tpu.utils.synthetic import asymmetric_templates

    cfg = AlignConfig(img_dim=32, ring_num=10, ring_len=32, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    refs = asymmetric_templates(2, 32).astype(np.float64)
    img = np.roll(refs[1], 1, axis=0)
    args = (cfg.polar_coords, cfg.ring_weights, cfg.shifts)
    dec, scores = oracle.align_particle_scores_np(img, refs, *args,
                                                  cfg.shift_limit)
    assert dec == oracle.align_particle_np(img, refs, *args, 0.0, 0.0,
                                           cfg.shift_limit)
    assert scores.shape == (2, 2)
    assert scores[dec["mirror"], dec["ref_id"]] == scores.max()
    got = cs.oracle_align(img[None], refs, cfg, [0])
    assert got[0][0] == dec


def test_class_recovery_up_to_relabelling():
    truth = np.array([0, 0, 1, 1, 2, 2, 2, 3])
    perm = np.array([2, 3, 0, 1])[truth]
    assert cs.class_recovery(perm, truth, 4) == 1.0
    bad = perm.copy()
    bad[0] = perm[2]
    assert cs.class_recovery(bad, truth, 4) == pytest.approx(7 / 8)


def test_relative_diff():
    a = np.array([[1.0, -4.0], [2.0, 0.0]])
    assert cs.relative_diff(a, a) == 0.0
    assert cs.relative_diff(a + 0.04, a) == pytest.approx(0.01)


def test_iter_clock_marks_iterations():
    clock = cs.IterClock("ITERATION #")
    for msg in ("start", "ITERATION #  1", "group", "ITERATION #  2"):
        clock.add(msg)
    its = clock.iteration_seconds()
    assert len(its) == 2 and all(t >= 0 for t in its)


def test_smoke_stack_recovers_on_cpu():
    """The phase-3 data recipe, tiny: mirrored, noisy poses of the K
    asymmetric templates; the mref driver started from the generating
    templates puts every particle in its class."""
    from cryo_ralib_tpu.models.mref import mref_ali2d_tpu
    from cryo_ralib_tpu.utils.synthetic import asymmetric_templates, pose_stack

    k, nx, n = 3, 48, 24
    templates = asymmetric_templates(k, nx)
    stack = pose_stack(templates, n, max_shift=cs.MAX_SHIFT, noise=cs.NOISE,
                       seed=2, mirror=True)
    assert 0 < stack.mirrors.sum() < n
    clock = cs.IterClock("ITERATION #")
    res = mref_ali2d_tpu(stack.images, templates.copy(), ou=18, xr=2.0,
                         yr=2.0, ts=1.0, maxit=2, log=clock)
    assert len(clock.iteration_seconds()) == 2
    assert cs.class_recovery(res.assignments, stack.class_ids, k) == 1.0


def test_pose_stack_without_mirror_keeps_scattered_draws():
    from cryo_ralib_tpu.utils.synthetic import (class_templates, pose_stack,
                                                scattered_stack)

    t = class_templates(2, 32)
    a = scattered_stack(t, 5, seed=3)
    b = pose_stack(t, 5, seed=3)
    assert len(a) == 4 and not b.mirrors.any()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_bench_rows_run_on_cpu():
    """bench.py's row functions (tiny shapes): a rate and the engine the
    selector names for the device's platform."""
    import jax

    import bench
    from cryo_ralib_tpu import AlignConfig

    cpu = jax.devices("cpu")[0]
    cfg = AlignConfig(img_dim=32, ring_num=10, ring_len=32, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    pps, engine = bench.step_pps(cpu, 4, k=2, cfg=cfg)
    assert pps > 0 and engine == "gather"
    pps, engine = bench.sustained_pps(cpu, 4, n_iter=1, k=2, cfg=cfg)
    assert pps > 0 and engine == "gather"
