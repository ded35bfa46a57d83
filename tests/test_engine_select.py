"""The one "auto" engine choice (``models.steps.select_engine``) and the
device plumbing that must not hide the device: memory budget, mesh
size, compile cache.

The GPU branch is reached here by passing ``platform="gpu"`` or by
patching ``jax.default_backend``; the chosen engines themselves run on
the CPU."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu import AlignConfig, AlignParams
from cryo_ralib_tpu.models import steps
from cryo_ralib_tpu.models.steps import select_engine
from cryo_ralib_tpu.ops.template_search import template_supported
from cryo_ralib_tpu.parallel.mesh import make_mesh, make_mesh_2d

NX = 64


def _cfg(**kw):
    base = dict(img_dim=NX, ring_num=20, ring_len=256, shift_step=1.0,
                shift_rng_x=2.0, shift_rng_y=2.0)
    base.update(kw)
    return AlignConfig(**base)


# configs on each side of the template engine's geometry gate
BASE = dict(img_dim=NX, ring_num=20, shift_step=1.0, shift_rng_x=2.0,
            shift_rng_y=2.0)
CONFIGS = {
    "in_gate": dict(ring_len=256),
    "out_gate": dict(ring_len=256, ring_num=29),  # window overflows 64 px
    "eman2_in_gate": dict(ring_scheme="eman2"),
    "eman2_out_gate": dict(ring_scheme="eman2", ring_num=29),
    "half_rings": dict(ring_len=256, mode="H"),
}


def _build(name):
    return AlignConfig(**{**BASE, **CONFIGS[name]})


def _mesh(name):
    return {"none": None, "dp": make_mesh(2),
            "dp_ref": make_mesh_2d(2, 2)}[name]


def test_gate_configs_sit_where_named():
    for name in CONFIGS:
        cfg = _build(name)
        want = "out_gate" not in name
        assert template_supported(cfg, 3) is want, name


@pytest.mark.parametrize("platform,mode,config,mesh,want", [
    # CPU: the exact-semantics gather engine for every step mode
    ("cpu", "standard", "in_gate", "none", "gather"),
    ("cpu", "standard", "in_gate", "dp", "gather"),
    ("cpu", "standard", "eman2_in_gate", "none", "gather"),
    ("cpu", "shc", "in_gate", "none", "gather"),
    ("cpu", "scf", "half_rings", "none", "gather"),
    # GPU: the measured preference, filtered by the template gates
    ("gpu", "standard", "in_gate", "none", "template"),
    ("gpu", "standard", "out_gate", "none", "gather"),
    ("gpu", "standard", "in_gate", "dp", "template"),
    ("gpu", "standard", "in_gate", "dp_ref", "gather"),
    ("gpu", "standard", "eman2_in_gate", "none", "template"),
    ("gpu", "standard", "eman2_out_gate", "none", "gather"),
    ("gpu", "shc", "in_gate", "none", "template"),
    ("gpu", "shc", "out_gate", "none", "gather"),
    ("gpu", "shc", "in_gate", "dp_ref", "gather"),
    ("gpu", "scf", "half_rings", "none", "gather"),
    ("gpu", "scf", "half_rings", "dp", "gather"),
])
def test_select_engine(platform, mode, config, mesh, want):
    assert select_engine(_build(config), 3, mode=mode, platform=platform,
                         mesh=_mesh(mesh)) == want


@pytest.mark.parametrize("platform,want", [("cpu", "quadri"),
                                           ("gpu", "quadri")])
def test_select_transform_engine(platform, want):
    assert select_engine(mode="transform", platform=platform) == want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_select_engine_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="platform"):
        select_engine(_cfg(), 3, platform=platform)


def test_select_engine_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        select_engine(_cfg(), 3, mode="bogus", platform="gpu")


@pytest.fixture
def on_gpu(monkeypatch):
    """Route the default-platform lookups through the GPU branch."""
    monkeypatch.setattr(steps.jax, "default_backend", lambda: "gpu")


def _batch(n=6, k=3, seed=0):
    from tests.conftest import make_disc_stack

    r = np.random.default_rng(seed)
    return make_disc_stack(r, n, NX), make_disc_stack(r, k, NX)


def test_step_auto_on_gpu_builds_template(on_gpu):
    """make_align_step(sampler='auto') resolves through the selector: on
    the GPU branch it hoists the template engine's splat spectra, and the
    step runs (here on the CPU) with every particle counted."""
    stack, refs = _batch()
    step = steps.make_align_step(_cfg(), 3, donate=False)
    assert isinstance(step, steps._SfStep)
    n = stack.shape[0]
    out = step(jnp.asarray(stack), jnp.asarray(refs), AlignParams.zeros(n),
               jnp.arange(n, dtype=jnp.int32), jnp.ones((n,), jnp.float32))
    assert int(np.asarray(out.counts).sum()) == n


def test_step_auto_on_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(steps.jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="platform"):
        steps.make_align_step(_cfg(), 3)


def test_device_loop_auto_on_gpu(on_gpu):
    from cryo_ralib_tpu.models.device_loop import _loop_sampler

    assert _loop_sampler(_cfg(), 1, "auto", None) == "template"
    assert _loop_sampler(_cfg(ring_num=29), 1, "auto", None) == "gather"
    with pytest.raises(ValueError, match="device-loop"):
        _loop_sampler(_cfg(), 1, "bogus", None)


@pytest.mark.parametrize("platform,random_method,cfg_kw,want", [
    ("gpu", "", {}, "template"),
    ("gpu", "", dict(ring_num=29), "matmul"),
    ("gpu", "SCF", dict(mode="H"), "matmul"),
    ("cpu", "", {}, "matmul"),
])
def test_planner_charges_selected_engine(monkeypatch, platform,
                                         random_method, cfg_kw, want):
    """The batch planner sizes batches for the engine the step resolves
    to (gather is charged the tent-matmul footprint)."""
    from cryo_ralib_tpu.models import engine as engine_mod

    monkeypatch.setattr(steps.jax, "default_backend", lambda: platform)
    seen = {}

    def plan(n, n_refs, cfg, **kw):
        seen["sampler"] = kw["sampler"]
        return n

    monkeypatch.setattr(engine_mod, "plan_batch_size", plan)
    k = 1 if random_method else 3
    engine_mod.AlignmentEngine(np.zeros((4, NX, NX), np.float32),
                               _cfg(**cfg_kw), k,
                               random_method=random_method)
    assert seen["sampler"] == want


def test_rot_shift2d_auto_on_gpu_is_quadri(on_gpu):
    from cryo_ralib_tpu.ops.transform import rot_shift2d

    stack, _ = _batch(n=3)
    r = np.random.default_rng(1)
    args = (jnp.asarray(stack),
            jnp.asarray(r.uniform(0, 360, 3).astype(np.float32)),
            jnp.asarray(r.uniform(-2, 2, 3).astype(np.float32)),
            jnp.asarray(r.uniform(-2, 2, 3).astype(np.float32)))
    np.testing.assert_array_equal(
        np.asarray(rot_shift2d(*args)),
        np.asarray(rot_shift2d(*args, engine="quadri")))
    # a scale only the quadri engine implements
    scale = jnp.full((3,), 1.1, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(rot_shift2d(*args, scale=scale)),
        np.asarray(rot_shift2d(*args, scale=scale, engine="quadri")))


# ---------------------------------------------------------------------------
# no fallback that hides the device
# ---------------------------------------------------------------------------

class _StubDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = "stub accelerator"
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_device_memory_without_limit_raises(stats):
    from cryo_ralib_tpu.parallel.batching import device_memory_bytes

    with pytest.raises(RuntimeError, match="no memory limit"):
        device_memory_bytes(_StubDevice("gpu", stats))


def test_device_memory_reports_limit_and_cpu_budget():
    from cryo_ralib_tpu.parallel.batching import (CPU_PLAN_BYTES,
                                                  device_memory_bytes)

    assert device_memory_bytes(
        _StubDevice("gpu", {"bytes_limit": 60 << 30})) == 60 << 30
    assert device_memory_bytes(jax.devices("cpu")[0]) == CPU_PLAN_BYTES


def test_make_mesh_arg_too_many_devices_errors(capsys):
    from cryo_ralib_tpu.cli.common import make_mesh_arg

    total = len(jax.devices())
    with pytest.raises(SystemExit):
        make_mesh_arg(total + 1)
    assert "only" in capsys.readouterr().err
    assert make_mesh_arg(1) is None
    assert make_mesh_arg(2).shape["dp"] == 2


def test_check_mesh_too_many_devices_fails(capsys):
    from cryo_ralib_tpu.cli import check

    assert check.main(["--mesh", str(len(jax.devices()) + 1)]) == 1
    assert "[FAIL] mesh" in capsys.readouterr().out


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    from cryo_ralib_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from cryo_ralib_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_mesh_engine_compiles_its_step_once():
    """The resident engine places its initial params as the sharded step
    returns them, so the second iteration reuses the first compilation
    (a fresh unsharded params pytree would recompile once)."""
    from cryo_ralib_tpu.models.engine import AlignmentEngine

    stack, refs = _batch(n=8)
    eng = AlignmentEngine(stack, _cfg(), 3, mesh=make_mesh(4),
                          sampler="gather")
    for _ in range(2):
        eng.iterate(refs)
    assert eng._step._cache_size() == 1
