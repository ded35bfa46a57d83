"""Jitted per-iteration alignment steps.

Each step fuses the reference's per-GPU-batch sequence — polar resample
over the shift grid, ring-FFT ccf with mirror, argmax + decode, transform,
even/odd class sums (``mref_align_run`` + ``kernel_sum_oe``,
cuda/gpu_aln_noref.cu:389-416 + test_mref_gpu_align.py:48-80) — into one
XLA program.  Under a sharded-input jit the particle axis is data-parallel
across the mesh and the (K, 2, H, W) class sums / counts come out
replicated (XLA inserts the all-reduce, which NCCL runs over NVLink — the
counterpart of the reference's ``reduce_EMData_to_root`` +
``bcast_EMData_to_all``, SURVEY.md §2.3).

``select_engine`` is the one place that resolves ``sampler="auto"``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..params import AlignParams, gpu_params_to_align2d
from ..ops.classavg import class_sum_oe, class_sum_transform_mm
from ..ops.search import (decode_params, prepare_ref_spectra,
                          rotational_shift_search, rotational_shift_search_mm,
                          rotational_shift_search_shc)
from ..ops.transform import transform_batch


class StepOutput(NamedTuple):
    params: AlignParams
    class_sums: jax.Array   # (K, 2, H, W)
    counts: jax.Array       # (K,) int32
    peak: jax.Array         # (N,) best ccf value (diagnostic)
    sx_sum: jax.Array       # () mirror-aware sum of header x-shifts
    sy_sum: jax.Array       # () sum of header y-shifts


def _header_shift_sums(params: AlignParams, valid):
    """Average-centering accumulators: decoded header shifts summed with the
    mirror-aware x sign (test_reffree_gpu_align.py:500-517)."""
    sx, sy = gpu_params_to_align2d(params.angle, params.shift_x, params.shift_y)
    sgn = jnp.where(params.mirror == 1, -1.0, 1.0)
    if valid is not None:
        sgn = sgn * valid
        sy = sy * valid
    return jnp.sum(sx * sgn), jnp.sum(sy)


def _template_admitted(cfg: AlignConfig, n_classes: int, mesh) -> bool:
    """The template engine's gates: its geometry (``template_supported``)
    and no 'ref' mesh axis — its k-inner column order would force
    all-gathers of the template blocks on a reference-sharded mesh."""
    from ..ops.template_search import template_supported

    if mesh is not None and "ref" in mesh.axis_names:
        return False
    return template_supported(cfg, n_classes)


# "auto" engine preference, fastest first, per platform and step mode.
# The first admitted entry wins; the last entry of every list is always
# admitted.  CPU runs the exact-semantics gather engine (and the quadri
# transform) everywhere.  The GPU orders follow the engine-timing phase
# of chip_smoke.py at the rib80s geometry (90 px, K=8, xr=yr=3, ts=1,
# ou=36, mirror; 8192 particles) on an NVIDIA H100 80GB HBM3 at 700 W:
# standard step template 65.5k > gather 37.1k > matmul 25.2k
# particles/s; SCF gather 500k > matmul 138k; rot_shift2d quadri 3.08M >
# shear 432k images/s; SHC (K=1, a 400 W card) template 319k > gather
# 42.3k > matmul 25.4k.  The tent-matmul engine wins no GPU mode.
_PREFERENCE = {
    "cpu": {"standard": ("gather",), "shc": ("gather",),
            "scf": ("gather",), "transform": ("quadri",)},
    "gpu": {"standard": ("template", "gather"),
            "shc": ("template", "gather"),
            "scf": ("gather",), "transform": ("quadri",)},
}


def select_engine(cfg: AlignConfig | None = None, n_classes: int = 1, *,
                  mode: str = "standard", platform: str | None = None,
                  mesh=None) -> str:
    """The single "auto" engine choice of every step, loop, planner and
    transform.

    Args:
      cfg, n_classes: the search geometry; the template engine is picked
        only where ``template_supported(cfg, n_classes)`` admits it (and
        no 'ref' mesh axis exists).  Unused for ``mode="transform"``.
      mode: "standard" (mref/reffree steps, device loops, the --dst
        variant and the eman2 ring scheme), "shc", "scf", or
        "transform" (``rot_shift2d``: "shear" or "quadri").
      platform: "cpu" or "gpu"; default ``jax.default_backend()``.  Any
        other platform raises.
      mesh: the step's mesh, if any.

    Returns the engine name: "template", "matmul" or "gather" (or
    "shear"/"quadri" for ``mode="transform"``).
    """
    if platform is None:
        platform = jax.default_backend()
    if platform not in _PREFERENCE:
        raise ValueError(f"no engine choice for platform {platform!r} "
                         f"(supported: {', '.join(_PREFERENCE)})")
    if mode not in _PREFERENCE[platform]:
        raise ValueError(f"unknown step mode {mode!r}")
    for engine in _PREFERENCE[platform][mode]:
        if engine != "template" or _template_admitted(cfg, n_classes, mesh):
            return engine
    raise AssertionError("unreachable: every preference list ends with an "
                         "always-admitted engine")


def _check_sampler(sampler: str, cfg: AlignConfig, n_classes: int,
                   allowed: tuple, what: str) -> None:
    """Reject unknown engines and a forced template outside its gate —
    an accepted sampler either has the engine's exact semantics or
    errors."""
    if sampler not in allowed:
        raise ValueError(f"sampler={sampler!r} is not a {what} engine "
                         f"(use auto or one of {', '.join(allowed)})")
    if sampler == "template":
        from ..ops.template_search import template_supported

        if not template_supported(cfg, n_classes):
            raise ValueError(
                "sampler='template' forced on a config outside the "
                "template engine's geometry gate (ops.template_search."
                "template_supported) — use sampler='auto'")


_ENGINES = ("template", "matmul", "gather")


def _class_sums(images, params, n_classes, global_index, valid, sampler,
                fast):
    """Transform + even/odd class sums.  The tent/template engines use the
    fused FFT-shear transform + one-hot sums (the transformed stack never
    reaches device memory); gather keeps the bilinear texture transform."""
    if sampler in ("matmul", "template"):
        return class_sum_transform_mm(images, params, n_classes,
                                      global_index=global_index,
                                      valid=valid, fast=fast)
    transformed = transform_batch(images, params)
    return class_sum_oe(transformed, params.ref_id, n_classes,
                        global_index=global_index, valid=valid)


def align_step(images, refs, params: AlignParams, global_index, valid,
               cfg: AlignConfig, *, n_classes: int, shift_chunk: int = 8,
               update_ref: bool = True, sampler: str = "auto",
               fast: bool = True, axis_name: str | None = None,
               angle_mask=None, sf=None) -> StepOutput:
    """One alignment iteration over one resident batch (trace-level fn).

    Args:
      images: (N, H, W) preprocessed particles.
      refs:   (K, H, W) current references.
      params: AlignParams carried across iterations (shifts accumulate).
      global_index: (N,) int32 global particle ids (even/odd parity).
      valid:  (N,) float 0/1 padding mask (or None).
      cfg:    static AlignConfig.
      n_classes: static K (must equal refs.shape[0]).
      update_ref: False for the single-reference (reffree) path.
      sampler: "template" = brute-force template matmul
        (ops/template_search.py; one bf16 dot_general per column chunk),
        "matmul" = gather-free tent-matmul XLA path (ops/polar_mm.py),
        "gather" = exact texture-semantics bilinear gather (the
        reference's structure), "auto" = ``select_engine``.
      fast: bf16 operands (f32 accumulation) for the matmul sampler.
      axis_name: set when running under shard_map over a particle mesh
        axis — class sums/counts and the centering accumulators are
        psum'd over it (the reference's reduce_EMData_to_root).
      angle_mask: optional (L,) additive mask restricting the angle
        argmax to discrete bins (the --dst delta search,
        ops/search.delta_angle_mask).  Decoding then skips the parabolic
        refinement (exact discrete angles, Crosrng_ms_delta semantics);
        every sampler takes the mask.
      sf: optional precomputed splat spectra for the template engine
        (``splat_spectra_groups``) — cfg-static, so callers that
        invoke the step repeatedly should hoist it (make_align_step
        does).  Ignored by the other samplers.

    ``cfg.ring_scheme == "eman2"`` runs variable Numrinit rings + ringwe
    weights (the CPU twin's exact convention) on every engine: the
    template engine moves the per-ring-group Crosrng_ms accumulation into
    its template build (ops/template_search._angle_spectra); matmul and
    gather run ops/eman_search.py.
    """
    if sampler == "auto":
        sampler = select_engine(cfg, n_classes)
    _check_sampler(sampler, cfg, n_classes, _ENGINES,
                   f"ring_scheme={cfg.ring_scheme!r}")
    if cfg.ring_scheme == "eman2":
        from ..ops.eman_search import (prepare_ref_spectra_eman,
                                       rotational_shift_search_eman)

        ref_fw = prepare_ref_spectra_eman(refs, cfg)
        if sampler == "template":
            from ..ops.template_search import template_search

            result = template_search(images, ref_fw, params, cfg,
                                     angle_mask=angle_mask, sf=sf)
        else:
            result = rotational_shift_search_eman(
                images, ref_fw, params, cfg, sampler=sampler, fast=fast,
                angle_mask=angle_mask)
    else:
        ref_fw = prepare_ref_spectra(refs, cfg)
        if sampler == "template":
            from ..ops.template_search import template_search

            result = template_search(images, ref_fw, params, cfg,
                                     angle_mask=angle_mask, sf=sf)
        elif sampler == "matmul":
            result = rotational_shift_search_mm(images, ref_fw, params,
                                                cfg, fast=fast,
                                                angle_mask=angle_mask)
        else:
            result = rotational_shift_search(images, ref_fw, params, cfg,
                                             shift_chunk=shift_chunk,
                                             angle_mask=angle_mask)
    new_params = decode_params(result, params, cfg, update_ref=update_ref,
                               refine=angle_mask is None)
    sums, counts = _class_sums(images, new_params, n_classes, global_index,
                               valid, sampler, fast)
    sx_sum, sy_sum = _header_shift_sums(new_params, valid)
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
        counts = jax.lax.psum(counts, axis_name)
        sx_sum = jax.lax.psum(sx_sum, axis_name)
        sy_sum = jax.lax.psum(sy_sum, axis_name)
    peak = jnp.where(valid > 0, result.best_val, 0.0) if valid is not None else result.best_val
    return StepOutput(new_params, sums, counts, peak, sx_sum, sy_sum)


class ShcStepOutput(NamedTuple):
    step: StepOutput
    previousmax: jax.Array  # (N,) updated per-particle best-so-far ccf
    nope: jax.Array         # () int32 count of non-improved particles


def align_step_shc(images, refs, params: AlignParams, global_index, valid,
                   previousmax, cfg: AlignConfig, *, n_classes: int,
                   shift_chunk: int = 8, fast: bool = True,
                   sampler: str = "auto",
                   axis_name: str | None = None, sf=None) -> ShcStepOutput:
    """One SHC (stochastic hill climbing) iteration.

    ``random_method="SHC"`` semantics of the CPU twin
    (test_reffree_gpu_align.py:519-524,724): each particle takes the
    first candidate beating its ``previousmax`` rather than the global
    argmax; non-improvers keep their previous params and are counted in
    ``nope``.

    ``sampler`` picks the engine: "template" = the template matmul
    (``template_search_shc``), "matmul" = tent-matmul XLA, "gather" =
    exact texture semantics, "auto" = ``select_engine(mode="shc")``.
    The pick rule is identical across engines (shared priority fold).
    """
    if cfg.ring_scheme != "cuda":
        raise ValueError("random_method='SHC' runs the standard ring "
                         "scheme only (ring_scheme='cuda')")
    if sampler == "auto":
        sampler = select_engine(cfg, n_classes, mode="shc")
    _check_sampler(sampler, cfg, n_classes, _ENGINES, "SHC")
    ref_fw = prepare_ref_spectra(refs, cfg)
    if sampler == "template":
        from ..ops.template_search import template_search_shc

        result, found = template_search_shc(images, ref_fw, params, cfg,
                                            previousmax, sf=sf)
    elif sampler == "matmul":
        from ..ops.search import rotational_shift_search_shc_mm

        result, found = rotational_shift_search_shc_mm(
            images, ref_fw, params, cfg, previousmax, fast=fast)
    else:
        result, found = rotational_shift_search_shc(
            images, ref_fw, params, cfg, previousmax,
            shift_chunk=shift_chunk)
    decoded = decode_params(result, params, cfg, update_ref=True)
    keep = found
    new_params = AlignParams(
        angle=jnp.where(keep, decoded.angle, params.angle),
        shift_x=jnp.where(keep, decoded.shift_x, params.shift_x),
        shift_y=jnp.where(keep, decoded.shift_y, params.shift_y),
        mirror=jnp.where(keep, decoded.mirror, params.mirror),
        ref_id=jnp.where(keep, decoded.ref_id, params.ref_id),
    )
    new_prevmax = jnp.where(found, result.best_val, previousmax)
    sums, counts = _class_sums(images, new_params, n_classes, global_index,
                               valid, sampler, fast)
    sx_sum, sy_sum = _header_shift_sums(new_params, valid)
    v = valid if valid is not None else jnp.ones_like(previousmax)
    nope = jnp.sum(((~found) & (v > 0)).astype(jnp.int32))
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
        counts = jax.lax.psum(counts, axis_name)
        sx_sum = jax.lax.psum(sx_sum, axis_name)
        sy_sum = jax.lax.psum(sy_sum, axis_name)
        nope = jax.lax.psum(nope, axis_name)
    peak = jnp.where(v > 0, new_prevmax, 0.0)
    return ShcStepOutput(
        StepOutput(new_params, sums, counts, peak, sx_sum, sy_sum),
        new_prevmax, nope)


def make_align_step_shc(cfg: AlignConfig, n_classes: int,
                        shift_chunk: int = 8, mesh=None,
                        sampler: str = "auto", fast: bool = True):
    """Jitted SHC step, optionally GSPMD-sharded over a 'dp' mesh axis.

    Every SHC engine is pure XLA (template/matmul/gather), so GSPMD
    partitions all of them; "auto" resolves here so the template
    engine's cfg-static splat spectra can be hoisted."""
    if sampler == "auto":
        sampler = select_engine(cfg, n_classes, mode="shc", mesh=mesh)
    sf = _hoisted_sf(cfg) if sampler == "template" else None
    fn = partial(align_step_shc, cfg=cfg, n_classes=n_classes,
                 shift_chunk=shift_chunk, sampler=sampler, fast=fast)
    kwargs = {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        if sf is not None:
            sf = jax.device_put(sf, NamedSharding(mesh, P()))
        shard = NamedSharding(mesh, P("dp"))
        repl = NamedSharding(mesh, P())
        param_shard = AlignParams(shard, shard, shard, shard, shard)
        kwargs["in_shardings"] = (shard, repl, param_shard, shard, shard,
                                  shard)
        kwargs["out_shardings"] = ShcStepOutput(
            StepOutput(param_shard, repl, repl, shard, repl, repl),
            shard, repl)
    if sf is None:
        return jax.jit(fn, **kwargs)

    def fn_sf(images, refs, params, gidx, valid, pm, sf_):
        return fn(images, refs, params, gidx, valid, pm, sf=sf_)

    if "in_shardings" in kwargs:
        from jax.sharding import NamedSharding, PartitionSpec as P

        kwargs["in_shardings"] = kwargs["in_shardings"] \
            + (NamedSharding(mesh, P()),)
    return _SfStep(jax.jit(fn_sf, **kwargs), sf)


def align_step_scf(images, refs, params: AlignParams, global_index, valid,
                   cfg: AlignConfig, *, n_classes: int,
                   sampler: str = "gather", fast: bool = True,
                   axis_name: str | None = None) -> StepOutput:
    """One SCF (self-correlation) iteration — ``random_method="SCF"``.

    Rotation from the scf ring spectra (shift-invariant), translation
    from one DFT cross-correlation per 180-degree candidate
    (ops/scf.scf_align; semantics contract
    utils.oracle.align_particle_scf_np).  SCF aligns absolutely each
    iteration — the previous params are not composed in (the scf stage
    has no accumulated-shift center), so ``params`` only carries shapes.
    """
    if cfg.ring_scheme != "cuda":
        raise ValueError("random_method='SCF' runs the standard ring "
                         "scheme only (ring_scheme='cuda')")
    if sampler == "auto":
        sampler = select_engine(cfg, n_classes, mode="scf")
    # no template variant: at S=1, K=1 its one big matmul has nothing to
    # batch — reject rather than silently substituting an engine
    _check_sampler(sampler, cfg, n_classes, ("matmul", "gather"), "SCF")
    from ..ops.scf import scf_align

    new_params, peak = scf_align(images, refs[0], cfg, sampler=sampler,
                                 fast=fast)
    sums, counts = _class_sums(images, new_params, n_classes, global_index,
                               valid, sampler, fast)
    sx_sum, sy_sum = _header_shift_sums(new_params, valid)
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
        counts = jax.lax.psum(counts, axis_name)
        sx_sum = jax.lax.psum(sx_sum, axis_name)
        sy_sum = jax.lax.psum(sy_sum, axis_name)
    peak = jnp.where(valid > 0, peak, 0.0) if valid is not None else peak
    return StepOutput(new_params, sums, counts, peak, sx_sum, sy_sum)


def make_align_step_scf(cfg: AlignConfig, n_classes: int, mesh=None,
                        sampler: str = "auto", fast: bool = True):
    """Jitted SCF step, optionally GSPMD-sharded over a 'dp' mesh axis.

    SCF's rotation stage is a zero-shift, K=1 ring search on the scf
    images and its translation stage is DFT ccf maps, so the template
    engine has no variant here; "auto" picks between matmul and gather
    (``select_engine(mode="scf")``).
    """
    if sampler == "auto":
        sampler = select_engine(cfg, n_classes, mode="scf", mesh=mesh)
    fn = partial(align_step_scf, cfg=cfg, n_classes=n_classes,
                 sampler=sampler, fast=fast)
    kwargs = {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P("dp"))
        repl = NamedSharding(mesh, P())
        param_shard = AlignParams(shard, shard, shard, shard, shard)
        kwargs["in_shardings"] = (shard, repl, param_shard, shard, shard)
        kwargs["out_shardings"] = StepOutput(param_shard, repl, repl, shard,
                                             repl, repl)
    return jax.jit(fn, **kwargs)


def raw_sum_step(images, global_index, valid, *, n_classes: int = 1):
    """Even/odd sums of the *raw* stack — iteration 0 of the reffree loop
    (``statistics.sum_oe``, test_reffree_gpu_align.py:363-365)."""
    ref_id = jnp.zeros((images.shape[0],), jnp.int32)
    sums, _ = class_sum_oe(images, ref_id, n_classes,
                           global_index=global_index, valid=valid)
    return sums


def _hoisted_sf(cfg: AlignConfig):
    """Device-resident splat spectra (template engine), computed once at
    step-build time and bound as a runtime ARGUMENT of the jitted step
    (via ``_SfStep``) — never a closure constant: jax constant-folds
    closed-over arrays into the program, which would embed a ~250 MB
    literal and rebuild it on every compile."""
    from ..ops.template_search import splat_spectra_groups

    return jax.jit(lambda: splat_spectra_groups(cfg))()


class _SfCompiled:
    """Compiled-step facade binding the splat spectra as the last call
    argument; forwards the introspection surface the dryrun placement
    audit uses (``as_text`` / ``memory_analysis``)."""

    def __init__(self, compiled, sf):
        self._compiled = compiled
        self._sf = sf

    def __call__(self, *args):
        return self._compiled(*args, self._sf)

    def as_text(self):
        return self._compiled.as_text()

    def memory_analysis(self):
        return self._compiled.memory_analysis()


class _SfLowered:
    def __init__(self, lowered, sf):
        self._lowered = lowered
        self._sf = sf

    def compile(self):
        return _SfCompiled(self._lowered.compile(), self._sf)


class _SfStep:
    """5-arg (or 6-arg for SHC) step facade over a jitted step whose
    LAST positional argument is the bound splat-spectra pytree.  Exposes
    ``lower``/``compile`` so the multichip dryrun's placement audit
    keeps working."""

    def __init__(self, jitted, sf):
        self._jitted = jitted
        self._sf = sf

    def __call__(self, *args):
        return self._jitted(*args, self._sf)

    def lower(self, *args):
        return _SfLowered(self._jitted.lower(*args, self._sf), self._sf)


def make_align_step(cfg: AlignConfig, n_classes: int, shift_chunk: int = 8,
                    update_ref: bool = True, mesh=None, donate: bool = True,
                    sampler: str = "auto", fast: bool = True,
                    dist: str = "gspmd", angle_mask=None):
    """Build the jitted step, optionally sharded over a mesh's 'dp' axis.

    Two distribution modes over a mesh:
      "gspmd" — jit with in/out shardings; XLA inserts the class-sum
        all-reduce.  The only mode supporting the 2-D ('dp','ref')
        large-K mesh.
      "shard_map" — manual SPMD with an explicit psum inside the step
        (1-D 'dp' mesh).

    "auto" resolves here through ``select_engine`` so the template
    engine's cfg-static splat spectra can be hoisted out of the trace.
    ``angle_mask`` builds the discrete-angle (--dst) variant of the step;
    every sampler honors it, so the engine choice is unchanged.
    """
    if sampler == "auto":
        sampler = select_engine(cfg, n_classes, mesh=mesh)
    _check_sampler(sampler, cfg, n_classes, _ENGINES,
                   f"ring_scheme={cfg.ring_scheme!r}")
    if dist not in ("gspmd", "shard_map"):
        raise ValueError(f"unknown dist {dist!r} (gspmd or shard_map)")
    if mesh is not None and dist == "shard_map":
        return _make_shard_map_step(cfg, n_classes, shift_chunk,
                                    update_ref, mesh, sampler, fast,
                                    angle_mask)
    # hoist the cfg-static splat spectra out of the per-call trace
    sf = _hoisted_sf(cfg) if sampler == "template" else None
    if sf is not None and mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        # replicate explicitly: a committed single-device array inside a
        # sharded jit would conflict with the mesh placement
        sf = jax.device_put(sf, NamedSharding(mesh, P()))
    fn = partial(align_step, cfg=cfg, n_classes=n_classes,
                 shift_chunk=shift_chunk, update_ref=update_ref,
                 sampler=sampler, fast=fast, angle_mask=angle_mask)
    kwargs = {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P("dp"))
        repl = NamedSharding(mesh, P())
        # Large-K path (SURVEY.md §5): on a 2-D ('dp', 'ref') mesh the
        # reference stack is sharded over its class axis; GSPMD turns the
        # per-particle argmax over all K into the all-gather of ref ring
        # spectra described in SURVEY.md §2.3.
        ref_shard = (NamedSharding(mesh, P("ref"))
                     if "ref" in mesh.axis_names else repl)
        param_shard = AlignParams(shard, shard, shard, shard, shard)
        kwargs["in_shardings"] = (shard, ref_shard, param_shard, shard, shard)
        kwargs["out_shardings"] = StepOutput(param_shard, repl, repl, shard, repl, repl)
    if donate:
        kwargs["donate_argnums"] = (2,)  # params buffer
    if sf is None:
        return jax.jit(fn, **kwargs)

    def fn_sf(images, refs, params, gidx, valid, sf_):
        return fn(images, refs, params, gidx, valid, sf=sf_)

    if "in_shardings" in kwargs:
        from jax.sharding import NamedSharding, PartitionSpec as P

        # a single sharding acts as a pytree prefix for the sf tuple
        kwargs["in_shardings"] = kwargs["in_shardings"] \
            + (NamedSharding(mesh, P()),)
    return _SfStep(jax.jit(fn_sf, **kwargs), sf)


def _make_shard_map_step(cfg, n_classes, shift_chunk, update_ref, mesh,
                         sampler, fast, angle_mask=None):
    """shard_map distribution: every device runs the full step on its
    particle shard; class sums/counts psum over 'dp' inside (see
    align_step axis_name)."""
    from jax.sharding import PartitionSpec as P

    fn = partial(align_step, cfg=cfg, n_classes=n_classes,
                 shift_chunk=shift_chunk, update_ref=update_ref,
                 sampler=sampler, fast=fast, axis_name="dp",
                 angle_mask=angle_mask)
    pspec = AlignParams(*([P("dp")] * 5))
    smapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P("dp"), P(), pspec, P("dp"), P("dp")),
        out_specs=StepOutput(pspec, P(), P(), P("dp"), P(), P()),
        check_vma=False)
    return jax.jit(smapped, donate_argnums=(2,))
