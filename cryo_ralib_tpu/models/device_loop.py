"""Fully device-resident reference-free alignment loop.

Rebuild of the reference's standalone gpu_isac-heritage pipeline
(SURVEY.md §3.5): ``ref_free_alignment_2D_init`` uploads everything once,
then every iteration runs filter-references → align → transform →
average *entirely on device*, with the new average written straight back
into reference memory (cuda/gpu_aln_noref.cu:743-782,1915) — no host, no
MPI in the loop.

Here the whole multi-iteration loop is ONE jitted ``lax.fori_loop``
program: per iteration the running average is tangent-filtered at a
static-schedule cutoff, every particle runs the full
rotation/mirror/shift search against it, and the even/odd class sums
produce the next average. Under a 'dp' mesh the per-iteration average
reduction is an all-reduce over the mesh.  One dispatch covers all
iterations, so this is also the sustained-throughput measurement path.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..ops.filters import filt_tanl_dyn
from ..ops.search import (decode_params, prepare_ref_spectra,
                          rotational_shift_search,
                          rotational_shift_search_mm)
from ..params import AlignParams
from .steps import _class_sums, _check_sampler, _ENGINES, select_engine


def _search_one(images, refs_f, params, cfg, sampler, fast, shift_chunk, sf):
    """Scheme-aware search dispatch shared by both device loops:
    ``ring_scheme="eman2"`` runs the template engine or the
    ``ops/eman_search`` matmul/gather engines."""
    if cfg.ring_scheme == "eman2":
        from ..ops.eman_search import (prepare_ref_spectra_eman,
                                       rotational_shift_search_eman)

        ref_fw = prepare_ref_spectra_eman(refs_f, cfg)
        if sampler == "template":
            from ..ops.template_search import template_search

            return template_search(images, ref_fw, params, cfg, sf=sf)
        return rotational_shift_search_eman(images, ref_fw, params, cfg,
                                            sampler=sampler, fast=fast)
    ref_fw = prepare_ref_spectra(refs_f, cfg)
    if sampler == "template":
        from ..ops.template_search import template_search

        return template_search(images, ref_fw, params, cfg, sf=sf)
    if sampler == "matmul":
        return rotational_shift_search_mm(images, ref_fw, params, cfg,
                                          fast=fast)
    return rotational_shift_search(images, ref_fw, params, cfg,
                                   shift_chunk=shift_chunk)


def _loop(images, avg0, params: AlignParams, gidx, valid, cutoffs, falloffs,
          sf=None, *, cfg: AlignConfig, n_iter: int, sampler: str,
          fast: bool, shift_chunk: int):
    n_total = jnp.sum(valid)
    # splat spectra depend only on cfg — loop-invariant; the maker
    # passes them as a device-resident runtime argument, the in-trace
    # rebuild below is the fallback for direct callers
    if sf is None and sampler == "template":
        from ..ops.template_search import splat_spectra_groups

        sf = splat_spectra_groups(cfg)

    def body(i, state):
        params, avg = state
        avg_f = filt_tanl_dyn(avg, cutoffs[i], falloffs[i])
        res = _search_one(images, avg_f[None], params, cfg, sampler, fast,
                          shift_chunk, sf)
        params = decode_params(res, params, cfg, update_ref=False)
        sums, _ = _class_sums(images, params, 1, gidx, valid, sampler, fast)
        avg_new = (sums[0, 0] + sums[0, 1]) / n_total
        return params, avg_new

    return jax.lax.fori_loop(0, n_iter, body, (params, avg0))


def _loop_sampler(cfg: AlignConfig, n_classes: int, sampler: str,
                  mesh) -> str:
    """Resolve and validate the loops' engine (``select_engine``: the
    loops share the single-step choice)."""
    if sampler == "auto":
        sampler = select_engine(cfg, n_classes, mesh=mesh)
    _check_sampler(sampler, cfg, n_classes, _ENGINES, "device-loop")
    return sampler


def _loop_sf(cfg: AlignConfig, sampler: str, mesh):
    """Device-resident splat spectra for the template engine, computed
    once at loop-build time and passed as a runtime argument (closure
    constants would be folded into the program as literals)."""
    if sampler != "template":
        return None
    from ..ops.template_search import splat_spectra_groups

    sf = jax.jit(lambda: splat_spectra_groups(cfg))()
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sf = jax.device_put(sf, NamedSharding(mesh, P()))
    return sf


def make_device_loop(cfg: AlignConfig, n_iter: int, cutoffs, falloffs=None,
                     mesh=None, sampler: str = "auto", fast: bool = True,
                     shift_chunk: int = 8):
    """Build the jitted n_iter-iteration loop.

    Args:
      cutoffs: per-iteration tangent-filter cutoffs, length n_iter
        (<=0 disables filtering that iteration — the schedule plays the
        role of the host FSC fit in the offline driver).
      falloffs: per-iteration falloffs (default 0.1).
      mesh: optional 'dp' mesh; images/params shard over particles, the
        average comes back replicated.

    Returns fn(images, avg0, params, gidx, valid) -> (params, avg).
    """
    sampler = _loop_sampler(cfg, 1, sampler, mesh)
    cutoffs = np.asarray(cutoffs, np.float32)
    assert cutoffs.shape == (n_iter,)
    if falloffs is None:
        falloffs = np.full(n_iter, 0.1, np.float32)
    falloffs = np.asarray(falloffs, np.float32)

    fn = partial(_loop, cfg=cfg, n_iter=n_iter, sampler=sampler, fast=fast,
                 shift_chunk=shift_chunk)
    sf_dev = _loop_sf(cfg, sampler, mesh)
    kwargs = {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P("dp"))
        repl = NamedSharding(mesh, P())
        pshard = AlignParams(shard, shard, shard, shard, shard)
        kwargs["in_shardings"] = (shard, repl, pshard, shard, shard,
                                  repl, repl, repl)
        kwargs["out_shardings"] = (pshard, repl)
    jitted = jax.jit(fn, **kwargs)

    def run(images, avg0, params, gidx, valid):
        return jitted(images, jnp.asarray(avg0), params, gidx, valid,
                      jnp.asarray(cutoffs), jnp.asarray(falloffs), sf_dev)

    return run


def _mref_loop(images, refs0, params: AlignParams, gidx, valid, cutoffs,
               falloffs, sf=None, *, cfg: AlignConfig, n_iter: int,
               n_classes: int, sampler: str, fast: bool, shift_chunk: int):
    # splat spectra depend only on cfg — loop-invariant; the maker
    # passes them as a device-resident runtime argument, the in-trace
    # rebuild below is the fallback for direct callers
    if sf is None and sampler == "template":
        from ..ops.template_search import splat_spectra_groups

        sf = splat_spectra_groups(cfg)

    def body(i, state):
        params, refs = state
        refs_f = filt_tanl_dyn(refs, cutoffs[i], falloffs[i])
        res = _search_one(images, refs_f, params, cfg, sampler, fast,
                          shift_chunk, sf)
        params = decode_params(res, params, cfg, update_ref=True)
        sums, counts = _class_sums(images, params, n_classes, gidx, valid,
                                   sampler, fast)
        safe = jnp.maximum(counts, 1).astype(jnp.float32)
        new_refs = (sums[:, 0] + sums[:, 1]) / safe[:, None, None]
        # vanished classes keep their previous reference (the offline
        # driver reseeds from a random particle instead — host RNG has no
        # place inside the loop; document the difference)
        new_refs = jnp.where((counts < 4)[:, None, None], refs, new_refs)
        return params, new_refs

    return jax.lax.fori_loop(0, n_iter, body, (params, refs0))


def make_mref_device_loop(cfg: AlignConfig, n_iter: int, n_classes: int,
                          cutoffs, falloffs=None, mesh=None,
                          sampler: str = "auto", fast: bool = True,
                          shift_chunk: int = 8):
    """Multireference analog of ``make_device_loop``: K references live on
    device and are rebuilt from the class sums every iteration — the whole
    ``mref_align_run`` workload as one compiled program (no reference
    equivalent exists; their device-resident loop is single-reference).

    Returns fn(images, refs0, params, gidx, valid) -> (params, refs).
    """
    sampler = _loop_sampler(cfg, n_classes, sampler, mesh)
    cutoffs = np.asarray(cutoffs, np.float32)
    assert cutoffs.shape == (n_iter,)
    if falloffs is None:
        falloffs = np.full(n_iter, 0.1, np.float32)
    falloffs = np.asarray(falloffs, np.float32)

    fn = partial(_mref_loop, cfg=cfg, n_iter=n_iter, n_classes=n_classes,
                 sampler=sampler, fast=fast, shift_chunk=shift_chunk)
    sf_dev = _loop_sf(cfg, sampler, mesh)
    kwargs = {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P("dp"))
        repl = NamedSharding(mesh, P())
        pshard = AlignParams(shard, shard, shard, shard, shard)
        kwargs["in_shardings"] = (shard, repl, pshard, shard, shard,
                                  repl, repl, repl)
        kwargs["out_shardings"] = (pshard, repl)
    jitted = jax.jit(fn, **kwargs)

    def run(images, refs0, params, gidx, valid):
        return jitted(images, jnp.asarray(refs0), params, gidx, valid,
                      jnp.asarray(cutoffs), jnp.asarray(falloffs), sf_dev)

    return run


def ref_free_alignment_2d(images: np.ndarray, n_iter: int = 10,
                          ou: int = -1, xr: float = 2.0, yr: float = -1.0,
                          ts: float = 1.0, cutoff: float = 0.25,
                          falloff: float = 0.1, mesh=None,
                          sampler: str = "auto"):
    """Convenience wrapper: run the device-resident loop on a stack.

    Mirrors the CUDA standalone main_2 harness (gpu_aln_noref.cu:
    2564-2631): iteration 0 starts from the plain global average; a
    fixed tanh cutoff substitutes the host FSC fit.

    Returns (params_table-ready AlignParams on host, final average).
    """
    from ..parallel.mesh import shard_stack

    n, ny, nx = images.shape
    last_ring = int(ou) if int(ou) != -1 else nx // 2 - 2
    if yr is None or yr < 0:
        yr = xr
    cfg = AlignConfig(img_dim=nx, ring_num=last_ring, ring_len=256,
                      shift_step=float(ts), shift_rng_x=float(xr),
                      shift_rng_y=float(yr))
    imgs_dev, gidx, valid = shard_stack(images, mesh)
    params = AlignParams.zeros(imgs_dev.shape[0])
    avg0 = images.mean(0).astype(np.float32)
    loop = make_device_loop(cfg, n_iter, np.full(n_iter, cutoff, np.float32),
                            np.full(n_iter, falloff, np.float32), mesh=mesh,
                            sampler=sampler)
    params, avg = loop(imgs_dev, avg0, params, gidx, valid)
    host = AlignParams(*[np.asarray(f)[:n] for f in params])
    return host, np.asarray(avg)
