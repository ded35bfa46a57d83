"""Alignment execution engine: resident or streamed particle stacks.

The reference sizes a GPU batch with ``pre_align_size_check`` and loops
``pre_align_fetch`` + ``*_align_run`` over batches inside every iteration
(test_mref_gpu_align.py:427-463, cuda/gpu_aln_noref.cu:362-380).  The
equivalent here:

* **resident** mode — the stack fits in device memory: upload once
  (sharded over the mesh), keep AlignParams on device across iterations,
  run one fused step per iteration.
* **streaming** mode — stack larger than the device-memory budget
  (parallel/batching.py): the stack stays in host RAM as one numpy
  array; every iteration streams fixed-size batches through the same
  compiled step, accumulating class sums/counts on host and writing
  per-particle params back to host arrays.  The last batch is padded so
  a single compilation serves all batches.

Both modes return identical host-side results; golden tests assert it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..params import AlignParams
from ..parallel.batching import plan_batch_size
from ..parallel.mesh import shard_stack
from .steps import make_align_step, make_align_step_shc, select_engine


@dataclass
class IterationResult:
    class_sums: np.ndarray   # (K, 2, H, W)
    counts: np.ndarray       # (K,)
    peak: np.ndarray         # (N,)
    sx_sum: float
    sy_sum: float
    nope: int = 0            # SHC only: particles with no improving candidate


class AlignmentEngine:
    """Per-iteration executor owning placement, batching and params."""

    def __init__(self, data: np.ndarray, cfg: AlignConfig, n_classes: int,
                 mesh=None, sampler: str = "auto", update_ref: bool = True,
                 batch_size: int | None = None, shift_chunk: int = 8,
                 verbose: bool = False, random_method: str = "",
                 delta: float = 0.0):
        self.n = data.shape[0]
        self.random_method = random_method
        self.cfg = cfg
        self.n_classes = n_classes
        self.mesh = mesh
        # --dst discrete-angle search: iterate(discrete=True) runs a
        # second compiled step whose angle argmax is restricted to
        # multiples of ``delta`` degrees (built lazily on first use;
        # every sampler honors the mask, so discrete iterations keep the
        # engine's fast path).  The CPU twin applies delta only
        # on the standard (non-SHC) path (ali2d_single_iter), so SHC
        # engines reject it.
        self.delta = float(delta)
        if self.delta and random_method:
            raise ValueError("delta (--dst) is only defined for the "
                             "standard search, not random_method=%r"
                             % random_method)
        self._delta_step = None
        self._step_kwargs = dict(sampler=sampler, update_ref=update_ref,
                                 shift_chunk=shift_chunk)
        n_dev = mesh.shape["dp"] if mesh is not None else 1
        if batch_size is None:
            # charge the footprint of the engine the step resolves to
            mode = {"SHC": "shc", "SCF": "scf"}.get(random_method, "standard")
            engine = (sampler if sampler != "auto" else
                      select_engine(cfg, n_classes, mode=mode, mesh=mesh))
            plan_sampler = "template" if engine == "template" else "matmul"
            batch_size = plan_batch_size(self.n, n_classes, cfg,
                                         n_devices=n_dev, verbose=verbose,
                                         sampler=plan_sampler)
        if mesh is not None:  # batches shard evenly over the dp axis
            d = mesh.shape["dp"]
            batch_size = ((batch_size + d - 1) // d) * d
        self.batch = min(batch_size, self.n)
        self.resident = self.batch >= self.n

        if self.resident:
            self._imgs, self._gidx, self._valid = shard_stack(data, mesh)
            # placed as the step returns them (particle-sharded on a
            # mesh), so iteration 2 reuses iteration 1's compilation
            zeros = AlignParams.zeros(self._imgs.shape[0])
            self._params = AlignParams(*(self._place(a) for a in zeros))
            if random_method == "SHC":
                # previousmax seeded at 1.0e-23 (test_reffree_gpu_align.py:724)
                self._prevmax = self._place(
                    np.full(self._imgs.shape[0], 1.0e-23, np.float32))
            step_kw = dict(donate=True)
        else:
            # pad the host stack shape-wise only virtually: batches slice it
            self._host_data = data
            self._params_np = {
                "angle": np.zeros(self.n, np.float32),
                "shift_x": np.zeros(self.n, np.float32),
                "shift_y": np.zeros(self.n, np.float32),
                "mirror": np.zeros(self.n, np.int32),
                "ref_id": np.zeros(self.n, np.int32),
            }
            if random_method == "SHC":
                self._prevmax_np = np.full(self.n, 1.0e-23, np.float32)
            step_kw = dict(donate=False)
        if random_method == "SHC":
            self._step = make_align_step_shc(cfg, n_classes=n_classes,
                                             shift_chunk=shift_chunk,
                                             mesh=mesh, sampler=sampler)
        elif random_method == "SCF":
            from .steps import make_align_step_scf

            self._step = make_align_step_scf(cfg, n_classes=n_classes,
                                             mesh=mesh, sampler=sampler)
        elif random_method:
            raise ValueError(f"unsupported random_method {random_method!r} "
                             "(only '', 'SHC' and 'SCF')")
        else:
            self._step = make_align_step(cfg, n_classes=n_classes,
                                         shift_chunk=shift_chunk,
                                         update_ref=update_ref, mesh=mesh,
                                         sampler=sampler, **step_kw)
        self._donate = step_kw.get("donate", False)

    # -- params access ---------------------------------------------------
    def params_np(self) -> AlignParams:
        """Current per-particle params as host numpy arrays (length n)."""
        if self.resident:
            return AlignParams(*[np.asarray(f)[: self.n] for f in self._params])
        p = self._params_np
        return AlignParams(p["angle"], p["shift_x"], p["shift_y"],
                           p["mirror"], p["ref_id"])

    def set_params(self, params: AlignParams):
        """Restore per-particle params from host arrays (checkpoint
        resume)."""
        if self.resident:
            n_pad = self._params.angle.shape[0]
            pad = n_pad - self.n

            def place(a, dtype):
                full = np.concatenate([np.asarray(a, dtype),
                                       np.zeros(pad, dtype)])
                return jax.device_put(jnp.asarray(full),
                                      self._params.angle.sharding)

            self._params = AlignParams(
                place(params.angle, np.float32),
                place(params.shift_x, np.float32),
                place(params.shift_y, np.float32),
                place(params.mirror, np.int32),
                place(params.ref_id, np.int32))
        else:
            p = self._params_np
            p["angle"][:] = params.angle
            p["shift_x"][:] = params.shift_x
            p["shift_y"][:] = params.shift_y
            p["mirror"][:] = params.mirror
            p["ref_id"][:] = params.ref_id

    def set_ref_id(self, ref_id: np.ndarray):
        """Preset assignments (``pre_align_init`` presets ref_id,
        cuda/gpu_aln_noref.cu:209)."""
        if self.resident:
            pad = self._params.ref_id.shape[0] - self.n
            rid = np.concatenate([np.asarray(ref_id, np.int32),
                                  np.zeros(pad, np.int32)])
            self._params = self._params._replace(
                ref_id=jax.device_put(jnp.asarray(rid),
                                      self._params.angle.sharding))
        else:
            self._params_np["ref_id"][:] = ref_id

    # -- previousmax access (SHC) ----------------------------------------
    def previousmax_np(self) -> np.ndarray:
        assert self.random_method == "SHC"
        if self.resident:
            return np.asarray(self._prevmax)[: self.n]
        return self._prevmax_np.copy()

    def set_previousmax(self, pm: np.ndarray):
        assert self.random_method == "SHC"
        if self.resident:
            pad = self._prevmax.shape[0] - self.n
            full = np.concatenate([np.asarray(pm, np.float32),
                                   np.full(pad, 1.0e-23, np.float32)])
            self._prevmax = self._place(full)
        else:
            self._prevmax_np[:] = pm

    # -- one iteration ---------------------------------------------------
    def _get_step(self, discrete: bool):
        if not discrete:
            return self._step
        if not self.delta:
            raise ValueError("iterate(discrete=True) requires the engine "
                             "to be built with delta != 0 (--dst)")
        if self._delta_step is None:
            from ..ops.search import delta_angle_mask

            mask = delta_angle_mask(self.cfg.ring_len, self.delta,
                                    self.cfg.mode)
            self._delta_step = make_align_step(
                self.cfg, n_classes=self.n_classes, mesh=self.mesh,
                donate=self._donate, angle_mask=mask, **self._step_kwargs)
        return self._delta_step

    def iterate(self, refs: np.ndarray,
                discrete: bool = False) -> IterationResult:
        """One alignment pass.  ``discrete=True`` restricts the rotation
        search to multiples of the engine's ``delta`` (the --dst
        every-4th-iteration schedule, test_reffree_gpu_align.py:841-846).
        """
        step = self._get_step(discrete)
        refs_j = self._place_refs(refs)
        if self.resident:
            if self.random_method == "SHC":
                shc = step(self._imgs, refs_j, self._params,
                                 self._gidx, self._valid, self._prevmax)
                out = shc.step
                self._prevmax = shc.previousmax
                self._params = out.params
                return IterationResult(
                    class_sums=np.asarray(out.class_sums),
                    counts=np.asarray(out.counts, np.int64),
                    peak=np.asarray(out.peak)[: self.n],
                    sx_sum=float(out.sx_sum), sy_sum=float(out.sy_sum),
                    nope=int(shc.nope))
            out = step(self._imgs, refs_j, self._params, self._gidx,
                             self._valid)
            self._params = out.params
            return IterationResult(
                class_sums=np.asarray(out.class_sums),
                counts=np.asarray(out.counts, np.int64),
                peak=np.asarray(out.peak)[: self.n],
                sx_sum=float(out.sx_sum), sy_sum=float(out.sy_sum))

        k = self.n_classes
        h = self._host_data.shape[1]
        sums = np.zeros((k, 2, h, h), np.float32)
        counts = np.zeros(k, np.int64)
        peak = np.zeros(self.n, np.float32)
        sx_sum = 0.0
        sy_sum = 0.0
        nope = 0
        b = self.batch
        p = self._params_np
        for start in range(0, self.n, b):
            end = min(start + b, self.n)
            m = end - start
            pad = b - m
            sl = slice(start, end)

            def padded(a, dtype):
                out = np.zeros(b, dtype)
                out[:m] = a[sl]
                return out

            imgs_b = self._host_data[sl]
            if pad:
                imgs_b = np.concatenate(
                    [imgs_b, np.zeros((pad, h, h), np.float32)])
            imgs_dev, _, _ = shard_stack(imgs_b, self.mesh)
            gidx = self._place(padded(np.arange(self.n, dtype=np.int32),
                                      np.int32))
            valid = self._place(
                (np.arange(b) < m).astype(np.float32))
            params_b = AlignParams(
                self._place(padded(p["angle"], np.float32)),
                self._place(padded(p["shift_x"], np.float32)),
                self._place(padded(p["shift_y"], np.float32)),
                self._place(padded(p["mirror"], np.int32)),
                self._place(padded(p["ref_id"], np.int32)))
            if self.random_method == "SHC":
                pm_b = np.full(b, 1.0e-23, np.float32)
                pm_b[:m] = self._prevmax_np[sl]
                shc = step(imgs_dev, refs_j, params_b, gidx, valid,
                                 self._place(pm_b))
                out = shc.step
                self._prevmax_np[sl] = np.asarray(shc.previousmax)[:m]
                nope += int(shc.nope)
            else:
                out = step(imgs_dev, refs_j, params_b, gidx, valid)
            newp = out.params
            p["angle"][sl] = np.asarray(newp.angle)[:m]
            p["shift_x"][sl] = np.asarray(newp.shift_x)[:m]
            p["shift_y"][sl] = np.asarray(newp.shift_y)[:m]
            p["mirror"][sl] = np.asarray(newp.mirror)[:m]
            p["ref_id"][sl] = np.asarray(newp.ref_id)[:m]
            sums += np.asarray(out.class_sums)
            counts += np.asarray(out.counts, np.int64)
            peak[sl] = np.asarray(out.peak)[:m]
            sx_sum += float(out.sx_sum)
            sy_sum += float(out.sy_sum)
        return IterationResult(sums, counts, peak, sx_sum, sy_sum, nope)

    # -- placement helpers ----------------------------------------------
    def _place(self, arr):
        if self.mesh is None:
            return jnp.asarray(arr)
        from ..parallel.mesh import particle_sharding

        return jax.device_put(jnp.asarray(arr), particle_sharding(self.mesh))

    def _place_refs(self, refs):
        refs = jnp.asarray(refs)
        if self.mesh is None:
            return refs
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P("ref") if "ref" in self.mesh.axis_names else P()
        return jax.device_put(refs, NamedSharding(self.mesh, spec))
