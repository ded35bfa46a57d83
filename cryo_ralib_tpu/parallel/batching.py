"""Device-memory budget model and host-side batch planning.

Counterpart of the reference's GPU memory machinery
(``pre_align_size_check`` + the Python power-of-2 batch search,
cuda/gpu_aln_noref.cu:234-349 / test_mref_gpu_align.py:373-380): instead
of pitched textures and cuFFT workspaces, the model covers the arrays the
fused jitted step actually materializes, and the driver streams
host-resident stacks through the device in fixed-size batches when the
whole stack does not fit.

Unlike the reference there is no runtime probing: shapes are static, the
footprint is a closed-form function of (batch, K, config), and one jit
compilation serves every batch (the last one is padded).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# The CPU backend reports no memory limit.  Plan CPU runs against a
# stated 16 GiB host budget: CPU runs are tests and rehearsals, whose
# stacks are small.
CPU_PLAN_BYTES = 16 * 1024 ** 3


def device_memory_bytes(device=None) -> int:
    """Usable device memory (bytes): the accelerator's reported
    ``bytes_limit`` (the share of the card this process reserved), or
    ``CPU_PLAN_BYTES`` on the CPU.  An accelerator that reports no limit
    is an error — a guessed budget would plan batches that do not fit."""
    import jax

    if device is None:
        device = jax.devices()[0]
    if device.platform == "cpu":
        return CPU_PLAN_BYTES
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(f"{device.device_kind} ({device.platform}) "
                           "reports no memory limit; pass limit_bytes / "
                           "batch_size explicitly")
    return int(limit)


@dataclass(frozen=True)
class StepFootprint:
    """Per-batch device-memory footprint of one align step (bytes)."""

    images: int
    translate: int
    polar_chunk: int
    spectra: int
    ccf_rows: int
    transform: int
    tables: int

    @property
    def total(self) -> int:
        # images are resident; the big transients overlap only partially —
        # polar/spectra/rows coexist inside one scan body
        return (self.images + self.tables
                + max(self.translate + self.polar_chunk + self.spectra
                      + self.ccf_rows, self.transform))


def step_footprint(batch: int, n_refs: int, cfg, pad_to: int | None = None,
                   sampler: str = "matmul") -> StepFootprint:
    """Closed-form memory model of ``align_step``: ``sampler="template"``
    for the template engine, otherwise the tent-matmul intermediates
    (also charged for gather).

    Mirrors what ``pre_align_size_check`` accounts for (texture memory,
    polar/FFT buffer, ccf table, transfer arrays) in terms of the
    pipeline's actual intermediates.
    """
    f32 = 4
    h = cfg.img_dim
    q = cfg.ring_num * cfg.ring_len
    n_dx = len(cfg.shift_x_vals)
    n_freq = cfg.n_freq
    if pad_to is None:
        pad_to = ((int(np.ceil(h * np.sqrt(2.0))) + 127) // 128) * 128

    images = batch * h * h * f32
    # translate_bilinear_mm: per-particle tent matrices + translated copy
    translate = batch * (2 * h * h + h * h) * f32
    if sampler == "template":
        # template engine: bf16 window (translate_window_mm fuses the
        # slice, no full-image copy), per-chunk score transient, and the
        # batch-independent template blocks/matrix
        from ..ops.template_search import (COL_CHUNK_TARGET,
                                           _splat_spectra_bytes,
                                           _template_blocks_bytes,
                                           template_geometry)

        _, width, _ = template_geometry(cfg)
        h = cfg.img_dim
        # translate_window_mm transients: two (N, width, H) bf16 tent
        # operands, the (N, width, W) f32 mid product (+ bf16 cast), and
        # the (N, width, width) window (f32 out + bf16 search operand)
        translate = batch * (2 * width * h * 2 + width * h * (4 + 2)
                             + width * width * (4 + 2))
        polar_chunk = batch * COL_CHUNK_TARGET * f32   # (N, chunk) scores
        # the search streams column chunks from the padded blocks, and
        # the step-level splat-spectra hoist keeps the complex64 spectra
        # resident across calls (4.4 GB at 256 px/ou=100 — a real
        # residency the plan must charge)
        spectra = _template_blocks_bytes(cfg, n_refs) \
            + _splat_spectra_bytes(cfg)
        ccf_rows = 0
    else:
        # polar_group_mm: T (N, Q, W) in bf16 + polar chunk (N, n_dx, Q)
        polar_chunk = batch * q * h * 2 + batch * n_dx * q * f32
        # subject spectra (complex64) + ccf spectra orig+mirr
        spectra = batch * n_dx * cfg.ring_num * n_freq * 8 \
            + 2 * batch * n_dx * n_refs * n_freq * 8
        # irfft'd rows (N, 2, n_dx, K, L)
        ccf_rows = 2 * batch * n_dx * n_refs * cfg.ring_len * f32
    # FFT-shear transform: padded image + spectra (complex) x2 buffers
    transform = batch * (4 * pad_to * pad_to + 2 * pad_to * (pad_to + 2)) * f32
    # constant tent tables (replicated per device).  Only the matmul
    # path allocates PolarTables-shaped constants; the template
    # engine samples via translate_window_mm's traced tents + the blocks
    # already counted above — charging it ~(n_dy+n_dx)*Q*H would shrink
    # the planned batch by a phantom ~quarter-GiB at 256 px.
    if sampler == "template":
        tables = 0
    else:
        tables = (cfg.shift_y_vals.size + cfg.shift_x_vals.size) * q * h * f32
    return StepFootprint(images, translate, polar_chunk, spectra,
                         ccf_rows, transform, tables)


def plan_batch_size(n: int, n_refs: int, cfg, limit_bytes: int | None = None,
                    occupancy: float = 0.7, n_devices: int = 1,
                    verbose: bool = False, sampler: str = "matmul") -> int:
    """Largest power-of-2 per-device batch whose footprint fits
    ``occupancy * limit`` (the reference requests 0.9 of free GPU memory;
    we default lower because XLA needs scratch headroom).

    Returns the *global* batch size (per-device batch x n_devices),
    clamped to n.
    """
    if limit_bytes is None:
        limit_bytes = device_memory_bytes()
    budget = int(limit_bytes * occupancy)
    per_dev = 1
    while per_dev < n:
        fp = step_footprint(per_dev * 2, n_refs, cfg, sampler=sampler)
        if fp.total > budget:
            break
        per_dev *= 2
    if verbose:
        fp = step_footprint(per_dev, n_refs, cfg, sampler=sampler)
        print(f"batch plan: {per_dev}/device x {n_devices} devices "
              f"(budget {budget / 2**30:.2f} GiB)")
        for name in ("images", "translate", "polar_chunk", "spectra",
                     "ccf_rows", "transform", "tables"):
            print(f"  {name:>12}: {getattr(fp, name) / 2**20:9.1f} MiB")
        print(f"  {'total':>12}: {fp.total / 2**20:9.1f} MiB")
    return min(per_dev * n_devices, n)
