"""Particle-axis device mesh and sharding helpers.

The reference scales with MPI data parallelism over particles plus
node-local communicator surgery to bind ranks to GPUs
(test_mref_gpu_align.py:1203-1266; SURVEY.md §2.3).  The replacement is
one ``jax.sharding.Mesh`` with a single ``dp`` axis over all GPUs: the
stack is sharded on the particle axis, the jitted iteration step reduces
class sums with an XLA all-reduce (NCCL over NVLink), and there is no
hand-written send/recv at all.  Several hosts reuse the same code via
``jax.distributed.initialize`` + a mesh over the global devices.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(**kwargs) -> None:
    """Multi-host setup: call once per process before building a mesh.

    Thin wrapper over ``jax.distributed.initialize``; pass
    ``coordinator_address``, ``num_processes`` and ``process_id``.
    After this, ``make_mesh()`` over ``jax.devices()`` spans every host
    and the drivers' class-sum all-reduce crosses hosts through NCCL —
    the role the reference fills with mpirun + pydusa (SURVEY.md §2.3).
    """
    import jax.distributed

    jax.distributed.initialize(**kwargs)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D 'dp' mesh over the first ``n_devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("dp",))


def make_mesh_2d(dp: int, ref: int, devices=None) -> Mesh:
    """2-D ('dp', 'ref') mesh: particles sharded over 'dp', the reference
    axis over 'ref' — the large-K path of SURVEY.md §5 where the per-chip
    ccf works on a K/ref_shards slice and GSPMD all-gathers the winning
    slice statistics.  With ref=1 this degenerates to the 1-D dp mesh."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: dp * ref]).reshape(dp, ref)
    return Mesh(devices, ("dp", "ref"))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("dp"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_stack(images: np.ndarray, mesh: Mesh | None):
    """Pad the stack to a multiple of the mesh size and place it sharded.

    Returns (device_array, global_index, valid_mask) — the padding mask
    keeps class sums and counts exact (the counterpart of the reference's
    uneven ``MPI_start_end`` block partition, which needs no padding
    because MPI ranks are not lock-stepped).
    """
    import jax.numpy as jnp

    n = images.shape[0]
    if mesh is None:
        gidx = jnp.arange(n, dtype=jnp.int32)
        return jnp.asarray(images), gidx, jnp.ones((n,), jnp.float32)
    d = mesh.shape["dp"]
    n_pad = pad_to_multiple(n, d)
    if n_pad != n:
        images = np.concatenate(
            [images, np.zeros((n_pad - n,) + images.shape[1:], images.dtype)])
    valid = (np.arange(n_pad) < n).astype(np.float32)
    gidx = np.arange(n_pad, dtype=np.int32)
    shard = particle_sharding(mesh)
    return (
        jax.device_put(jnp.asarray(images), shard),
        jax.device_put(jnp.asarray(gidx), shard),
        jax.device_put(jnp.asarray(valid), shard),
    )
