"""Multi-process distributed execution: two CPU processes joined with
``jax.distributed.initialize`` build one global mesh and run one
``align_step``; the psum'd class sums equal the single-process run.

This exercises the replacement for the reference's
``mpirun -np N`` orchestration (communicator split + scatter + reduce,
test_mref_gpu_align.py:1203-1266,1383-1415; SURVEY.md §2.3) at the
process level, not just on a single-process virtual mesh.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Each worker process: 4 virtual CPU devices; 2 processes -> 8 global.
WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2])
port = sys.argv[3]; outdir = sys.argv[4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=nproc, process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cryo_ralib_tpu.config import AlignConfig
from cryo_ralib_tpu.models.steps import make_align_step
from cryo_ralib_tpu.parallel.mesh import make_mesh, make_mesh_2d
from cryo_ralib_tpu.params import AlignParams
from cryo_ralib_tpu.utils.synthetic import blob_stack, class_templates

assert jax.process_count() == nproc
assert len(jax.devices()) == 4 * nproc

nx, k, n = 64, 4, 16
cfg = AlignConfig(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
                  shift_rng_x=1.0, shift_rng_y=1.0)
# deterministic data, identical in every process
base = class_templates(k, nx)
rng = np.random.default_rng(1000)
data = (base[rng.integers(0, k, n)]
        + rng.normal(0, 0.05, (n, nx, nx))).astype(np.float32)

from jax.experimental import multihost_utils

def put(host, sharding):
    return jax.make_array_from_callback(host.shape, sharding,
                                        lambda idx: host[idx])

def run(mesh, ref_spec):
    shard = NamedSharding(mesh, P("dp"))
    imgs = put(data, shard)
    gidx = put(np.arange(n, dtype=np.int32), shard)
    valid = put(np.ones(n, np.float32), shard)
    p0 = AlignParams.zeros(n)
    params = AlignParams(*(put(np.asarray(x), shard) for x in p0))
    refs = put(base, NamedSharding(mesh, ref_spec))
    step = make_align_step(cfg, k, update_ref=True, mesh=mesh,
                           sampler="gather", dist="gspmd", donate=False)
    out = step(imgs, refs, params, gidx, valid)
    ref_id = multihost_utils.process_allgather(out.params.ref_id,
                                               tiled=True)
    return out, np.asarray(ref_id)

# 1-D dp mesh over all 8 global devices
out1, rid1 = run(make_mesh(), P())
# 2-D (dp, ref) mesh: the large-K path, across processes
out2, rid2 = run(make_mesh_2d(4, 2), P("ref"))

# shard_map + matmul: the manual-SPMD distribution mode
mesh_sm = make_mesh()
shard_sm = NamedSharding(mesh_sm, P("dp"))
step_sm = make_align_step(cfg, k, update_ref=True, mesh=mesh_sm,
                          sampler="matmul", dist="shard_map")
out3 = step_sm(put(data, shard_sm),
               put(base, NamedSharding(mesh_sm, P())),
               AlignParams(*(put(np.asarray(x), shard_sm)
                             for x in AlignParams.zeros(n))),
               put(np.arange(n, dtype=np.int32), shard_sm),
               put(np.ones(n, np.float32), shard_sm))
rid3 = np.asarray(multihost_utils.process_allgather(out3.params.ref_id,
                                                    tiled=True))

# GSPMD + template sampler: the GPU mesh's "auto" engine (pure
# dot_general partitions over 'dp' — ops/template_search.py)
mesh_tm = make_mesh()
shard_tm = NamedSharding(mesh_tm, P("dp"))
step_tm = make_align_step(cfg, k, update_ref=True, mesh=mesh_tm,
                          sampler="template", dist="gspmd", donate=False)
out4 = step_tm(put(data, shard_tm),
               put(base, NamedSharding(mesh_tm, P())),
               AlignParams(*(put(np.asarray(x), shard_tm)
                             for x in AlignParams.zeros(n))),
               put(np.arange(n, dtype=np.int32), shard_tm),
               put(np.ones(n, np.float32), shard_tm))
rid4 = np.asarray(multihost_utils.process_allgather(out4.params.ref_id,
                                                    tiled=True))

if pid == 0:
    np.savez(os.path.join(outdir, "out.npz"),
             class_sums=np.asarray(out1.class_sums),
             counts=np.asarray(out1.counts),
             sx_sum=np.asarray(out1.sx_sum),
             ref_id=rid1,
             class_sums2=np.asarray(out2.class_sums),
             counts2=np.asarray(out2.counts),
             ref_id2=rid2,
             counts3=np.asarray(out3.counts),
             ref_id3=rid3,
             counts4=np.asarray(out4.counts),
             ref_id4=rid4)
jax.distributed.shutdown()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_step_matches_single(tmp_path):
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)  # any PYTHONPATH entry breaks this image
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), "2", port, str(tmp_path)],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            low = out.lower()
            if "unimplemented" in low or "not supported" in low:
                pytest.skip("CPU cross-process collectives unavailable: "
                            + out[-500:])
            pytest.fail(f"worker rc={p.returncode}:\n{out}")

    got = np.load(tmp_path / "out.npz")

    # single-process expected run (this process's own 8-device mesh)
    import jax.numpy as jnp

    from cryo_ralib_tpu.config import AlignConfig
    from cryo_ralib_tpu.models.steps import make_align_step
    from cryo_ralib_tpu.params import AlignParams
    from cryo_ralib_tpu.utils.synthetic import blob_stack, class_templates

    nx, k, n = 64, 4, 16
    cfg = AlignConfig(img_dim=nx, ring_num=20, ring_len=256, shift_step=1.0,
                      shift_rng_x=1.0, shift_rng_y=1.0)
    base = class_templates(k, nx)
    rng = np.random.default_rng(1000)
    data = (base[rng.integers(0, k, n)]
            + rng.normal(0, 0.05, (n, nx, nx))).astype(np.float32)
    step = make_align_step(cfg, k, update_ref=True, sampler="gather",
                           donate=False)
    exp = step(jnp.asarray(data), jnp.asarray(base), AlignParams.zeros(n),
               jnp.arange(n, dtype=jnp.int32), jnp.ones(n, jnp.float32))

    np.testing.assert_array_equal(got["counts"], np.asarray(exp.counts))
    np.testing.assert_array_equal(got["ref_id"], np.asarray(exp.params.ref_id))
    # shard_map + matmul across processes: same assignments (bf16
    # tent-matmul sampling can tie-swap only on degenerate data; the
    # class-template stack is well separated)
    np.testing.assert_array_equal(got["counts3"], np.asarray(exp.counts))
    np.testing.assert_array_equal(got["ref_id3"],
                                  np.asarray(exp.params.ref_id))
    # GSPMD + template engine across processes: same assignments
    np.testing.assert_array_equal(got["counts4"], np.asarray(exp.counts))
    np.testing.assert_array_equal(got["ref_id4"],
                                  np.asarray(exp.params.ref_id))
    np.testing.assert_allclose(
        got["class_sums"], np.asarray(exp.class_sums),
        atol=5e-4 * np.abs(got["class_sums"]).max())
    np.testing.assert_allclose(got["sx_sum"], float(exp.sx_sum), atol=1e-3)

    # the multi-process 2-D ('dp','ref') mesh run agrees too
    np.testing.assert_array_equal(got["counts2"], np.asarray(exp.counts))
    np.testing.assert_array_equal(got["ref_id2"],
                                  np.asarray(exp.params.ref_id))
    np.testing.assert_allclose(
        got["class_sums2"], np.asarray(exp.class_sums),
        atol=5e-4 * np.abs(got["class_sums2"]).max())
