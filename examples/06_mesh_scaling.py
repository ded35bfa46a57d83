"""Multi-chip alignment on a device mesh (virtual or real).

Demonstrates the replacement for the reference's
``mpirun -np N`` orchestration (test_mref_gpu_align.py:1203-1266;
SURVEY.md §2.3): particles shard over a 1-D 'dp' mesh, each device
aligns its shard inside one jitted step, and the class sums/counts come
back replicated through the XLA all-reduce that replaces
``reduce_EMData_to_root`` + ``bcast_EMData_to_all``.

Runs anywhere: with ``JAX_PLATFORMS=cpu`` it builds a virtual 8-device
CPU mesh (the same mechanism the test suite and the multi-device dry run
use); on a multi-GPU host the identical code shards over the real cards,
where ``sampler="auto"`` picks the engine ``select_engine`` names for
the GPU.

    JAX_PLATFORMS=cpu python examples/06_mesh_scaling.py   # CPU host
    python examples/06_mesh_scaling.py                      # GPU host
"""

import os
import sys

# make the repo importable when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU run requested: ask XLA for 8 virtual devices — must happen BEFORE
# the first jax backend initialization
if os.environ.get("JAX_PLATFORMS", "") == "cpu" \
        and "host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                               ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")


def main():
    import jax
    import numpy as np

    import jax.numpy as jnp

    from cryo_ralib_tpu.analysis import purity_score
    from cryo_ralib_tpu.config import AlignConfig
    from cryo_ralib_tpu.models.engine import AlignmentEngine
    from cryo_ralib_tpu.models.steps import make_align_step
    from cryo_ralib_tpu.parallel.mesh import make_mesh, shard_stack
    from cryo_ralib_tpu.params import AlignParams
    from cryo_ralib_tpu.utils.synthetic import class_templates, scattered_stack

    k, nx, n = 4, 64, 256
    refs = class_templates(k, nx)
    imgs, cls, _, _ = scattered_stack(refs, n, max_shift=2, seed=3)
    cfg = AlignConfig(img_dim=nx, ring_num=24, ring_len=256, shift_step=1.0,
                      shift_rng_x=2.0, shift_rng_y=2.0)

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} x {jax.devices()[0].platform} over axis 'dp'",
          flush=True)

    # --- one sharded step: images shard over 'dp', refs replicate -----
    step = make_align_step(cfg, n_classes=k, mesh=mesh, donate=False)
    imgs_dev, gidx, valid = shard_stack(imgs, mesh)  # pads to a multiple
    params = AlignParams.zeros(int(imgs_dev.shape[0]))
    out = step(imgs_dev, jnp.asarray(refs), params, gidx, valid)
    rid = np.asarray(out.params.ref_id)[:n]
    print(f"one sharded step: counts={np.asarray(out.counts)}, "
          f"purity={purity_score(cls, rid):.3f}", flush=True)

    # --- full iterations through the engine (resident or streaming) ---
    eng = AlignmentEngine(imgs, cfg, n_classes=k, mesh=mesh)
    cur = refs.copy()
    for it in range(3):
        res = eng.iterate(cur)
        safe = np.maximum(res.counts, 1)[:, None, None]
        cur = ((res.class_sums[:, 0] + res.class_sums[:, 1])
               / safe).astype(np.float32)
    rid = np.asarray(eng.params_np().ref_id)[:n]
    print(f"3 engine iterations: purity={purity_score(cls, rid):.3f}")
    assert purity_score(cls, rid) > 0.9
    print("ok")


if __name__ == "__main__":
    main()
