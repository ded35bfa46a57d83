"""GPU-only checks: every search engine at the smoke widths (rib80s:
90 px, K=8, xr=yr=3, ts=1, ou=36, mirror) against the numpy oracle.

Marked ``gpu``; they skip without a card.  ``chip_smoke.py`` runs them
on the card in its phase 5, or directly:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {dev.platform}")
    return dev


@pytest.mark.parametrize("sampler", ["template", "matmul", "gather"])
def test_engine_matches_oracle_at_smoke_widths(gpu, sampler):
    import chip_smoke as cs
    from cryo_ralib_tpu.models.steps import make_align_step
    from cryo_ralib_tpu.utils.synthetic import asymmetric_templates, pose_stack

    n = 16
    cfg = cs.rib80s_config()
    templates = asymmetric_templates(cs.K, cs.NX)
    stack = pose_stack(templates, n, max_shift=cs.MAX_SHIFT, noise=cs.NOISE,
                       seed=1, mirror=True)
    imgs, params, gidx, valid = cs.step_args(stack.images)
    step = make_align_step(cfg, cs.K, sampler=sampler, donate=False)
    out = step(imgs, jnp.asarray(templates), params, gidx, valid)
    orc = cs.oracle_align(stack.images, templates, cfg, list(range(n)))
    want = {f: np.asarray([orc[i][0][f] for i in range(n)]) for f in
            ("angle", "shift_x", "shift_y", "mirror", "ref_id")}
    cmp = cs.parity(f"{sampler} vs numpy oracle", cs.params_np(out.params),
                    want, {i: orc[i][1] for i in range(n)})
    assert cmp["ok"], cmp
    assert int(np.asarray(out.counts).sum()) == n
