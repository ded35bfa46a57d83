"""Test harness config: run everything on a virtual 8-device CPU mesh so
multi-device sharding paths are exercised without GPUs.  The GPU-only
checks (marker ``gpu``) run where ``JAX_PLATFORMS`` selects the card."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    """A fresh generator per test, so what a test draws does not depend
    on which tests ran before it on the same worker."""
    return np.random.default_rng(1000)


# Re-exported synthetic-data helpers (the public fixture API lives in
# cryo_ralib_tpu.utils.synthetic; tests import them from here).
from cryo_ralib_tpu.utils.synthetic import blob_stack, class_templates


def make_class_bases(n_classes, nx):
    return class_templates(n_classes, nx)


def make_disc_stack(rng, n, nx, blobs=3):
    seed = int(rng.integers(0, 2**31))
    return blob_stack(n, nx, blobs=blobs, seed=seed)
