"""cryo_ralib_tpu — 2D cryo-EM particle alignment in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
phonchi/Cryo-RAlib (GPU-accelerated multireference and reference-free 2D
alignment for cryo-EM): polar ring resampling, FFT rotational
cross-correlation with mirror search over an x/y shift grid,
argmax + parabolic angle refinement, batch rotate/shift transforms,
even/odd class-average accumulation with FSC-driven reference filtering —
one jitted step per iteration (fused scan over the shift grid, one-hot
matmul class sums, data parallelism over the particle axis of a device
mesh).  ``models.steps.select_engine`` picks the search engine.
"""

from .config import AlignConfig  # noqa: F401
from .params import AlignParams  # noqa: F401

__version__ = "0.1.0"
