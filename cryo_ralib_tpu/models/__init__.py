"""Alignment drivers (the reference's L3/L4 layers)."""

from .mref import MrefResult, mref_ali2d_tpu  # noqa: F401
from .reffree import RefFreeResult, ali2d_base_tpu  # noqa: F401
from .steps import (StepOutput, align_step, make_align_step,  # noqa: F401
                    raw_sum_step, select_engine)
from .user_functions import factory, ref_ali2d  # noqa: F401
