"""JAX compute ops for 2D cryo-EM particle alignment."""

from .ccf import (  # noqa: F401
    ccf_rows,
    ccf_spectra,
    ccf_spectra_per_particle_ref,
    ring_spectra,
    weight_ring_spectra,
)
from .center import center_2D, center_of_gravity  # noqa: F401
from .classavg import class_sum_oe  # noqa: F401
from .filters import filt_btwl, filt_tanl, filt_tanl_dyn, fshift, tanl_response  # noqa: F401
from .fsc import fit_tanh, fsc, fsc_mask, write_fsc  # noqa: F401
from .interp import bilinear_sample, quadri_sample  # noqa: F401
from .masks import infomask, model_circle, normalize_mask  # noqa: F401
from .polar import polar_resample  # noqa: F401
from .search import (  # noqa: F401
    SearchResult,
    decode_params,
    prepare_ref_spectra,
    rotational_shift_search,
)
from .template_search import (  # noqa: F401
    build_template_matrix,
    template_search,
    template_supported,
)
from .transform import rot_shift2d, transform_batch  # noqa: F401
