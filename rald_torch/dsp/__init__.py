"""L0: the radar DSP on tensors (the port of ``rald_tpu.dsp``).

The reference's multiprocess NumPy preprocessing stack
(``dataset_preprocessor/utils/radardsp.py``, ``radar_preprocessing.py``,
``cache_test_cfar_utils.py``) as PyTorch functions on the input's device:
batched ``torch.fft`` FFTs, host-built gather indices for the virtual
antenna array, vectorized CFAR detectors and fixed-count budgeted peak
extraction.
"""
from rald_torch.dsp.params import RadarParams, parse_antenna_array
from rald_torch.dsp.bins import (
    get_range_bins,
    get_velocity_bins,
    get_angle_bins,
    get_bins,
    get_max_range,
    get_max_velocity,
    get_range_resolution,
    get_velocity_resolution,
    fft_size,
)
from rald_torch.dsp.virtual_array import (
    virtual_array,
    virtual_array_shape,
    velocity_compensation,
    steering_matrix,
)
from rald_torch.dsp.rae import raeivv_map, NOISE_THRESHOLD
from rald_torch.dsp.cfar import (
    weibull_quantile,
    masked_weibull_quantile,
    os_cfar,
    nq_cfar_2d,
    mask_real_2d,
)
from rald_torch.dsp.cfar_points import (
    rae_interpo,
    resize_linear_align_corners,
    weighted_allocation,
    budgeted_topk,
    cube_idx2coord,
    cfar_points_from_cube,
)

__all__ = [
    "RadarParams",
    "parse_antenna_array",
    "get_range_bins",
    "get_velocity_bins",
    "get_angle_bins",
    "get_bins",
    "get_max_range",
    "get_max_velocity",
    "get_range_resolution",
    "get_velocity_resolution",
    "fft_size",
    "virtual_array",
    "virtual_array_shape",
    "velocity_compensation",
    "steering_matrix",
    "raeivv_map",
    "NOISE_THRESHOLD",
    "weibull_quantile",
    "masked_weibull_quantile",
    "os_cfar",
    "nq_cfar_2d",
    "mask_real_2d",
    "rae_interpo",
    "resize_linear_align_corners",
    "weighted_allocation",
    "budgeted_topk",
    "cube_idx2coord",
    "cfar_points_from_cube",
]
