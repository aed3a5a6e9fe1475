"""Sensor calibration constants (ColoRadar + HUST-Radar): the port's own copy
of ``rald_tpu/constants.py``.

Capability parity with reference ``dataset_preprocessor/constants.py:1-56``:
rigid transforms between the lidar / radar / base frames, recording-attribute
counts, and the antenna wavelength-to-aperture ratio used by the CFAR
index->coordinate mapping (reference ``constants.py:18``).

Implemented dependency-free (quaternion -> rotation matrix inline instead of
scipy.spatial.transform.Rotation) so the core package needs only numpy.
"""
from __future__ import annotations

import numpy as np

# Speed of light [m/s] (reference: dataset_preprocessor/utils/radardsp.py:14).
C: float = 299_792_458.0

EXCLUDE_DIR_NAMES = ["calib"]

# Antenna PCB aperture constant used to map angle-FFT bins to physical angles
# (reference: dataset_preprocessor/constants.py:18).
WAVELENGTH_TO_APERTURE_RATIO: float = 0.4972

# The recorded lidar attributes are x, y, z, intensity
# (reference: dataset_preprocessor/constants.py:31).
NUMBER_RECORDING_ATTRIBUTES: int = 4


def quaternion_to_matrix(q) -> np.ndarray:
    """Rotation matrix from an ``[x, y, z, w]`` quaternion (scipy convention)."""
    x, y, z, w = (float(v) for v in q)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def rigid_transform(translation, quaternion) -> np.ndarray:
    """4x4 homogeneous transform from translation + [x,y,z,w] quaternion."""
    T = np.eye(4)
    T[:3, :3] = quaternion_to_matrix(quaternion)
    T[:3, 3] = translation
    return T


# ColoRadar extrinsics (calib/base_to_lidar.txt, calib/base_to_single_chip.txt;
# reference values: dataset_preprocessor/constants.py:8-16).
BASE_TO_RADAR = {
    "translation": [-0.145, 0.09, -0.025],
    "quaternion": [0.0, 0.0, 0.706825181105, 0.707388269167],
}
BASE_TO_LIDAR = {
    "translation": [-0.075, -0.02, 0.03618],
    "quaternion": [0.0, 0.0, 0.721382357437, -0.692536998563],
}

T_BASE_TO_RADAR = rigid_transform(**BASE_TO_RADAR)
T_BASE_TO_LIDAR = rigid_transform(**BASE_TO_LIDAR)
T_RADAR_TO_LIDAR = np.linalg.inv(T_BASE_TO_RADAR) @ T_BASE_TO_LIDAR


# HUST-Radar extrinsics (reference: dataset_preprocessor/constants.py:37-55).
def _hust_lidar_to_single_chip() -> np.ndarray:
    x_shift, y_shift = 41.7, 6.6
    x = 25.2 + 62.74 - 8
    y = 230 - (24.6 + x_shift)
    z = -(65.5 + y_shift) - 23
    T = np.eye(4)
    T[:3, 3] = np.array([x, y, z]) / 1000.0
    return T


HUST_T_LIDAR_TO_SINGLE_CHIP = _hust_lidar_to_single_chip()
HUST_T_SINGLE_CHIP_TO_LIDAR = np.linalg.inv(HUST_T_LIDAR_TO_SINGLE_CHIP)
HUST_DIR_NAMES = [
    "classroom_f404_20241219_0",
    "classroom_f404_20241219_1",
    "classroom_f404_20241219_2",
]
HUST_NUMBER_RECORDING_ATTRIBUTES = 4
