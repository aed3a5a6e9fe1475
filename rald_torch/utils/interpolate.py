"""Pose interpolation: SLERP rotations + linear translations to target
timestamps (the port's own copy of ``rald_tpu/utils/interpolate.py``;
reference ``utils/interpolate.py:21-51``; unused by the mains but part of
the public utility surface)."""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def interp_pose(
    poses: np.ndarray, timestamps: np.ndarray, target_timestamps: np.ndarray
) -> np.ndarray:
    """Interpolate 4x4 poses at ``target_timestamps``.

    ``poses``: (N, 4, 4) at ``timestamps`` (N,), monotonically increasing.
    Targets are clipped to the source time range (matching scipy Slerp's
    domain requirement). Returns (M, 4, 4).
    """
    poses = np.asarray(poses, np.float64)
    timestamps = np.asarray(timestamps, np.float64)
    target = np.clip(np.asarray(target_timestamps, np.float64), timestamps[0], timestamps[-1])

    rots = Rotation.from_matrix(poses[:, :3, :3])
    slerp = Slerp(timestamps, rots)
    r_out = slerp(target).as_matrix()

    t_out = np.stack(
        [np.interp(target, timestamps, poses[:, i, 3]) for i in range(3)], axis=1
    )

    out = np.tile(np.eye(4), (len(target), 1, 1))
    out[:, :3, :3] = r_out
    out[:, :3, 3] = t_out
    return out
