"""HUST-Radar dataset variant: the port's own copy of
``rald_tpu/data/hustradar.py``.

Parity with reference ``datasets/hustRadar/hustRadar_dataset.py`` (:8-157):
same pipeline as ColoRadar but radar cubes live in a flat ``rae_map/*.npy``
directory (numerically-sorted stems) instead of
``single_chip/radarcube_raw/*.bin``.
"""
from __future__ import annotations

import numpy as np

from rald_torch.data.coloradar import ColoRadarDataset


class HUSTRadarDataset(ColoRadarDataset):
    RADAR_DIR = {"scRadar": "rae_map", "ccRadar": "rae_map"}

    def _build_radar_list(self):
        # rae_map/*.npy with numeric sort on stems
        # (reference: hustRadar_dataset.py:106-114).
        self.radar_path_list = []
        for seq in self.seq_list:
            files = list((self.root_dir / seq / "rae_map").glob("*.npy"))
            files.sort(key=lambda x: int(x.stem))
            self.radar_path_list.extend(files)

    def load_radarcube(self, idx):
        path = self.radar_path_list[idx]
        cube = np.load(path, allow_pickle=True)
        r = self.config.radar
        cube = cube.reshape(r.input_r_dim, r.input_a_dim, r.input_e_dim, -1)
        return cube, path
