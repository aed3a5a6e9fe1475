"""String-keyed dataset construction (``rald_tpu/data/registry.py``; reference
``datasets/build_dataset.py:4-51``)."""
from __future__ import annotations

from rald_torch.data.coloradar import ColoRadarDataset
from rald_torch.data.hustradar import HUSTRadarDataset

_DATASETS = {
    "AlignedColoRadar": ColoRadarDataset,
    "HUSTRadarDataset": HUSTRadarDataset,
}


def get_dataset(config, mode: str, seed: int = 0):
    name = config.dataset_name
    if name not in _DATASETS:
        raise ValueError(f"Invalid dataset {name}")
    cls = _DATASETS[name]
    radar_type = config.get("radar_type", "scRadar") if name == "AlignedColoRadar" else "scRadar"
    return cls(
        root_dir=config.root_dir,
        config=config,
        radar_type=radar_type,
        loader_type=mode,
        seed=seed,
    )
