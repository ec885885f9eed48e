"""Dataset factory (port of `dynosam_tpu/data/factory.py`, the analog of
`DataProviderFactory::Create`): loader selected by `--data_provider_type`,
KITTI=0; VIRTUAL_KITTI=1, CLUSTER=2, OMD=3 and ARIA=4 are ROADMAP.md
item 15."""

from __future__ import annotations

from .base import DatasetProvider
from .kitti import KittiDataset

_NOT_PORTED = {1: "VIRTUAL_KITTI", 2: "CLUSTER", 3: "OMD", 4: "ARIA"}


def create_dataset(provider_type: int, path: str, starting_frame: int = -1, ending_frame: int = -1,
                   **kwargs) -> DatasetProvider:
    if provider_type == 0:
        return KittiDataset(path, starting_frame, ending_frame, **kwargs)
    if provider_type in _NOT_PORTED:
        raise NotImplementedError(
            f"the {_NOT_PORTED[provider_type]} loader (data_provider_type={provider_type}) "
            "is ported by ROADMAP.md item 15")
    raise ValueError(f"unknown data_provider_type {provider_type}")
