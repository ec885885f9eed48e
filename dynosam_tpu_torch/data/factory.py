"""Dataset factory (port of `dynosam_tpu/data/factory.py`, the analog of
`DataProviderFactory::Create`): loader selected by `--data_provider_type`,
KITTI=0, VIRTUAL_KITTI=1, CLUSTER=2, OMD=3, ARIA=4.  The frame range is
passed by keyword to every loader (the JAX factory passes it by position,
which lands in the Virtual KITTI loader's scene arguments).  `device` is
the loader's device for rectification and device-side stereo."""

from __future__ import annotations

from .base import DatasetProvider


def create_dataset(provider_type: int, path: str, starting_frame: int = -1, ending_frame: int = -1,
                   device=None, **kwargs) -> DatasetProvider:
    rng = dict(starting_frame=starting_frame, ending_frame=ending_frame, device=device)
    if provider_type == 0:
        from .kitti import KittiDataset

        return KittiDataset(path, **rng, **kwargs)
    if provider_type == 1:
        from .vkitti import VirtualKittiDataset

        return VirtualKittiDataset(path, **rng, **kwargs)
    if provider_type == 2:
        from .cluster import ClusterSlamDataset

        return ClusterSlamDataset(path, **rng, **kwargs)
    if provider_type == 3:
        from .omd import OMDDataset

        return OMDDataset(path, **rng, **kwargs)
    if provider_type == 4:
        from .aria import ProjectAriaDataset

        return ProjectAriaDataset(path, **rng, **kwargs)
    raise ValueError(f"unknown data_provider_type {provider_type}")
