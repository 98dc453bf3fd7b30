"""Host-side input pipeline of the port: image-folder datasets, the
shuffling/sharding loader with pinned device prefetch, transforms, and the
synthetic dataset generators."""

from .download import (download_data, make_synthetic_image_folder,
                       synthetic_batch)
from .image_folder import (
    ArrayDataset,
    CachedDataset,
    DataLoader,
    ImageFolderDataset,
    create_dataloaders,
    pad_batch,
    prefetch_to_device,
)
from .sampler import BlockReadahead, windowed_shuffle_order
from . import transforms

__all__ = [
    "ArrayDataset",
    "BlockReadahead",
    "CachedDataset",
    "DataLoader",
    "ImageFolderDataset",
    "create_dataloaders",
    "download_data",
    "make_synthetic_image_folder",
    "pad_batch",
    "prefetch_to_device",
    "synthetic_batch",
    "transforms",
    "windowed_shuffle_order",
]
