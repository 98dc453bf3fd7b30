"""Host-side input pipeline of the port: image-folder datasets, packed
uint8 shards with array-space augmentation, CIFAR-10, the
shuffling/sharding loader with pinned device prefetch, transforms, and the
synthetic dataset generators."""

from .cifar import (CIFAR10_CLASSES, ResizedArrayDataset, load_cifar10,
                    make_fake_cifar10)
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
from .imagenet import (PackedShardDataset, create_packed_dataloaders,
                       pack_image_folder, train_augment_transform)
from .sampler import BlockReadahead, windowed_shuffle_order
from . import transforms

__all__ = [
    "ArrayDataset",
    "BlockReadahead",
    "CIFAR10_CLASSES",
    "CachedDataset",
    "DataLoader",
    "ImageFolderDataset",
    "PackedShardDataset",
    "ResizedArrayDataset",
    "create_dataloaders",
    "create_packed_dataloaders",
    "download_data",
    "load_cifar10",
    "make_fake_cifar10",
    "make_synthetic_image_folder",
    "pack_image_folder",
    "pad_batch",
    "prefetch_to_device",
    "synthetic_batch",
    "train_augment_transform",
    "transforms",
    "windowed_shuffle_order",
]
