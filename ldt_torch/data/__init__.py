"""Host-side data pipeline (counterpart of ldt_tpu/data): the PC15k
ShapeNet clouds as numpy batches, prefetched on a thread."""

from ldt_torch.data.loader import DataLoader
from ldt_torch.data.shapenet55 import (
    ShapeNet15kPointClouds,
    cate_to_synsetid,
    get_data_loaders,
    get_datasets,
    synsetid_to_cate,
)

__all__ = [
    "DataLoader",
    "ShapeNet15kPointClouds",
    "cate_to_synsetid",
    "get_data_loaders",
    "get_datasets",
    "synsetid_to_cate",
]
