"""Input pipeline: memmap token datasets and a prefetching loader."""

from faabric_tpu_torch.data.loader import DataLoader, TokenDataset

__all__ = ["DataLoader", "TokenDataset"]
