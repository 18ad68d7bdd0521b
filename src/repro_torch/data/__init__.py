"""The data pipeline of the port: :mod:`.pipeline`."""

from .pipeline import MarkovLMDataset, Prefetcher, make_batch_fn

__all__ = ["MarkovLMDataset", "Prefetcher", "make_batch_fn"]
