"""The deterministic synthetic data pipeline of the port (counterpart of
``repro.data``)."""
from .pipeline import DataConfig, Prefetcher, batch_iterator, synthetic_batch

__all__ = ["DataConfig", "Prefetcher", "batch_iterator", "synthetic_batch"]
