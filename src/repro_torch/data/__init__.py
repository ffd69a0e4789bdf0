from .synthetic import SyntheticConfig, batches, make_batch

__all__ = ["SyntheticConfig", "batches", "make_batch"]
