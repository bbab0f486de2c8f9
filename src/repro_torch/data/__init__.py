"""The training data pipeline of the port (port of `repro.data`)."""
from .pipeline import DataConfig, SyntheticTokenDataset, make_train_iterator

__all__ = ["DataConfig", "SyntheticTokenDataset", "make_train_iterator"]
