"""Data parallelism of the PyTorch port (see :mod:`.dist`)."""

from .dist import DpContext, allreduce_metric_pairs, launch

__all__ = ["DpContext", "allreduce_metric_pairs", "launch"]
