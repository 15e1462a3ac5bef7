# Copy of trinity_tpu/index/__init__.py; only its imports name the port.
"""Index lifecycle layer (SURVEY §1 L1-L2): segment format, build, open, merge."""

from trinity_tpu_torch.index.builder import SegmentIndexSession
from trinity_tpu_torch.index.format import FieldStatistics, SegmentData

__all__ = ["SegmentIndexSession", "SegmentData", "FieldStatistics"]
