"""Deterministic data sources (:mod:`.pipeline`)."""
from .pipeline import (DataConfig, SyntheticLM, PatternLM, BinTokenFile,
                       make_source, device_batch)

__all__ = ["DataConfig", "SyntheticLM", "PatternLM", "BinTokenFile",
           "make_source", "device_batch"]
