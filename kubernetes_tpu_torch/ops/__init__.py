"""Filters, scores and the commit scan, with their CUDA kernels."""

from .assign import schedule_batch, schedule_scan_plain
from .scores import DEFAULT_SCORE_CONFIG, ScoreConfig, infer_score_config

__all__ = [
    "DEFAULT_SCORE_CONFIG", "ScoreConfig", "infer_score_config",
    "schedule_batch", "schedule_scan_plain",
]
