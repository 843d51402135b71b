"""Pipelined scheduling cycles (parallel/pipeline.py)."""
