"""The CPU reference's per-node helpers (reference.py)."""
