"""In-tree plugins (cpu.py: the per-pod cycle's plugins and the CPU PostFilter)."""
from .cpu import default_plugins, default_registry  # noqa: F401
