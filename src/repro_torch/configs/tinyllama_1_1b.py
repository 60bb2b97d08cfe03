"""Config for --arch tinyllama-1.1b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("tinyllama-1.1b")
