"""Config for --arch zamba2-2.7b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("zamba2-2.7b")
