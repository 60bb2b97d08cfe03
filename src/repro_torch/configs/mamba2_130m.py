"""Config for --arch mamba2-130m (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("mamba2-130m")
