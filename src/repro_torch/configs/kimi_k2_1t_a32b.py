"""Config for --arch kimi-k2-1t-a32b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("kimi-k2-1t-a32b")
