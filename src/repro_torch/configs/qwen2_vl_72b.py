"""Config for --arch qwen2-vl-72b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("qwen2-vl-72b")
