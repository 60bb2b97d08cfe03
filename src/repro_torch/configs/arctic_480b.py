"""Config for --arch arctic-480b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("arctic-480b")
