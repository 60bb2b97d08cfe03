"""Config for --arch glm4-9b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("glm4-9b")
