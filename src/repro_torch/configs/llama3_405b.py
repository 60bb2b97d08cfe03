"""Config for --arch llama3-405b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("llama3-405b")
