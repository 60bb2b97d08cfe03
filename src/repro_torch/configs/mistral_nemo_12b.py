"""Config for --arch mistral-nemo-12b (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("mistral-nemo-12b")
