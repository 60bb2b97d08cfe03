"""Config for --arch whisper-large-v3 (see registry.py for the source citation)."""
from .registry import get_arch

CONFIG = get_arch("whisper-large-v3")
