from .base import ArchConfig
from .registry import ARCHS, get_arch

__all__ = ["ArchConfig", "ARCHS", "get_arch"]
