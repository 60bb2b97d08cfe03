from .base import (ArchConfig, ShapeSet, SHAPES, SHAPE_BY_NAME,
                   SUBQUADRATIC_FAMILIES, reduced)
from .registry import ARCHS, get_arch

__all__ = ["ArchConfig", "ShapeSet", "SHAPES", "SHAPE_BY_NAME",
           "SUBQUADRATIC_FAMILIES", "reduced", "ARCHS", "get_arch"]
