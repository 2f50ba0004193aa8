"""Data generators of the port."""
from .grf import grf_2d  # noqa: F401
