"""Datasets of the scoring path, held as numpy arrays in host memory."""

from . import mnist, synthetic
from .loader import ArrayLoader

__all__ = ["ArrayLoader", "mnist", "synthetic"]
