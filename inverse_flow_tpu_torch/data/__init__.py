"""Datasets of the ported paths, held as numpy arrays in host memory."""

from . import imagenet, mnist, synthetic
from .loader import ArrayLoader

__all__ = ["ArrayLoader", "imagenet", "mnist", "synthetic"]
