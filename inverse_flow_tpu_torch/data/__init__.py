"""Datasets of the ported paths, held as numpy arrays in host memory."""

from . import digits, imagenet, mnist, patches, synthetic
from .loader import ArrayLoader

__all__ = ["ArrayLoader", "digits", "imagenet", "mnist", "patches",
           "synthetic"]
