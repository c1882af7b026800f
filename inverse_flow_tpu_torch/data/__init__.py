"""Datasets of the ported paths, held as numpy arrays in host memory."""

from . import cifar10, digits, imagenet, mnist, patches, synthetic
from .loader import ArrayLoader

__all__ = ["ArrayLoader", "cifar10", "digits", "imagenet", "mnist",
           "patches", "synthetic"]
