"""Datasets of the ported paths, held as numpy arrays in host memory."""

from . import (cifar10, digits, galaxy, imagenet, mnist, patches, synthetic,
               toy)
from .loader import ArrayLoader

__all__ = ["ArrayLoader", "cifar10", "digits", "galaxy", "imagenet", "mnist",
           "patches", "synthetic", "toy"]
