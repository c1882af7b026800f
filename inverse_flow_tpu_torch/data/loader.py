"""In-memory batch loader with per-epoch shuffling and augmentation.

Port of ``inverse_flow_tpu/data/loader.py``: ``ArrayLoader`` with its
``augment`` hook and its native prefetch thread (:mod:`..native`, the
same C++ worker and the same rule for when it runs), and the
augmentations ``random_flip_lr``, ``pad_translate_crop``,
``affine_translate_crop`` and ``compose``. Batches are float32 numpy
arrays of raw 0-255 values; the experiment moves them to its device. An
augmentation draws from the loader's own ``RandomState`` after the
shuffle, as the JAX loader's does, so the same seed gives the same
batches as JAX's on either path.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class ArrayLoader:
    def __init__(self, data: np.ndarray, batch_size: int, shuffle=False,
                 seed: int = 0, drop_last=True,
                 augment: Optional[Callable] = None,
                 native_prefetch: Optional[bool] = None):
        """``native_prefetch``: gather and shuffle the batches on the
        native library's C++ thread (:class:`..native.NativePrefetcher`,
        shuffled by its own generator from ``seed``). None: when the data
        are shuffled, dropped to full batches, losslessly uint8 and the
        library is available, as JAX decides; True raises where it cannot
        be honoured."""
        if data.ndim < 2:
            raise ValueError(f"ArrayLoader: data of shape {data.shape} has "
                             f"no batch axis")
        self.data = data
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.augment = augment
        self._rng = np.random.RandomState(seed)
        self._seed = seed
        self.data_shape = tuple(data.shape[1:])
        self._prefetcher = None
        if native_prefetch or native_prefetch is None:
            self._maybe_init_prefetch(forced=bool(native_prefetch))

    def _maybe_init_prefetch(self, forced: bool):
        from .. import native
        d = self.data
        # every value integral in [0, 255], over the whole array: the
        # uint8 cast would truncate or wrap anything else
        is_u8 = (d.dtype == np.uint8
                 or (np.issubdtype(d.dtype, np.floating)
                     and d.size and float(d.min()) >= 0
                     and float(d.max()) <= 255
                     and np.array_equal(d, np.floor(d))))
        if forced and not is_u8:
            raise ValueError(
                "native_prefetch=True requires losslessly uint8-"
                "convertible data (integral values in [0, 255]); the "
                "uint8 cast would truncate/wrap this array")
        # the C++ worker assembles full batches only
        if d.shape[0] < self.batch_size:
            if forced:
                raise ValueError(
                    f"native_prefetch=True needs at least one full batch "
                    f"({d.shape[0]} samples < batch_size="
                    f"{self.batch_size})")
            return
        if forced and not self.drop_last and d.shape[0] % self.batch_size:
            raise ValueError(
                "native_prefetch=True drops the final partial batch, "
                "contradicting drop_last=False for this data size")
        if not ((self.shuffle and self.drop_last and is_u8) or forced):
            return
        if not native.available():
            if forced:
                raise RuntimeError("native prefetcher unavailable")
            return
        self._prefetcher = native.NativePrefetcher(
            d.astype(np.uint8, copy=False), self.batch_size,
            shuffle=self.shuffle, seed=self._seed)

    def __len__(self):
        n = self.data.shape[0] // self.batch_size
        if not self.drop_last and self.data.shape[0] % self.batch_size:
            n += 1
        return max(1, n)

    def __iter__(self):
        if self._prefetcher is not None:
            for _ in range(self._prefetcher.batches_per_epoch):
                batch = self._prefetcher.next().astype(np.float32)
                if self.augment is not None:
                    batch = self.augment(batch, self._rng)
                yield batch
            return
        idx = np.arange(self.data.shape[0])
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = (len(idx) - self.batch_size + 1 if self.drop_last
                else len(idx))
        for start in range(0, max(1, stop), self.batch_size):
            batch = self.data[idx[start:start + self.batch_size]].astype(
                np.float32)
            if self.augment is not None:
                batch = self.augment(batch, self._rng)
            yield batch


def random_flip_lr(batch, rng):
    """Mirror each image left-right with probability 1/2."""
    flip = rng.rand(batch.shape[0]) < 0.5
    batch[flip] = batch[flip][..., ::-1]
    return batch


def _crops(padded, oy, ox, h, w):
    out = np.empty(padded.shape[:2] + (h, w), padded.dtype)
    for i in range(padded.shape[0]):
        out[i] = padded[i, :, oy[i]:oy[i] + h, ox[i]:ox[i] + w]
    return out


def pad_translate_crop(pad: int, mode: str = "edge"):
    """Pad by ``pad`` (``np.pad`` ``mode``), then crop back to the original
    size at integer offsets uniform on {0..2*pad} per axis (``mode=
    'reflect'``, ``pad=1``: the reference's MNIST augmentation)."""

    def fn(batch, rng):
        b, _, h, w = batch.shape
        padded = np.pad(batch, ((0, 0), (0, 0), (pad, pad), (pad, pad)),
                        mode=mode)
        offs = rng.randint(0, 2 * pad + 1, size=(b, 2))
        return _crops(padded, offs[:, 0], offs[:, 1], h, w)

    return fn


def affine_translate_crop(pad: int, translate_frac: float = 0.04):
    """Edge-pad by ``pad``, shift by an integer translate, center-crop: the
    reference's CIFAR pipeline. The shift is a uniform draw on
    ``[-f*(W+2p), f*(W+2p)]`` rounded to a pixel (x first, then y), clipped
    to the pad, so for f=0.04, p=2 it is in {-1, 0, 1}."""

    def fn(batch, rng):
        b, _, h, w = batch.shape
        padded = np.pad(batch, ((0, 0), (0, 0), (pad, pad), (pad, pad)),
                        mode="edge")
        hp, wp = h + 2 * pad, w + 2 * pad
        dx = np.round(rng.uniform(-translate_frac * wp, translate_frac * wp,
                                  size=b)).astype(int)
        dy = np.round(rng.uniform(-translate_frac * hp, translate_frac * hp,
                                  size=b)).astype(int)
        np.clip(dx, -pad, pad, out=dx)
        np.clip(dy, -pad, pad, out=dy)
        return _crops(padded, pad - dy, pad - dx, h, w)

    return fn


def compose(*fns):
    """The augmentations ``fns`` in order, on one ``RandomState``."""
    def fn(batch, rng):
        for f in fns:
            batch = f(batch, rng)
        return batch

    return fn
