"""Synthetic datasets (no real corpora or images offline), deterministic
in (seed, step), each with learnable structure:

  * LM: order-2 Markov token chains over the model vocab;
  * classification: class-conditioned Gaussian blobs rendered as images
    (the stand-in for Flower-102);
  * segmentation: images with a random bright disc; mask = its support
    (the stand-in for Carvana).

Copies of the JAX package's ``data/synthetic.py``: for the same seed they
give the same numpy arrays bit for bit, so both packages train on
identical data. Images are NHWC float32, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class LMDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    order: int = 2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse markov transition: each (prev) state prefers ~8 next tokens
        self._k = min(8, self.vocab_size)
        self._table = rng.integers(
            0, self.vocab_size, size=(min(self.vocab_size, 4096), self._k))

    def batch(self, batch_size: int, seed: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, seed))
        n = self._table.shape[0]
        toks = np.empty((batch_size, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, batch_size)
        for t in range(1, self.seq_len + 1):
            prev = toks[:, t - 1] % n
            choice = rng.integers(0, self._k, batch_size)
            nxt = self._table[prev, choice]
            noise = rng.random(batch_size) < 0.05
            nxt = np.where(noise, rng.integers(0, self.vocab_size, batch_size), nxt)
            toks[:, t] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class ClassificationDataset:
    """Class-conditioned structured images; ``image_size`` is the paper's
    batch-size/image-size knob (Table 1)."""
    num_classes: int
    image_size: int
    channels: int = 3
    seed: int = 0
    train_size: int = 2048

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._proto = rng.normal(
            0, 1, (self.num_classes, self.image_size, self.image_size,
                   self.channels)).astype(np.float32)
        self._labels = rng.integers(0, self.num_classes, self.train_size)

    def batch(self, batch_size: int, seed: int, train: bool = True
              ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, seed, int(train)))
        labels = rng.integers(0, self.num_classes, batch_size)
        x = (self._proto[labels]
             + rng.normal(0, 0.9, (batch_size, self.image_size,
                                   self.image_size, self.channels)
                          ).astype(np.float32))
        return {"image": x, "label": labels.astype(np.int32)}


@dataclasses.dataclass
class SegmentationDataset:
    """Images with a random bright disc; mask = its support."""
    image_size: int
    channels: int = 3
    seed: int = 0

    def batch(self, batch_size: int, seed: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, seed))
        s = self.image_size
        x = rng.normal(0, 0.4, (batch_size, s, s, self.channels)
                       ).astype(np.float32)
        mask = np.zeros((batch_size, s, s, 1), np.float32)
        yy, xx = np.mgrid[0:s, 0:s]
        for i in range(batch_size):
            cx, cy = rng.integers(s // 4, 3 * s // 4, 2)
            r = rng.integers(max(2, s // 8), max(3, s // 3))
            disc = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            mask[i, disc, 0] = 1.0
            x[i, disc] += 1.5
        return {"image": x, "mask": mask}


def minibatch_stream(dataset, batch_size: int, num_batches: int,
                     start_seed: int = 0, **kw
                     ) -> Iterator[Dict[str, np.ndarray]]:
    for i in range(num_batches):
        yield dataset.batch(batch_size, start_seed + i, **kw)
