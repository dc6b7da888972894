"""Deterministic synthetic data streams: seeded token and image-feature
batches, shifted labels, a prefetch thread and placement on the device.

Port of ``repro/data/pipeline.py``.  ``TokenStream`` and ``ImageStream``
are numpy, copied as they are, so one seed gives the reference's tokens
and patches bit for bit.  ``TokenStream`` draws a noisy modular random
walk over the vocabulary, so there is a rule to learn and training
losses fall.

``make_batch_iterator`` yields torch tensors on the device.  Its
prefetch thread draws each batch, copies it into pinned host memory and
queues the copy to the card there, asynchronously (``non_blocking``) on
the current stream, so the consumer's kernels, queued after it, read it
in order and the consumer never waits on a pageable copy.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..kernels.config import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.model import SIGLIP_DIM


@dataclasses.dataclass
class TokenStream:
    """Synthetic next-token corpus.  Sequences follow a noisy modular
    random-walk over the vocab so there is real signal to learn."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_codebooks: int = 0
    signal: float = 0.9  # probability a token follows the deterministic rule

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        while True:
            shape = (self.batch_size, self.seq_len + 1)
            if self.n_codebooks:
                shape = (*shape, self.n_codebooks)
            toks = np.empty(shape, np.int32)
            toks[:, 0] = rng.integers(0, v, toks[:, 0].shape)
            steps = rng.integers(1, 7, toks[:, 0].shape)
            for t in range(1, self.seq_len + 1):
                follow = rng.random(toks[:, 0].shape) < self.signal
                walk = (toks[:, t - 1] + steps) % v
                noise = rng.integers(0, v, toks[:, 0].shape)
                toks[:, t] = np.where(follow, walk, noise)
            yield {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
            }


@dataclasses.dataclass
class ImageStream:
    """Stub modality frontend output streams (paligemma patches)."""

    batch_size: int
    n_patches: int
    feature_dim: int = SIGLIP_DIM
    seed: int = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        while True:
            yield rng.standard_normal(
                (self.batch_size, self.n_patches, self.feature_dim)
            ).astype(np.float32)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy batch array on ``dev``: int64 token ids (the port indexes
    with them) or f32 features; through pinned memory to a CUDA device."""
    t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def make_batch_iterator(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    device: DeviceLike = None,
    prefetch: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches ready for the train step: ``tokens`` and ``labels`` [B, S]
    ([B, S, K] with codebooks, int64), and ``patches`` [B, n_patches,
    1152] f32 for a vision prefix, on ``device`` (``None`` means the card;
    a host without one raises).  With ``prefetch > 0`` a daemon thread
    keeps that many batches ready; it ends once the consumer closes the
    iterator (or drops it), and an error in it is raised to the consumer
    at its next batch."""
    dev = resolve_device(device)
    tokens = iter(
        TokenStream(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            batch_size=batch_size,
            seed=seed,
            n_codebooks=cfg.n_codebooks,
        )
    )
    patches = (
        iter(ImageStream(batch_size, cfg.n_patches, seed=seed + 1))
        if cfg.n_patches
        else None
    )

    def gen():
        for batch in tokens:
            out = dict(batch)
            if patches is not None:
                out["patches"] = next(patches)
            yield {k: _to_device(a, dev) for k, a in out.items()}

    if prefetch <= 0:
        return gen()

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen():
                if not put(item):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    threading.Thread(target=worker, daemon=True, name="batch-prefetch").start()

    def prefetched():
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    return prefetched()
