"""Data pipeline: deterministic synthetic streams and a token-file reader.

Counterpart of the reference ``data/pipeline.py`` in numpy, batch for batch
byte-identical to it.  Restart semantics: every batch is a pure function of
(seed, step), so a job restored at step N regenerates exactly the batches
it would have seen -- deterministic skip-ahead without data-loader state in
the checkpoint.  Per-process sharding slices the global batch by the
``torch.distributed`` rank (one process: the whole batch).
:func:`to_device` moves a batch to the card with pinned, non-blocking
copies.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


def _process() -> tuple:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(global_batch: int) -> slice:
    """This process's slice of the global batch."""
    i, n = _process()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def microbatch_rows(global_batch: int, accum: int, n_blocks: int,
                    block: int) -> np.ndarray:
    """The rows of a global batch that data block ``block`` of
    ``n_blocks`` holds when a step runs as ``accum`` microbatches, in
    order: its block of microbatch 0, then of microbatch 1, ...  The
    reference's microbatch i is the global batch's contiguous chunk i
    (its ``_accum_grads``), which GSPMD splits over the batch axes; a
    rank's contiguous block of the whole batch, cut into microbatches,
    would route other tokens together."""
    if global_batch % (accum * n_blocks):
        raise ValueError(f"batch {global_batch} does not split into "
                         f"{accum} microbatches over {n_blocks} blocks")
    mb, per = global_batch // accum, global_batch // (accum * n_blocks)
    return np.concatenate([np.arange(i * mb + block * per,
                                     i * mb + (block + 1) * per)
                           for i in range(accum)])


def synthetic_lm_batches(*, global_batch: int, seq_len: int, vocab: int,
                         seed: int = 0, start_step: int = 0,
                         rows=None) -> Iterator[dict]:
    """Zipf-ish token stream with next-token labels (learnable structure:
    token t+1 correlates with token t so loss visibly decreases).
    ``rows`` (e.g. :func:`microbatch_rows`) picks a rank's rows of each
    global batch, the same bytes; by default this process's slice."""
    sl = host_shard(global_batch) if rows is None else rows
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        base = rng.zipf(1.5, size=(global_batch, seq_len + 1)) % vocab
        drift = np.cumsum(rng.integers(0, 3, size=(global_batch, seq_len + 1)),
                          axis=1)
        toks = ((base + drift) % vocab).astype(np.int32)
        yield {"tokens": toks[sl, :-1], "labels": toks[sl, 1:]}
        step += 1


def synthetic_image_batches(*, global_batch: int, img_res: int,
                            n_classes: int, seed: int = 0,
                            start_step: int = 0,
                            rows=None) -> Iterator[dict]:
    """Class-conditional blob images -- a small model can actually fit
    them, so supernet-training examples show real accuracy orderings.
    ``rows`` (e.g. :func:`microbatch_rows`) picks a rank's images of each
    global batch, the same bytes; by default this process's slice."""
    sl = host_shard(global_batch) if rows is None else rows
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        labels = rng.integers(0, n_classes, size=global_batch)
        imgs = rng.normal(0, 0.3, size=(global_batch, img_res, img_res, 3))
        # class-dependent quadrant brightness pattern
        q = img_res // 2
        for c in range(n_classes):
            m = labels == c
            gy, gx = (c % 4) // 2, (c % 4) % 2
            imgs[m, gy * q:(gy + 1) * q, gx * q:(gx + 1) * q, c % 3] += \
                1.0 + 0.25 * (c // 4)
        yield {"images": imgs[sl].astype(np.float32),
               "labels": labels[sl].astype(np.int32)}
        step += 1


def synthetic_label_batches(*, global_batch: int, n_classes: int,
                            seed: int = 0, start_step: int = 0
                            ) -> Iterator[dict]:
    """The labels of :func:`synthetic_image_batches` (its generator draws
    them before the images), without drawing the images: the class
    conditioning of the diffusion launcher, which makes its own latents."""
    sl = host_shard(global_batch)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        labels = rng.integers(0, n_classes, size=global_batch)
        yield {"labels": labels[sl].astype(np.int32)}
        step += 1


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays (in a dict, or in dicts within it) -> tensors on
    ``device``; to the card through pinned host memory with non-blocking
    copies (the step that reads them is queued behind the copies on the
    same stream)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def memmap_token_batches(path: str, *, global_batch: int, seq_len: int,
                         dtype=np.int32, start_step: int = 0
                         ) -> Iterator[dict]:
    """Production-style binary token file reader (np.memmap, zero-copy),
    deterministic stride order, per-host sharded: step i reads the i-th
    block of ``global_batch * (seq_len + 1)`` tokens (wrapping), tokens
    and next-token labels of each row.  The reference's reader."""
    data = np.memmap(path, dtype=dtype, mode="r")
    tokens_per_step = global_batch * (seq_len + 1)
    n_steps = len(data) // tokens_per_step
    sl = host_shard(global_batch)
    step = start_step
    while True:
        i = step % max(n_steps, 1)
        chunk = np.asarray(data[i * tokens_per_step:(i + 1) * tokens_per_step])
        chunk = chunk.reshape(global_batch, seq_len + 1)
        yield {"tokens": chunk[sl, :-1].astype(np.int32),
               "labels": chunk[sl, 1:].astype(np.int32)}
        step += 1


class Prefetcher:
    """Background-thread prefetch queue over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        try:
            for item in self._it:
                # a bounded put, so close() is seen while the queue is full
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 -- surface in consumer
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None and self._err is not None:
            raise self._err
        return item

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
