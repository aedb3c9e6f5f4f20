"""CUDA graphs: the port's counterpart of the reference's ``jax.jit``.

The reference serves each sub-network from a compiled executable per
``(SubnetSpec, bucket)`` and runs the LM's prefill and decode step as
compiled functions of fixed shapes.  The port runs eagerly, and on the
card an eager forward spends most of its wall time issuing launches from
Python.  :class:`Graph` captures one function of fixed shapes once into a
``torch.cuda.CUDAGraph`` and replays it: the same kernels, in the same
order, with the same arguments, launched by one call.

How a graph is made and used:

* its inputs are static device tensors that :meth:`Graph.run` copies new
  values into; it returns copies of the static outputs, which the next
  replay overwrites;
* before the capture the function runs once eagerly on the capture stream,
  so nothing is made lazily inside the capture: the kernels' build and
  launchers, K1's width tensors, K2's key-count tensors, K1's tile
  tickets, cuBLAS handles (a capture that would make one raises);
* each owner (a ``DynamicServer``, an LM run) gives its graphs one memory
  pool (:func:`new_pool`) and one capture stream; captures are
  serialised process-wide, and an owner replays its graphs on one stream,
  so graphs sharing a pool never run at once;
* a lock per graph covers copy-in, replay and copy-out (:meth:`run`):
  a server's collector thread and a caller's ``infer``/``measure`` may
  replay the same graph;
* the kernel launches seen during the capture are recorded
  (``kernels/counting.py``) and added to the kernels' counters on every
  replay, so launch counts stay counts of launches on the device;
* a failed capture or replay raises: there is no eager fallback on the
  card.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import counting

_capture_lock = threading.Lock()    # one capture at a time in the process


def new_pool() -> Tuple[int, int]:
    """A fresh graph memory pool for one owner's graphs."""
    return torch.cuda.graph_pool_handle()


def pool_bytes(pool) -> Optional[int]:
    """Device memory reserved by ``pool`` (its segments in the caching
    allocator's snapshot), or None where the snapshot does not say."""
    total, seen = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            return None
        if tuple(pid) == tuple(pool):
            total += seg["total_size"]
            seen = True
    return total if seen else 0


class Graph:
    """``fn(*inputs)`` captured once over static input tensors.

    ``inputs`` are device tensors the graph reads in place; ``fn`` returns
    a tensor or a tuple of tensors (the static outputs).  ``pool`` and
    ``stream`` are the owner's (see the module note)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], *,
                 pool, stream: torch.cuda.Stream):
        self.inputs = tuple(inputs)
        self.lock = threading.Lock()
        self.graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            cur = torch.cuda.current_stream()
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                fn(*self.inputs)            # the eager warm-up
                stream.synchronize()
                with counting.recording() as tape:
                    self.graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local")
                    try:
                        out = fn(*self.inputs)
                    except BaseException:
                        try:
                            self.graph.capture_end()
                        except RuntimeError:
                            pass            # the capture is void already
                        raise
                    self.graph.capture_end()
            cur.wait_stream(stream)
        self.outputs = out
        self.tape = tape

    def replay(self) -> None:
        """Launch the captured work on the current stream and count its
        launches.  The caller holds :attr:`lock` from copy-in to copy-out."""
        self.graph.replay()
        counting.replayed(self.tape)

    def run(self, *inputs: torch.Tensor):
        """Copy ``inputs`` into the static inputs (non-blocking from pinned
        host memory), replay, and return copies of the outputs made on the
        stream (the next replay overwrites the static ones)."""
        with self.lock:
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src, non_blocking=True)
            self.replay()
            if isinstance(self.outputs, torch.Tensor):
                return self.outputs.clone()
            return tuple(o.clone() for o in self.outputs)
