"""Launch accounting of the kernel wrappers, kept true under CUDA graphs.

Each kernel module keeps its own counters (``launches`` and
``variant_launches``, and the backward's) under its ``count_lock``, and
its wrapper adds one through :func:`count` where it launches a kernel.  A
call made while a CUDA graph is being captured launches nothing: the
capture records it on the thread's tape instead (:func:`recording`), and
every replay of the graph adds the tape to the counters
(:func:`replayed`).  So ``ops.launch_counts()`` and ``ops.variant_counts()``
count launches on the device whether a path runs eagerly or as graph
replays.  The tape is per thread: another thread's eager launches during a
capture count as they happen.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Tuple

# (module, total counter, per-variant counter, variant) -> launches
Tape = Dict[Tuple[object, str, str, str], int]

_tls = threading.local()


def _add(mod, total: str, per: str, variant: str, n: int) -> None:
    with mod.count_lock:
        setattr(mod, total, getattr(mod, total) + n)
        getattr(mod, per)[variant] += n


def count(mod, variant: str, total: str = "launches",
          per: str = "variant_launches") -> None:
    """One launch of ``variant`` by module ``mod``'s wrapper: added to its
    counters, or to the capturing thread's tape."""
    tape = getattr(_tls, "tape", None)
    if tape is None:
        _add(mod, total, per, variant, 1)
    else:
        key = (mod, total, per, variant)
        tape[key] = tape.get(key, 0) + 1


@contextlib.contextmanager
def recording() -> Iterator[Tape]:
    """Inside the block this thread's wrapper calls go on the yielded tape
    instead of the counters (a graph capture launches nothing)."""
    prev = getattr(_tls, "tape", None)
    tape: Tape = {}
    _tls.tape = tape
    try:
        yield tape
    finally:
        _tls.tape = prev


def replayed(tape: Tape) -> None:
    """Add one replay of a captured tape to the counters."""
    for (mod, total, per, variant), n in tape.items():
        _add(mod, total, per, variant, n)
