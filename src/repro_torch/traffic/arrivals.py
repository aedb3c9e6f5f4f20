"""Seeded, deterministic arrival-process generators.

Every generator maps (parameters, seed) -> a sorted array of arrival
timestamps in seconds; the same seed always yields the identical
inter-arrival sequence (asserted in tests), so SLO-policy comparisons run
on byte-identical traces.  Four processes cover the paper's
phase-changing workload conditions:

* :func:`poisson`  — memoryless steady load;
* :func:`onoff`    — bursty interrupted-Poisson (ON windows at full rate,
  OFF windows silent or trickling), the worst case for a clock-driven
  arbiter and the one preemption exists for;
* :func:`diurnal`  — sinusoidal ramp via thinning, the slow phase change
  a day of user traffic produces;
* :func:`replay`   — trace replay from a recorded schedule (list or JSON
  file written by :func:`save_schedule`).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np


def poisson(rate_rps: float, horizon_s: float, *, seed: int = 0
            ) -> np.ndarray:
    """Homogeneous Poisson arrivals: exponential inter-arrival times."""
    if rate_rps <= 0 or horizon_s <= 0:
        return np.empty(0)
    rng = np.random.default_rng(seed)
    ts: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_rps)
        if t >= horizon_s:
            break
        ts.append(t)
    return np.asarray(ts)


def onoff(rate_rps: float, horizon_s: float, *, on_s: float = 1.0,
          off_s: float = 1.0, off_rate_rps: float = 0.0, seed: int = 0
          ) -> np.ndarray:
    """Bursty ON-OFF arrivals (interrupted Poisson process).

    Alternating windows: ON at ``rate_rps`` for ``on_s`` seconds, OFF at
    ``off_rate_rps`` (default silent) for ``off_s``.  One rng drawn
    sequentially across windows keeps the whole trace seed-deterministic.
    """
    rng = np.random.default_rng(seed)
    ts: List[float] = []
    t0 = 0.0
    on = True
    while t0 < horizon_s:
        span = on_s if on else off_s
        rate = rate_rps if on else off_rate_rps
        if rate > 0:
            t = t0
            while True:
                t += rng.exponential(1.0 / rate)
                if t >= min(t0 + span, horizon_s):
                    break
                ts.append(t)
        t0 += span
        on = not on
    return np.asarray(ts)


def diurnal(peak_rps: float, horizon_s: float, *, period_s: float = 60.0,
            floor: float = 0.1, seed: int = 0) -> np.ndarray:
    """Sinusoidal ramp via thinning: rate(t) sweeps floor..1 x peak.

    rate(t) = peak * (floor + (1 - floor) * (1 - cos(2*pi*t/period)) / 2)
    — starts at the floor, peaks mid-period.  Thinning a peak-rate Poisson
    stream keeps determinism exact.
    """
    rng = np.random.default_rng(seed)
    ts: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak_rps)
        if t >= horizon_s:
            break
        frac = floor + (1.0 - floor) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * t / period_s))
        if rng.uniform() < frac:
            ts.append(t)
    return np.asarray(ts)


def replay(schedule: Union[str, Sequence[float]]) -> np.ndarray:
    """Trace replay: a recorded schedule (sequence of seconds, or a JSON
    path written by :func:`save_schedule`) becomes an arrival stream."""
    if isinstance(schedule, str):
        loaded = load_schedule(schedule)
        if isinstance(loaded, dict):
            raise ValueError(
                f"{schedule}: multi-stream schedule; pass one of its "
                f"streams ({sorted(loaded)}) to replay()")
        return loaded
    ts = np.asarray(list(schedule), dtype=float)
    return np.sort(ts)


def save_schedule(path: str,
                  arrivals: Union[Sequence[float],
                                  Dict[str, Sequence[float]]], *,
                  meta: dict = None) -> None:
    """Record a schedule for later replay (the ``--trace`` file format).

    ``arrivals`` is one stream (sequence of seconds) or a dict of
    per-class streams — what ``drive_live(record_path=...)`` records.
    JSON floats round-trip exactly, so a replayed schedule is
    bit-identical to the recorded one.
    """
    if isinstance(arrivals, dict):
        payload = {"streams": {name: [float(t) for t in ts]
                               for name, ts in arrivals.items()},
                   "meta": meta or {}}
    else:
        payload = {"arrival_s": [float(t) for t in arrivals],
                   "meta": meta or {}}
    with open(path, "w") as f:
        json.dump(payload, f)


def load_schedule(path: str) -> Union[np.ndarray, Dict[str, np.ndarray]]:
    """Load a recorded schedule: an array for single-stream files, a
    ``{class: array}`` dict for multi-stream recordings."""
    with open(path) as f:
        d = json.load(f)
    if "streams" in d:
        return {name: np.sort(np.asarray(ts, dtype=float))
                for name, ts in d["streams"].items()}
    return np.sort(np.asarray(d["arrival_s"], dtype=float))


def merge(streams: Dict[str, Iterable[float]]) -> List[Tuple[float, str]]:
    """Merge per-class streams into one (t, class_name) order of events."""
    events = [(float(t), name) for name, ts in streams.items() for t in ts]
    events.sort()
    return events
