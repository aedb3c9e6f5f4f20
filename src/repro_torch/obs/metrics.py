"""The one shared quantile implementation (nearest-rank, no interpolation).

The port's monitor summaries and the serve launcher's latency percentiles
both route through :func:`quantile`, so a percentile means the same thing
wherever it is printed.  The metrics registry of the reference
``obs/metrics.py`` comes with the port's observability slice.
"""
from __future__ import annotations

import math
from typing import Sequence


def quantile(values: Sequence[float], q: float) -> float:
    """Nearest-rank quantile (q in [0, 100]) on a finite sample.

    No interpolation: the answer is always an observed value
    (q=0 -> min, q=100 -> max, empty -> nan).
    """
    if not values:
        return float("nan")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[min(k, len(xs)) - 1])
