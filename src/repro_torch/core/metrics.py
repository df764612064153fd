"""Host-side tail statistics: the numpy ``percentile`` of
``repro/core/metrics.py``, the single implementation behind the serving
report's p50 and p99.  The in-loop histograms and SLO windows of the
reference's module wait for the metrics slice (ROADMAP queue A10)."""
from __future__ import annotations

import numpy as np


def percentile(samples, q: float) -> float:
    """Exact sample percentile (linear interpolation); 0.0 for an empty
    sample set."""
    samples = np.asarray(samples, np.float64).ravel()
    if samples.size == 0:
        return 0.0
    return float(np.percentile(samples, q))
