"""Stan-style three-phase warmup schedule, precomputed on the host
(the port's own copy of ``exmc_tpu/nuts/warmup.py``).

Phase I step-size only (init_buffer = min(75, warmup/3)), Phase II
step-size + mass with doubling windows (base 25, per-window Welford
reset, epsilon re-search after each window), Phase III step-size only
(term_buffer = min(50, warmup/10)).
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WarmupSchedule:
    num_warmup: int
    update_mass: np.ndarray   # bool[num_warmup] — Phase II iterations
    window_end: np.ndarray    # bool[num_warmup] — finalize mass + re-search eps
    depth_cap: np.ndarray     # int32[num_warmup] — dynamic tree-depth cap


def build_schedule(num_warmup, max_depth=10, init_buffer=None, term_buffer=None,
                   base_window=25, early_cap_iters=200, early_cap_depth=8):
    """Doubling windows from base 25 between the buffers; the last window
    is extended to fill the Phase II budget; tree depth is capped at 8
    for the first 200 warmup iterations. If the Phase II budget is below
    one base window, mass adaptation is disabled."""
    n = int(num_warmup)
    update_mass = np.zeros(n, dtype=bool)
    window_end = np.zeros(n, dtype=bool)
    depth_cap = np.full(n, max_depth, dtype=np.int32)
    if n == 0:
        return WarmupSchedule(n, update_mass, window_end, depth_cap)

    depth_cap[: min(early_cap_iters, n)] = min(early_cap_depth, max_depth)

    if init_buffer is None:
        init_buffer = min(75, n // 3)
    if term_buffer is None:
        term_buffer = min(50, n // 10)
    phase2 = n - init_buffer - term_buffer
    if phase2 < base_window:
        return WarmupSchedule(n, update_mass, window_end, depth_cap)

    update_mass[init_buffer: init_buffer + phase2] = True
    start = init_buffer
    end_of_phase2 = init_buffer + phase2
    w = base_window
    while start < end_of_phase2:
        next_end = start + w
        if next_end + 2 * w > end_of_phase2:
            next_end = end_of_phase2
        window_end[next_end - 1] = True
        start = next_end
        w *= 2

    return WarmupSchedule(n, update_mass, window_end, depth_cap)
