"""Lookahead (initial rate control) window.

Analogue of the reference's InitialRateControl process
(``EbInitialRateControlProcess.c:783``): a sliding window of future-frame
complexity estimates feeds the high-level rate controller
(``eb_vp9_high_level_rc_input_picture_vbr``, ``EbRateControlProcess.c:434``)
so each frame's bit target reflects how hard it is relative to its
neighborhood, not just the long-run average.

Complexity here is the open-loop zero-motion SAD between consecutive
*source* frames on a 1/4-decimated luma plane (the reference's zz-SAD
pass over PA refs, ``EbMotionEstimationProcess.c:1047-1120``) — cheap,
open-loop, and computable the moment a picture arrives.
"""

from __future__ import annotations

import numpy as np


def frame_complexity(y: np.ndarray, prev_y) -> float:
    """Decimated zero-motion SAD per pixel vs the previous source frame.

    Returns ~0 for a still frame; an intra-like measure (mean abs
    deviation from DC) when there is no previous frame.
    """
    d = y[::2, ::2].astype(np.int32)
    if prev_y is None:
        return float(np.abs(d - int(d.mean())).mean())
    p = prev_y[::2, ::2].astype(np.int32)
    return float(np.abs(d - p).mean())


class LookaheadWindow:
    """Sliding complexity window keyed by POC.

    ``distance`` mirrors ``look_ahead_distance`` derivation
    (``EbEncHandle.c:2042-2050``): ``(2 << hierarchical_levels) + 1`` in
    CQP, else min(intra-period-bounded) — callers pass the resolved value.
    """

    def __init__(self, distance: int) -> None:
        self.distance = max(1, distance)
        self._c: dict[int, float] = {}
        self._prev_y = None
        self._run_avg = None  # long-run EMA for the window edge

    def push(self, poc: int, y: np.ndarray) -> None:
        c = frame_complexity(y, self._prev_y)
        self._prev_y = y
        self._c[poc] = c
        if self._run_avg is None:
            self._run_avg = max(c, 1e-3)
        else:
            self._run_avg = 0.9 * self._run_avg + 0.1 * c
        # retire entries that have slid out of every possible window
        if len(self._c) > 4 * self.distance:
            for k in sorted(self._c)[: len(self._c) - 2 * self.distance]:
                del self._c[k]

    def scales(self, pocs) -> dict[int, float]:
        """Relative-complexity multipliers for the given pocs.

        Each poc's complexity is compared to the mean over the window of
        frames currently known ahead of (and including) it.
        """
        if not self._c:
            return {}
        avg = float(np.mean(list(self._c.values())))
        if self._run_avg is not None:
            avg = 0.5 * avg + 0.5 * self._run_avg
        avg = max(avg, 1e-3)
        out = {}
        for p in pocs:
            c = self._c.get(p)
            if c is None:
                continue
            # damped ratio, clamped like the reference's bit-allocation
            # bounds so a single spike cannot starve its neighbors
            r = 1.0 + 0.5 * (c / avg - 1.0)
            out[p] = float(np.clip(r, 0.5, 2.0))
        return out

    def drop(self, pocs) -> None:
        for p in pocs:
            self._c.pop(p, None)
