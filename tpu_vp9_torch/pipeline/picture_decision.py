"""Picture decision: scene-change detection + refresh type selection.

Capability parity with the reference picture-decision kernel
(``EbPictureDecisionProcess.c:1423``: eb_vp9_scene_transition_detector
``:100-330``, keyframe placement).  The detector is the reference's
regional-histogram design re-expressed as vectorized numpy:

  - the picture splits into a region grid; per region a 256-bin luma
    (and chroma) histogram accumulates, and the per-region accumulated
    histogram difference (ahd) against the previous picture is compared
    to a RUNNING AVERAGE of itself (``ahd_error``);
  - the per-region threshold scales with the region's 64x64 count and
    switches to the noisy-scene threshold when the picture variance
    jumps across NOISE_VARIANCE_TH around a high-variance point
    (noise insertion/removal must not read as a cut);
  - fades are rejected by the region mean-intensity delta
    (``aid_present_past`` < FADE_TH ⇒ luminance ramp, not a cut);
  - a cut is declared when at least half the regions flag abrupt
    change (``region_count_threshold``, SCD_MODE_1's 50%).

The reference's flash rejection uses the FUTURE picture (3-frame
window); this detector is causal (low-delay paths have no lookahead),
so light flashes may still trigger — the RA path's keyframe scheduler
re-checks against its buffered window.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# EbPictureDecisionProcess.c:33-38
FLASH_TH = 5
FADE_TH = 3
SCENE_TH = 3000
NOISY_SCENE_TH = 4500
HIGH_PICTURE_VARIANCE_TH = 1500
NOISE_VARIANCE_TH = 390  # EbDefinitions.h:857


def _region_histograms(plane: np.ndarray, nr: int, bins: int = 256,
                       shift: int = 0):
    """(nr, nr, bins) histograms + (nr, nr) mean intensity per region."""
    h, w = plane.shape
    rh, rw = h // nr, w // nr
    hists = np.empty((nr, nr, bins >> shift), np.int32)
    means = np.empty((nr, nr), np.float64)
    for i in range(nr):
        for j in range(nr):
            y1 = (i + 1) * rh if i < nr - 1 else h
            x1 = (j + 1) * rw if j < nr - 1 else w
            reg = plane[i * rh : y1, j * rw : x1]
            v = reg.reshape(-1) >> shift if shift else reg.reshape(-1)
            hists[i, j] = np.bincount(v, minlength=bins >> shift)
            means[i, j] = reg.mean()
    return hists, means


@dataclass
class SceneChangeDetector:
    """Regional-histogram scene transition detector
    (eb_vp9_scene_transition_detector semantics, causal variant)."""

    regions: int = 4
    history: list = field(default_factory=list)  # kept for API compat

    def __post_init__(self):
        self._prev = None       # (hists, means, chists, variance)
        self._run_avg = None    # (nr, nr) running ahd average
        self._run_avg_c = None
        self._reset_avg = True

    def is_scene_change(self, y_plane: np.ndarray, u_plane=None,
                        v_plane=None) -> bool:
        nr = self.regions
        y = np.asarray(y_plane)
        hists, means = _region_histograms(y, nr)
        var = float(y.astype(np.float64).var())
        ch = None
        if u_plane is not None and v_plane is not None:
            cu, _ = _region_histograms(np.asarray(u_plane), nr)
            cv, _ = _region_histograms(np.asarray(v_plane), nr)
            ch = cu + cv
        prev = self._prev
        self._prev = (hists, means, ch, var)
        if prev is None:
            return False
        phists, pmeans, pch, pvar = prev

        h, w = y.shape
        rh, rw = h // nr, w // nr
        # NUM64x64INPIC per region, continuous for sub-64x64 regions
        # (the reference's integer >>12 floors to 0 below 64x64)
        n64 = max(rh * rw / 4096.0, 1.0 / 16.0)
        noisy = (abs(var - pvar) > NOISE_VARIANCE_TH
                 and (var > HIGH_PICTURE_VARIANCE_TH
                      or pvar > HIGH_PICTURE_VARIANCE_TH))
        th = (NOISY_SCENE_TH if noisy else SCENE_TH) * n64

        ahd = np.abs(hists - phists).sum(axis=2)  # (nr, nr)
        if self._reset_avg or self._run_avg is None:
            self._run_avg = ahd.copy()
            self._reset_avg = False
        ahd_err = np.abs(self._run_avg - ahd)
        abrupt = (ahd_err > th) & (ahd >= ahd_err)
        if ch is not None and pch is not None:
            ahd_c = np.abs(ch - pch).sum(axis=2)
            if self._run_avg_c is None:
                self._run_avg_c = ahd_c.copy()
            err_c = np.abs(self._run_avg_c - ahd_c)
            abrupt |= (err_c > th / 4) & (ahd_c >= err_c)
            self._run_avg_c = (3 * self._run_avg_c + ahd_c) // 4
        # fade rejection: abrupt histogram move with a small mean-
        # intensity step is a luminance ramp, not a cut
        aid = np.abs(means - pmeans)
        abrupt &= ~(aid < FADE_TH) | (ahd_err > 2 * th)
        # running average update (non-abrupt regions track the scene)
        self._run_avg = np.where(abrupt, self._run_avg,
                                 (3 * self._run_avg + ahd) // 4)
        cut = int(abrupt.sum()) * 2 >= nr * nr  # 50% region count
        if cut:
            self._reset_avg = True  # reset_running_avg after a cut
        return bool(cut)
