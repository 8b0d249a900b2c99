"""Picture analysis + source-based operations (open-loop statistics).

Capability parity with the reference's picture-analysis kernel
(``EbPictureAnalysisProcess.c:5095``: decimation :5025, block
mean/variance :2115, histograms :4237/:4314, noise estimate + denoise
:1450-4175, edge detection :4545) and the source-based-operations kernel
(``EbSourceBasedOperationsProcess.c:968``: dark-area :367, spatial/
temporal high-contrast :444/:466, grass/skin :116) — re-expressed as a
handful of vectorized whole-frame tensor passes instead of per-SB
thread-pool loops.

The derived per-SB ``activity``/``dark``/``skin`` maps feed the QPM/BEA
analogue: since VP9 per-block quantizers need segmentation (compiled out
in the reference too), modulation happens through the mode-decision
lambda and quantizer dead-zone per superblock, exactly as the
reference's EncDec does via per-SB RDMULT (EbEncDecProcess.c:5515).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def decimate2(plane: np.ndarray) -> np.ndarray:
    """1/2-in-each-axis decimation by 2x2 mean (decimate_input_picture)."""
    h, w = plane.shape
    h2, w2 = h & ~1, w & ~1
    p = plane[:h2, :w2].astype(np.uint16)
    return ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
             + 2) >> 2).astype(np.uint8)


def build_decimation_pyramid(y: np.ndarray):
    """(full, 1/4-area, 1/16-area) planes — the PA-reference trio the
    reference allocates per picture (EbEncHandle.c:997-1046)."""
    q = decimate2(y)
    s = decimate2(q)
    return y, q, s


def block_mean_variance(y: np.ndarray, n: int = 16):
    """Per-nxn-block (mean, variance) maps
    (compute_block_mean_compute_variance)."""
    h, w = y.shape
    rows, cols = h // n, w // n
    blocks = y[: rows * n, : cols * n].astype(np.float64)
    blocks = blocks.reshape(rows, n, cols, n)
    mean = blocks.mean(axis=(1, 3))
    var = blocks.var(axis=(1, 3))
    return mean, var


def luma_histogram(y: np.ndarray, bins: int = 16) -> np.ndarray:
    shift = 8 - int(np.log2(bins))
    return np.bincount((y >> shift).reshape(-1), minlength=bins)[:bins]


def estimate_noise_level(y: np.ndarray) -> float:
    """Median-absolute high-frequency residual (noise_extract analogue):
    the mean |laplacian|/8 over flat areas approximates the noise sigma."""
    a = y.astype(np.int32)
    lap = (4 * a[1:-1, 1:-1] - a[:-2, 1:-1] - a[2:, 1:-1]
           - a[1:-1, :-2] - a[1:-1, 2:])
    mag = np.abs(lap)
    flat = mag < np.percentile(mag, 75)
    if not flat.any():
        return 0.0
    return float(mag[flat].mean() / 8.0)


def denoise_weak(y: np.ndarray) -> np.ndarray:
    """Separable [1 2 1]/4 smoothing — the reference's weak luma filter
    family (EbPictureAnalysisProcess.c weak filter)."""
    a = y.astype(np.uint16)
    pad = np.pad(a, 1, mode="edge")
    horiz = (pad[1:-1, :-2] + 2 * pad[1:-1, 1:-1] + pad[1:-1, 2:] + 2) >> 2
    pad2 = np.pad(horiz, 1, mode="edge")
    out = (pad2[:-2, 1:-1] + 2 * pad2[1:-1, 1:-1] + pad2[2:, 1:-1] + 2) >> 2
    return out.astype(np.uint8)


def denoise_strong(y: np.ndarray) -> np.ndarray:
    """Separable [1 2 2 2 1]/8 smoothing — the reference's strong luma
    filter family (EbPictureAnalysisProcess.c strong filter), engaged at
    high noise estimates."""
    a = y.astype(np.uint32)
    pad = np.pad(a, 2, mode="edge")
    horiz = (pad[2:-2, :-4] + 2 * pad[2:-2, 1:-3] + 2 * pad[2:-2, 2:-2]
             + 2 * pad[2:-2, 3:-1] + pad[2:-2, 4:] + 4) >> 3
    pad2 = np.pad(horiz, 2, mode="edge")
    out = (pad2[:-4, 2:-2] + 2 * pad2[1:-3, 2:-2] + 2 * pad2[2:-2, 2:-2]
           + 2 * pad2[3:-1, 2:-2] + pad2[4:, 2:-2] + 4) >> 3
    return out.astype(np.uint8)


def dark_area_density(y: np.ndarray, n: int = 16,
                      thresh: int = 60) -> np.ndarray:
    """Fraction of dark pixels per block (derive_picture_activity_stats
    dark-area density, EbSourceBasedOperationsProcess.c:367)."""
    h, w = y.shape
    rows, cols = h // n, w // n
    dark = (y[: rows * n, : cols * n] < thresh)
    return dark.reshape(rows, n, cols, n).mean(axis=(1, 3))


def aura_map(var16: np.ndarray, ratio: float = 8.0,
             floor: float = 100.0) -> np.ndarray:
    """Aura / isolated-region detector
    (EbSourceBasedOperationsProcess.c:221/:324, aura detection
    EbModeDecisionConfigurationProcess.c:193): blocks whose activity
    towers over every neighbor — halos around sharp objects on flat
    background — are flagged so mode decision protects them."""
    v = np.maximum(var16, 1.0)
    pad = np.pad(v, 1, mode="edge")
    neigh = np.stack([pad[:-2, 1:-1], pad[2:, 1:-1],
                      pad[1:-1, :-2], pad[1:-1, 2:]])
    return (v > floor) & (v > ratio * neigh.max(axis=0) + 1e-9)


def high_contrast_maps(y: np.ndarray, prev_y=None, n: int = 16):
    """(spatial, temporal) high-contrast block maps
    (EbSourceBasedOperationsProcess.c:444/:466): spatial = strong
    within-block dynamic range; temporal = large mean shift vs the
    previous source picture (None -> all False)."""
    h, w = y.shape
    rows, cols = h // n, w // n
    blk = y[: rows * n, : cols * n].reshape(rows, n, cols, n)
    rng = blk.max(axis=(1, 3)).astype(np.int32) \
        - blk.min(axis=(1, 3)).astype(np.int32)
    spatial = rng > 150
    if prev_y is None:
        return spatial, np.zeros_like(spatial)
    pblk = prev_y[: rows * n, : cols * n].reshape(rows, n, cols, n)
    dm = np.abs(blk.mean(axis=(1, 3)) - pblk.mean(axis=(1, 3)))
    return spatial, dm > 40


def edge_map(y: np.ndarray, n: int = 16) -> np.ndarray:
    """Per-block mean gradient magnitude (edge detection :4545)."""
    a = y.astype(np.int32)
    gx = np.abs(np.diff(a, axis=1, prepend=a[:, :1]))
    gy = np.abs(np.diff(a, axis=0, prepend=a[:1]))
    g = (gx + gy).astype(np.float64)
    h, w = y.shape
    rows, cols = h // n, w // n
    return g[: rows * n, : cols * n].reshape(rows, n, cols, n).mean((1, 3))


def skin_grass_maps(y, u, v, n: int = 16):
    """Chroma-range classifiers (grass/skin detector :116): fraction of
    skin-tone / grass-tone pixels per block (4:2:0 chroma grid)."""
    uu = u.astype(np.int32)
    vv = v.astype(np.int32)
    skin = (uu > 100) & (uu < 130) & (vv > 135) & (vv < 175)
    grass = (uu > 96) & (uu < 125) & (vv > 110) & (vv < 135)
    hn = n // 2  # chroma blocks for an nxn luma block
    h, w = u.shape
    rows, cols = h // hn, w // hn
    sk = skin[: rows * hn, : cols * hn].reshape(rows, hn, cols, hn) \
        .mean(axis=(1, 3))
    gr = grass[: rows * hn, : cols * hn].reshape(rows, hn, cols, hn) \
        .mean(axis=(1, 3))
    return sk, gr


@dataclass
class PictureStats:
    """Open-loop per-picture analysis products (the PPCS stats fields)."""

    mean16: np.ndarray  # (rows, cols) per-16x16 means
    var16: np.ndarray  # per-16x16 variances
    edge16: np.ndarray  # per-16x16 edge strength
    skin16: np.ndarray
    grass16: np.ndarray
    luma_hist: np.ndarray
    noise_level: float
    pyramid: tuple  # (full, quarter, sixteenth) luma planes
    aura16: np.ndarray = None  # isolated high-activity blocks
    dark16: np.ndarray = None  # dark-pixel density
    hc_spatial16: np.ndarray = None  # spatial high-contrast blocks

    def sb_lambda_map(self, sb: int = 64) -> np.ndarray:
        """QPM/BEA analogue: per-SB lambda multipliers.

        Low-variance (flat/dark) and skin areas get tighter lambda
        (better quality where artifacts show); high-activity textured
        areas can absorb coarser decisions.  Range clamped to
        [0.7, 1.4] so rate impact stays bounded.
        """
        k = sb // 16
        rows, cols = self.var16.shape
        srows, scols = max(1, rows // k), max(1, cols // k)
        v = self.var16[: srows * k, : scols * k] \
            .reshape(srows, k, scols, k).mean((1, 3))
        m = self.mean16[: srows * k, : scols * k] \
            .reshape(srows, k, scols, k).mean((1, 3))
        s = self.skin16[: srows * k, : scols * k] \
            .reshape(srows, k, scols, k).mean((1, 3))
        act = np.sqrt(np.maximum(v, 1.0))
        med = max(float(np.median(act)), 1.0)
        lam = np.clip((act / med) ** 0.5, 0.7, 1.4)
        lam = np.where(m < 50, np.minimum(lam, 0.85), lam)  # dark areas
        lam = np.where(s > 0.5, np.minimum(lam, 0.9), lam)  # skin
        if self.aura16 is not None:
            # aura/isolated regions: tighten lambda so halos around
            # sharp objects don't smear (aura_derivation analogue)
            a = self.aura16[: srows * k, : scols * k] \
                .reshape(srows, k, scols, k).mean((1, 3))
            lam = np.where(a > 0, np.minimum(lam, 0.8), lam)
        return lam.astype(np.float32)


def analyze_picture(frame, denoise: bool = False) -> PictureStats:
    """One-pass open-loop analysis of a Frame420.

    denoise=True additionally smooths the luma in place when the noise
    estimate warrants it (the reference's denoiser gate).
    """
    y = frame.y
    if denoise:
        lvl = estimate_noise_level(y)
        if lvl > 6.0:
            # heavy noise: strong filter (the reference's strong/weak
            # gate on the per-picture noise class)
            frame.y[:] = denoise_strong(y)
            y = frame.y
        elif lvl > 2.5:
            frame.y[:] = denoise_weak(y)
            y = frame.y
    mean16, var16 = block_mean_variance(y, 16)
    sk, gr = skin_grass_maps(y, frame.u, frame.v, 16)
    hc_sp, _ = high_contrast_maps(y)
    return PictureStats(
        mean16=mean16, var16=var16, edge16=edge_map(y, 16),
        skin16=sk, grass16=gr, luma_hist=luma_histogram(y),
        noise_level=estimate_noise_level(y),
        pyramid=build_decimation_pyramid(y),
        aura16=aura_map(var16), dark16=dark_area_density(y),
        hc_spatial16=hc_sp,
    )
