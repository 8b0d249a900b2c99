"""Preset ladder M0-M9 and tune handling.

The reference derives dozens of per-kernel signals from (enc_mode, tune,
resolution) — HME levels, search areas, NFL counts, depth modes
(``EbEncDecProcess.c:4912-5181`` etc.).  This maps the same M0-M9 /
SQ-OQ-VMAF surface onto the TPU encoder's current knobs; the ladder
widens as more tools land (adaptive partitioning, BDP analogues).
"""

from __future__ import annotations

from dataclasses import dataclass

from tpu_vp9_torch.bitstream.tables import BlockSize
from tpu_vp9_torch.config import EncoderConfig, Tune


@dataclass
class PresetSignals:
    block_size: BlockSize  # partition target
    search_range: int  # full-pel ME range
    do_subpel: bool  # half/quarter-pel refinement
    qbias: float  # quantizer deadzone (lower = more zeros)
    use_tpu_hints: bool  # open-loop TPU mode decision for keyframes
    adaptive_partition: bool = False  # 32->16 split by cost probes
    tx_select: bool = False  # per-block transform size (TX_MODE_SELECT)
    use_tpu_me: bool = False  # batched device full-pel search
    part_depths: tuple = None  # (min_bs, max_bs) quadtree partition RDO
    qpm: bool = False  # QPM/BEA analogue: per-SB lambda from analysis maps
    denoise: bool = False  # pre-encode weak denoise when noise detected
    full_loop: bool = False  # MD full loop: true RD with entropy-table rates
    # per-SB ADP probe budget (eb_vp9_derive_optimal_budget_per_sb
    # analogue): fraction of 32-blocks granted child split probes in the
    # adaptive_partition path; 1.0 = probe everything
    adp_budget: float = 1.0


_LADDER = {
    0: PresetSignals(BlockSize.BLOCK_16X16, 32, True, 0.42, False, False,
                     True, part_depths=(BlockSize.BLOCK_4X4,
                                        BlockSize.BLOCK_64X64)),
    1: PresetSignals(BlockSize.BLOCK_16X16, 28, True, 0.42, False, False,
                     True, part_depths=(BlockSize.BLOCK_4X4,
                                        BlockSize.BLOCK_64X64)),
    2: PresetSignals(BlockSize.BLOCK_16X16, 24, True, 0.40, False, False,
                     True, part_depths=(BlockSize.BLOCK_16X16,
                                        BlockSize.BLOCK_64X64)),
    3: PresetSignals(BlockSize.BLOCK_32X32, 24, True, 0.40, False, True,
                     True, part_depths=(BlockSize.BLOCK_16X16,
                                        BlockSize.BLOCK_64X64)),
    4: PresetSignals(BlockSize.BLOCK_32X32, 20, True, 0.40, False, True,
                     True, part_depths=(BlockSize.BLOCK_16X16,
                                        BlockSize.BLOCK_64X64)),
    5: PresetSignals(BlockSize.BLOCK_32X32, 20, True, 0.38, False, True,
                     True, adp_budget=0.5),
    6: PresetSignals(BlockSize.BLOCK_32X32, 16, True, 0.38, False, True,
                     False, adp_budget=0.25),
    7: PresetSignals(BlockSize.BLOCK_32X32, 12, True, 0.38, False, False,
                     False, True),
    8: PresetSignals(BlockSize.BLOCK_32X32, 12, True, 0.36, True, False,
                     False, True),
    9: PresetSignals(BlockSize.BLOCK_32X32, 8, False, 0.34, True, False,
                     False, True),
}


def derive_signals(cfg: EncoderConfig) -> PresetSignals:
    sig = _LADDER[int(cfg.enc_mode)]
    import dataclasses

    px = cfg.source_width * cfg.source_height
    if cfg.enable_hme and px >= 1280 * 720:
        # HD+: hierarchical ME makes wide search areas cheap (the
        # reference scales its HME total search area with resolution,
        # EbModeDecisionConfiguration hme level0 width tables)
        sig = dataclasses.replace(
            sig, search_range=max(sig.search_range,
                                  64 if px >= 3840 * 2160 else 48))
    if int(cfg.enc_mode) <= 5:
        # quality presets run the analysis-driven QPM/BEA analogue
        sig = dataclasses.replace(sig, qpm=True)
    if int(cfg.enc_mode) <= 4:
        # MD full loop with entropy-table rates (EbEncDecProcess.c:766);
        # faster presets stay on the SAD fast loop
        sig = dataclasses.replace(sig, full_loop=True)
    if cfg.tune == Tune.SQ:
        # visual tune: slightly wider deadzone on high-energy coeffs,
        # QPM always on, denoiser gated by the noise estimate
        sig = dataclasses.replace(sig, qbias=max(sig.qbias - 0.02, 0.3),
                                  qpm=True,
                                  denoise=int(cfg.enc_mode) <= 6)
    elif cfg.tune == Tune.VMAF:
        # metric tune: no perceptual lambda shaping (VMAF does not
        # reward dark/skin bias), no source filtering, slightly tighter
        # quantizer for fidelity (the reference's VMAF signal family
        # similarly trades perceptual tools for metric score,
        # EbPictureDecisionProcess.c:880)
        sig = dataclasses.replace(sig, qpm=False, denoise=False,
                                  qbias=min(sig.qbias + 0.02, 0.5))
    if not cfg.enable_hme:
        sig = dataclasses.replace(sig,
                                  search_range=min(sig.search_range, 8))
    if not cfg.use_default_me_hme:
        sig = dataclasses.replace(
            sig, search_range=max(cfg.search_area_width,
                                  cfg.search_area_height))
    return sig


# quantizer (0-63) to qindex (0-255): q*4 except the top two entries
# (249/255), matching vp9_quantize.c:323 quantizer_to_qindex
QUANTIZER_TO_QINDEX = [q * 4 for q in range(62)] + [249, 255]


def qp_to_qindex(qp: int) -> int:
    return QUANTIZER_TO_QINDEX[max(0, min(63, qp))]
