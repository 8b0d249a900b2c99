"""Encoder configuration.

Field-parity with the reference public config struct
``EbSvtVp9EncConfiguration`` (``Source/API/EbSvtVp9Enc.h:124-355``) plus the
defaulting/derivation logic of ``eb_vp9_svt_enc_init_parameter``
(``EbEncHandle.c:1762``) and ``set_param_based_on_input``
(``EbEncHandle.c:2562``) — re-expressed as a Python dataclass.

TPU-specific additions live in the ``tpu_*`` fields (mesh shape, tile
columns, GOP parallelism) and replace the reference's thread/core knobs
(``-lp``/``-ss``/``asm_type``).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class Tune(enum.IntEnum):
    SQ = 0  # visually optimized
    OQ = 1  # PSNR/SSIM optimized (default)
    VMAF = 2  # VMAF optimized


class RateControlMode(enum.IntEnum):
    CQP = 0
    VBR = 1
    CBR = 2


class PredStructure(enum.IntEnum):
    LOW_DELAY_P = 0
    LOW_DELAY_B = 1
    RANDOM_ACCESS = 2


@dataclass
class EncoderConfig:
    # --- encoding preset (EbSvtVp9Enc.h:131 enc_mode, :138 tune) ---
    enc_mode: int = 9  # M0 (best quality) .. M9 (fastest)
    tune: Tune = Tune.OQ

    # --- GOP structure (EbSvtVp9Enc.h:149-169) ---
    intra_period: int = -2  # -1 = none, -2 = auto (~1s, multiple of 8 minus 1)
    pred_structure: PredStructure = PredStructure.RANDOM_ACCESS
    base_layer_switch_mode: int = 0
    hierarchical_levels: int = -1  # -1 = derive from tune/RC (ref: 4L OQ, 3L SQ)

    # --- input info (EbSvtVp9Enc.h:177-213) ---
    source_width: int = 0
    source_height: int = 0
    frame_rate: int = 25
    frame_rate_numerator: int = 0
    frame_rate_denominator: int = 0
    encoder_bit_depth: int = 8
    partition_depth: int = 4

    # --- quantization (EbSvtVp9Enc.h:217-230) ---
    qp: int = 50
    use_qp_file: bool = False
    enable_qp_scaling: bool = True

    # --- deblocking (EbSvtVp9Enc.h:234) ---
    loop_filter: bool = True

    # --- ME (EbSvtVp9Enc.h:237-252) ---
    use_default_me_hme: bool = True
    enable_hme: bool = True
    search_area_width: int = 16
    search_area_height: int = 9

    # --- rate control (EbSvtVp9Enc.h:256-276) ---
    rate_control_mode: RateControlMode = RateControlMode.CQP
    target_bit_rate: int = 7_000_000
    max_qp_allowed: int = 63
    min_qp_allowed: int = 10
    vbv_buf_size: int = 0  # 0 = auto (2 * target_bit_rate when CBR)

    # --- bitstream conformance (EbSvtVp9Enc.h:279-287) ---
    profile: int = 0  # 8-bit 4:2:0 only, as the reference
    level: int = 0  # 0 = auto

    # --- app-level ---
    channel_id: int = 0
    active_channel_count: int = 1
    recon_file: str | None = None
    speed_control: bool = False
    injector_frame_rate: int = 0

    # --- TPU-native knobs (replace asm_type / logical processors / sockets) ---
    tpu_tile_columns: int = -1  # -1 = auto from width & mesh; 0 = single tile
    tpu_mesh_shape: tuple = ()  # e.g. (4, 2); empty = all local devices flat
    tpu_gop_parallel: int = 1  # GOPs encoded concurrently across hosts
    tpu_frame_parallel: int = 1  # frames batched per device step
    # device-resident realtime EncDec loop for low-delay streams:
    # -1 = auto (use when preset/structure/geometry allow and a TPU is
    # reachable), 0 = never, 1 = require (error out when no live
    # accelerator or unsupported geometry — no silent 100x degradation),
    # 2 = force (build even on CPU jax; hermetic testing)
    tpu_realtime: int = -1
    # error_resilient=False (default): frame-context persistence + temporal
    # (prev-frame) MV candidates, ~5% smaller streams; True disables both
    # (each frame independently decodable after its references).
    error_resilient: bool = False
    # frame_parallel_decoding=False (default): backward probability
    # adaptation after every frame (the libvpx coding model); True writes
    # fpdm=1 headers so decoders can parse frames in parallel (forward
    # updates only, like the reference encoder)
    frame_parallel_decoding: bool = False

    def validate(self) -> None:
        """Mirror of reference verify_settings (EbEncHandle.c:2203)."""
        if not (0 <= self.enc_mode <= 9):
            raise ValueError(f"enc_mode must be in [0,9], got {self.enc_mode}")
        if not (64 <= self.source_width <= 8192):
            raise ValueError(f"source_width must be in [64,8192], got {self.source_width}")
        if not (64 <= self.source_height <= 4320):
            raise ValueError(f"source_height must be in [64,4320], got {self.source_height}")
        if self.source_width % 8 or self.source_height % 8:
            # The reference pads internally; we require mod-8 luma for 4:2:0
            # chroma alignment and pad to SB multiples internally.
            pass
        if not (0 <= self.qp <= 63):
            raise ValueError(f"qp must be in [0,63], got {self.qp}")
        if self.encoder_bit_depth != 8:
            raise ValueError("only 8-bit is supported (profile 0), as the reference")
        if self.profile != 0:
            raise ValueError("only profile 0 (8-bit 4:2:0) is supported")
        if not (-2 <= self.intra_period <= 255):
            raise ValueError(f"intra_period must be in [-2,255], got {self.intra_period}")
        if self.rate_control_mode != RateControlMode.CQP and self.target_bit_rate <= 0:
            raise ValueError("target_bit_rate must be positive for VBR/CBR")
        if self.max_qp_allowed < self.min_qp_allowed:
            raise ValueError("max_qp_allowed < min_qp_allowed")

    def derive(self) -> "EncoderConfig":
        """Fill auto fields; mirrors set_param_based_on_input (EbEncHandle.c:2562)."""
        cfg = dataclasses.replace(self)
        if cfg.frame_rate_numerator and cfg.frame_rate_denominator:
            fps = cfg.frame_rate_numerator / cfg.frame_rate_denominator
        else:
            fps = cfg.frame_rate if cfg.frame_rate < 1000 else cfg.frame_rate >> 16
            cfg.frame_rate_numerator = int(fps)
            cfg.frame_rate_denominator = 1
        if cfg.intra_period == -2:
            # ~1 s keyframe interval, multiple of 8 minus 1 (user guide :96).
            cfg.intra_period = max(int((int(fps) + 4) // 8) * 8 - 1, 7)
        if cfg.hierarchical_levels < 0:
            # Reference: 4-level unless tune SQ + CQP (EbEncHandle.c:2168-2175).
            if cfg.tune == Tune.SQ and cfg.rate_control_mode == RateControlMode.CQP:
                cfg.hierarchical_levels = 3
            else:
                cfg.hierarchical_levels = 4
        if cfg.pred_structure != PredStructure.RANDOM_ACCESS:
            cfg.hierarchical_levels = min(cfg.hierarchical_levels, 2)
        if cfg.vbv_buf_size == 0 and cfg.rate_control_mode == RateControlMode.CBR:
            cfg.vbv_buf_size = 2 * cfg.target_bit_rate
        if cfg.rate_control_mode == RateControlMode.CQP:
            # min-qp only constrains the RC modes; CQP scaling may reach
            # down to lossless-adjacent q (EbEncHandle.c:2130-2132)
            cfg.min_qp_allowed = 0
        return cfg

    @property
    def fps(self) -> float:
        if self.frame_rate_numerator and self.frame_rate_denominator:
            return self.frame_rate_numerator / self.frame_rate_denominator
        return float(self.frame_rate if self.frame_rate < 1000 else self.frame_rate >> 16)
