"""Standalone VP9 decoder (host, numpy) — the conformance oracle.

The reference ecosystem validates encoders with libvpx/vpxdec; this
environment has no external decoder, so the framework ships its own
spec decoder.  Encoder tests require: decode(encode(x)) recon planes
bit-identical to the encoder's own reconstruction.
"""

from tpu_vp9_torch.decoder.decoder import decode_frame, decode_ivf  # noqa: F401
