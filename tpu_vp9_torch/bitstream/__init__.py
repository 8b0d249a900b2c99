"""VP9-normative serialization layer (host side).

This package is the TPU build's equivalent of the reference's vendored
libvpx entropy layer (``Source/Lib/VPX/`` in SVT-VP9): the boolean range
coder, probability/scan tables, frame headers, and the IVF container.

The boolean range coder is inherently sequential, so it lives on the host
(pure-Python reference here, C++ fast path in ``native/``); the TPU side
produces *tokens and counts* in batch, and this layer serializes them.
"""
