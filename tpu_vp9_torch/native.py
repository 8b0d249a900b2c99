"""ctypes bindings for the native C++ serialization kernels.

The C++ source, ``native/vp9_native.cpp``, belongs to neither Python
package: it is the one file both build.  This module compiles it at first
use into ``tpu_vp9_torch/_build/libvp9native.so`` (a directory
``.gitignore`` lists), apart from the JAX package's
``native/libvp9native.so``, so the two builds never race.  Concurrent
processes take a file lock around the build and rename the finished
library into place.  ``get_lib`` returns None if the build fails, says why
on stderr (and in ``build_error``), and the callers then use the
pure-Python implementations; byte-identical output
is asserted by tests/test_native.py for the JAX package's bindings, which
these mirror.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import TxSize, TxType
from tpu_vp9_torch.utils.trace import notice

_PKG = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD_DIR, "libvp9native.so")
_SRC = os.path.join(os.path.dirname(_PKG), "native", "vp9_native.cpp")

_lib = None
_tried = False
build_error = None  # why get_lib returned None, once it has


def _fail(reason: str) -> None:
    """Keep the reason and say once, on stderr, that the callers now take
    the pure-Python implementations."""
    global build_error
    build_error = reason.strip()
    notice("native host library unavailable, the Python serializer runs "
           f"instead: {build_error}")


def _stale() -> bool:
    return not os.path.exists(_SO) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_SO))


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    with open(os.path.join(_BUILD_DIR, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it while this one waited
            return True
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                 "-march=native", "-funroll-loops", "-o", tmp, _SRC],
                check=True, capture_output=True, text=True, timeout=180)
            os.replace(tmp, _SO)
            return True
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                OSError) as e:
            _fail(f"the build of {_SRC} failed: {e}\n"
                  + (getattr(e, "stderr", None) or "").strip())
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:
        _fail(f"{_SO} did not load: {e}")
        return None
    lib.boolenc_new.restype = ctypes.c_void_p
    lib.boolenc_free.argtypes = [ctypes.c_void_p]
    lib.boolenc_put.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.boolenc_literal.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.boolenc_start.argtypes = [ctypes.c_void_p]
    lib.boolenc_size.argtypes = [ctypes.c_void_p]
    lib.boolenc_size.restype = ctypes.c_int64
    lib.boolenc_finalize.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_int64]
    lib.boolenc_finalize.restype = ctypes.c_int64
    lib.boolenc_write_coeffs.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.boolenc_write_coeffs.restype = ctypes.c_int
    lib.coeff_token_cost.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.coeff_token_cost.restype = ctypes.c_int
    lib.coeff_token_cost_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.vp9n_register_tx.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.vp9n_register_misc.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    lib.sad_full_search.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.lf_plane.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.subpel_sad.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16)]
    lib.subpel_sad.restype = ctypes.c_int64
    lib.subpel_refine_c.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int32)]
    # raw-address (c_void_p) signatures: the mode-decision fast loop
    # calls these thousands of times per frame, so pointer objects are
    # replaced by integer addresses (arr.ctypes.data)
    lib.mc_block_sad.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.mc_block_sad.restype = ctypes.c_int64
    lib.mc_block_sse.argtypes = lib.mc_block_sad.argtypes
    lib.mc_block_sse.restype = ctypes.c_int64
    lib.mc_block_sad_avg.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.mc_block_sad_avg.restype = ctypes.c_int64
    lib.mc_block_sse_avg.argtypes = lib.mc_block_sad_avg.argtypes
    lib.mc_block_sse_avg.restype = ctypes.c_int64
    lib.sad_full_search_rect.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    if hasattr(lib, "inv_txfm_add_batch"):
        lib.inv_txfm_add_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    if hasattr(lib, "sad_search_batch"):
        lib.sad_search_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
    lib.subpel_refine_rect.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32)]
    lib.boolenc_put_many.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.fast_loop_decide.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64,          # src, src_stride
        ctypes.POINTER(ctypes.c_void_p),          # ref_ptrs[9]
        ctypes.POINTER(ctypes.c_int32),           # ref_dims[6]
        ctypes.POINTER(ctypes.c_int32),           # ranges[3]
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),           # sign_bias[4]
        ctypes.c_void_p, ctypes.c_void_p,         # prev_ref0/1
        ctypes.c_void_p, ctypes.c_void_p,         # prev_mv0/1
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,         # field arrays
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # leaves, n
        ctypes.c_void_p,                          # filters
        ctypes.POINTER(ctypes.c_int32)]           # out
    lib.optimize_coeffs_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.rt_serialize.argtypes = (
        [_I] * 5 + [_P]            # geometry + split32
        + [_I] * 4                 # scan-prefix lengths (0 = 2-D)
        + [_P] * 18                # three zones x 6 arrays
        + [_P] * 4                 # prev-frame motion field
        + [_P]                     # sign_bias[4]
        + [_P] * 12                # probability tables
        + [_I]                     # counts_on
        + [_P] * 12                # scalar + mv counts
        + [_P] * 8                 # coef/eob counts
        + [_P] * 7                 # grid field outputs
        + [_P]                     # out_modes
        + [_P, ctypes.c_int64])    # out, cap
    lib.rt_serialize.restype = ctypes.c_int64
    lib.mc_predict_winners.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),          # ref_planes[9]
        ctypes.POINTER(ctypes.c_int64),           # strides[9]
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # jobs, n
        ctypes.c_void_p,                          # filters
        ctypes.c_void_p,                          # out
        ctypes.POINTER(ctypes.c_int64)]           # offsets
    _register_tables(lib)
    _lib = lib
    return _lib


def _as_i32(a):
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_u8(a):
    a = np.ascontiguousarray(a, dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _register_tables(lib) -> None:
    keep = []
    for ts in TxSize:
        for tt in TxType:
            scan, _, nbrs = T.scan_order(ts, tt)
            band = T.coefband(ts)
            s, sp = _as_i32(scan)
            nb, nbp = _as_i32(nbrs.reshape(-1))
            b, bp = _as_i32(band)
            keep.extend([s, nb, b])
            lib.vp9n_register_tx(int(ts), int(tt), sp, nbp, bp, scan.size)
    energy, ep = _as_i32(T.tbl("pt_energy_class"))
    cat = np.zeros((6, 14), np.uint8)
    for i, tokv in enumerate(range(5, 11)):
        probs = T.cat_probs(T.Token(tokv))
        cat[i, : probs.size] = probs
    c, cp = _as_u8(cat)
    con, conp = _as_i32(T.tbl("coef_con_tree"))
    lib.vp9n_register_misc(ep, cp, conp)


class NativeBoolEncoder:
    """Drop-in replacement for bitstream.bool_coder.BoolEncoder.

    Bit writes are buffered on the Python side and flushed to the C++
    coder in batches (one ctypes crossing per run instead of per bit) —
    flushes happen before any call that needs coder state.
    """

    def __init__(self) -> None:
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._enc = self._lib.boolenc_new()
        self._lib.boolenc_start(self._enc)
        self._bits = bytearray()
        self._probs = bytearray()

    def _flush(self) -> None:
        if not self._bits:
            return
        b = np.frombuffer(self._bits, np.uint8)
        p = np.frombuffer(self._probs, np.uint8)
        self._lib.boolenc_put_many(
            self._enc, b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b))
        self._bits = bytearray()
        self._probs = bytearray()

    def put_bit(self, bit: int, prob: int) -> None:
        self._bits.append(1 if bit else 0)
        self._probs.append(prob)

    def put_literal(self, value: int, bits: int) -> None:
        for k in range(bits - 1, -1, -1):
            self._bits.append((value >> k) & 1)
            self._probs.append(128)

    def write_coeffs(self, levels2d, tx_size, tx_type, probs_full,
                     ctx0: int, counts=None, eob_counts=None) -> int:
        self._flush()
        lv, lvp = _as_i32(np.asarray(levels2d).reshape(-1))
        pf = np.ascontiguousarray(probs_full, dtype=np.uint8)
        pfp = pf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        cp = ep = None
        if counts is not None:
            assert counts.dtype == np.int64 and counts.flags.c_contiguous
            cp = counts.ctypes.data_as(ctypes.c_void_p)
        if eob_counts is not None:
            assert (eob_counts.dtype == np.int64
                    and eob_counts.flags.c_contiguous)
            ep = eob_counts.ctypes.data_as(ctypes.c_void_p)
        return self._lib.boolenc_write_coeffs(
            self._enc, lvp, int(tx_size), int(tx_type), pfp, ctx0, cp, ep)

    def finalize(self) -> bytes:
        self._flush()
        cap = self._lib.boolenc_size(self._enc) + 64
        out = np.zeros(int(cap), np.uint8)
        n = self._lib.boolenc_finalize(
            self._enc, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap)
        assert n > 0
        data = bytes(out[:n].tobytes())
        self._lib.boolenc_free(self._enc)
        self._enc = None
        return data

    def __len__(self) -> int:
        self._flush()
        return int(self._lib.boolenc_size(self._enc))


def make_bool_encoder():
    """Factory: native encoder if available, else the Python reference."""
    if get_lib() is not None:
        return NativeBoolEncoder()
    from tpu_vp9_torch.bitstream.bool_coder import BoolEncoder

    return BoolEncoder()


def native_coeff_cost_batch(levels, tx_size: int, tx_type: int, probs_full,
                            ctx0):
    """Per-block coefficient token rate in 1/256-bit units.

    levels: (B, n, n) int32 quantized levels (2-D coefficient layout);
    probs_full: (6, 6, 11) uint8 full node probs; ctx0: (B,) int32
    above+left entropy contexts.  Exact bool-coder cost of the token
    stream boolenc_write_coeffs would emit (EbRateDistortionCost.c
    coeff-rate analogue, table-driven instead of estimate-based)."""
    import numpy as np

    lib = get_lib()
    lv = np.ascontiguousarray(levels, np.int32)
    b, n, _ = lv.shape
    pf = np.ascontiguousarray(probs_full, np.uint8)
    c0 = np.ascontiguousarray(ctx0, np.int32)
    out = np.empty(b, np.int32)
    lib.coeff_token_cost_batch(
        lv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), b, n,
        int(tx_size), int(tx_type),
        pf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        c0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def native_lf_plane(plane_view, dec, sb_span: int, px_per_step: int,
                    lim, mblim) -> bool:
    """Run the C++ loop filter on a plane view (rows may be strided)."""
    lib = get_lib()
    if lib is None:
        return False
    assert plane_view.dtype == np.uint8 and plane_view.strides[1] == 1
    dec = np.ascontiguousarray(dec, np.int32)
    lim32, limp = _as_i32(lim)
    mblim32, mblimp = _as_i32(mblim)
    lib.lf_plane(
        plane_view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        plane_view.strides[0],
        dec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dec.shape[0], dec.shape[1], sb_span, px_per_step,
        plane_view.shape[0], plane_view.shape[1], limp, mblimp)
    return True


def native_subpel_sad(ref_window, stride: int, src_block, sx: int, sy: int,
                      fx, fy):
    """SAD of the exact 8-tap interpolated prediction vs src, in C++.

    ref_window: pointer base at (y0-3, x0-3) within a strided uint8 array.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = src_block.shape[0]
    s, sp = _as_u8(np.ascontiguousarray(src_block))
    fx = np.ascontiguousarray(fx, np.int16)
    fy = np.ascontiguousarray(fy, np.int16)
    return int(lib.subpel_sad(
        ref_window.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), stride,
        sp, n, sx, sy,
        fx.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        fy.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))))


_FILTERS_I16 = None


def _filters_i16():
    global _FILTERS_I16
    if _FILTERS_I16 is None:
        from tpu_vp9_torch.bitstream import tables as T

        _FILTERS_I16 = np.ascontiguousarray(
            T.subpel_filters(T.InterpFilter.EIGHTTAP), np.int16)
    return _FILTERS_I16


_FILTERS_ADDR = None


def _filters_addr() -> int:
    global _FILTERS_ADDR
    if _FILTERS_ADDR is None:
        _FILTERS_ADDR = _filters_i16().ctypes.data
    return _FILTERS_ADDR


def native_mc_sad(ref_padded, border: int, mi_row: int, mi_col: int,
                  w: int, h: int, mv_q3, mi_rows: int, mi_cols: int,
                  src_block):
    """Fused MC (exact 8-tap, UMV clamp) + SAD for a w x h luma block.

    ref_padded: border-extended uint8 plane; src_block: any uint8 view
    with unit column stride.  Returns int SAD or None if the library is
    unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    src = np.asarray(src_block)
    if src.dtype != np.uint8 or src.strides[1] != 1:
        src = np.ascontiguousarray(src, np.uint8)
    return int(lib.mc_block_sad(
        ref_padded.ctypes.data, ref_padded.strides[0], border,
        mi_row, mi_col, w, h, int(mv_q3[0]), int(mv_q3[1]),
        mi_rows, mi_cols, src.ctypes.data, src.strides[0],
        _filters_addr()))


def native_mc_sad_avg(ref0_padded, ref1_padded, border: int, mi_row: int,
                      mi_col: int, w: int, h: int, mv0_q3, mv1_q3,
                      mi_rows: int, mi_cols: int, src_block):
    """Compound averaged MC + SAD ((p0 + p1 + 1) >> 1 per spec)."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.asarray(src_block)
    if src.dtype != np.uint8 or src.strides[1] != 1:
        src = np.ascontiguousarray(src, np.uint8)
    return int(lib.mc_block_sad_avg(
        ref0_padded.ctypes.data, ref0_padded.strides[0],
        ref1_padded.ctypes.data, ref1_padded.strides[0], border,
        mi_row, mi_col, w, h,
        int(mv0_q3[0]), int(mv0_q3[1]), int(mv1_q3[0]), int(mv1_q3[1]),
        mi_rows, mi_cols, src.ctypes.data, src.strides[0],
        _filters_addr()))


def native_mc_sse(ref_padded, border: int, mi_row: int, mi_col: int,
                  w: int, h: int, mv_q3, mi_rows: int, mi_cols: int,
                  src_block):
    """Fused MC + squared error (fast-loop RD metric; q^2-lambda
    consistent, sees compound noise-averaging gains)."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.asarray(src_block)
    if src.dtype != np.uint8 or src.strides[1] != 1:
        src = np.ascontiguousarray(src, np.uint8)
    return int(lib.mc_block_sse(
        ref_padded.ctypes.data, ref_padded.strides[0], border,
        mi_row, mi_col, w, h, int(mv_q3[0]), int(mv_q3[1]),
        mi_rows, mi_cols, src.ctypes.data, src.strides[0],
        _filters_addr()))


def native_mc_sse_avg(ref0_padded, ref1_padded, border: int, mi_row: int,
                      mi_col: int, w: int, h: int, mv0_q3, mv1_q3,
                      mi_rows: int, mi_cols: int, src_block):
    """Compound averaged MC + squared error."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.asarray(src_block)
    if src.dtype != np.uint8 or src.strides[1] != 1:
        src = np.ascontiguousarray(src, np.uint8)
    return int(lib.mc_block_sse_avg(
        ref0_padded.ctypes.data, ref0_padded.strides[0],
        ref1_padded.ctypes.data, ref1_padded.strides[0], border,
        mi_row, mi_col, w, h,
        int(mv0_q3[0]), int(mv0_q3[1]), int(mv1_q3[0]), int(mv1_q3[1]),
        mi_rows, mi_cols, src.ctypes.data, src.strides[0],
        _filters_addr()))


def native_inv_txfm_add(coeffs, pred, n: int, tx_type: int):
    """Batched exact inverse transform + pred add (bit-identical to
    ops/txfm's Python butterflies).  coeffs/pred: (..., n, n); returns
    uint8 of the same shape, or None if unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "inv_txfm_add_batch"):
        return None
    c = np.asarray(coeffs)
    shape = c.shape
    c = np.ascontiguousarray(c.reshape(-1, n, n), np.int32)
    p = np.ascontiguousarray(
        np.broadcast_to(np.asarray(pred, np.uint8), shape)
        .reshape(-1, n, n))
    out = np.empty_like(p)
    lib.inv_txfm_add_batch(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, tx_type, c.shape[0])
    return out.reshape(shape)


def native_sad_search_batch(src_plane, ref_padded, border: int, jobs):
    """Batched rect full-pel searches (one call per partition-tree
    level; zero-mv guard applied in C).  jobs: (N, 7) int32 rows
    (px, py, w, h, cy, cx, r).  Returns (N, 3) int32 (dy, dx, sad) or
    None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sad_search_batch"):
        return None
    src = np.asarray(src_plane)
    ref = np.asarray(ref_padded)
    if src.dtype != np.uint8 or src.strides[1] != 1:
        src = np.ascontiguousarray(src, np.uint8)
    if ref.dtype != np.uint8 or ref.strides[1] != 1:
        ref = np.ascontiguousarray(ref, np.uint8)
    jobs = np.ascontiguousarray(jobs, np.int32)
    n = jobs.shape[0]
    out = np.zeros((n, 3), np.int32)
    lib.sad_search_batch(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(src.strides[0]),
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(ref.strides[0]),
        border, ref.shape[0], ref.shape[1],
        jobs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def native_sad_search_rect(src_block, region, region_stride: int, r: int):
    """Rect full-pel exhaustive search.

    src_block and region may be strided VIEWS (row stride passed
    through; no copies — the per-call ascontiguousarray copy was the
    top per-probe overhead of the M0-M4 partition descent)."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.asarray(src_block)
    if src.dtype != np.uint8 or src.strides[1] != 1:
        src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape
    reg = np.asarray(region)
    if reg.dtype != np.uint8 or reg.strides[1] != 1:
        reg = np.ascontiguousarray(region, dtype=np.uint8)
        region_stride = reg.strides[0]
    best = np.zeros(3, np.int32)
    lib.sad_full_search_rect(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.strides[0],
        w, h, reg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        region_stride, r,
        best.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return int(best[0]), int(best[1]), int(best[2])


def native_subpel_refine_rect(ref_padded, border: int, px: int, py: int,
                              src_block, mv_full):
    """Rect iterative subpel refinement; returns (mv_q3, sad) or None."""
    lib = get_lib()
    if lib is None:
        return None
    f = _filters_i16()
    src = np.asarray(src_block)
    if src.dtype != np.uint8 or src.strides[1] != 1:
        src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape
    stride = ref_padded.strides[0]
    base = ref_padded[border + py : border + py + 1,
                      border + px : border + px + 1]
    out = np.zeros(3, np.int32)
    lib.subpel_refine_rect(
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), stride,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.strides[0],
        w, h, mv_full[0] * 8, mv_full[1] * 8,
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return (int(out[0]), int(out[1])), int(out[2])


def native_sad_search(src_block, region, region_stride: int, r: int):
    lib = get_lib()
    if lib is None:
        return None
    s, sp = _as_u8(np.asarray(src_block))
    reg = np.ascontiguousarray(region, dtype=np.uint8)
    rp = reg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    best = np.zeros(3, np.int32)
    lib.sad_full_search(sp, src_block.shape[0], rp, region_stride, r,
                        best.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return int(best[0]), int(best[1]), int(best[2])


def native_fast_loop_decide(mi_rows: int, mi_cols: int, tile_mi_start: int,
                            tile_mi_end: int, border: int, frame_w: int,
                            frame_h: int, src_plane, ref_triples, ranges3,
                            lam: int, do_subpel: bool, restrict: bool,
                            sign_bias4, prev_mvs, fields, leaves):
    """Run the whole fast-loop mode decision for one tile natively.

    ref_triples: list of 3 entries (LAST/GOLDEN/ALTREF), each None or
    (full_plane, half_or_None, quarter_or_None) uint8 C-contiguous.
    ranges3: per-ref full-pel search range (<=0 marks an absent ref).
    prev_mvs: None or (ref0 i8, ref1 i8, mv0 i32, mv1 i32) grids.
    fields: the ModeInfoGrid flat arrays (f_inter, f_ref0, f_ref1,
    f_mode, f_mv, f_mv1) — updated in place in decode order.
    leaves: (n, 3) int32 array of (mi_row, mi_col, bsize).
    Returns (n, 16) int32 decision rows (see vp9_native.cpp layout).
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "fast_loop_decide"):
        return None
    ref_ptrs = (ctypes.c_void_p * 9)()
    ref_dims = np.zeros(6, np.int32)
    keep = []
    for r in range(3):
        tri = ref_triples[r]
        if tri is None:
            continue
        full, half, quarter = tri
        keep.append(full)
        ref_ptrs[r * 3] = full.ctypes.data
        ref_dims[r * 2] = full.shape[0]
        ref_dims[r * 2 + 1] = full.shape[1]
        if half is not None:
            keep.extend([half, quarter])
            ref_ptrs[r * 3 + 1] = half.ctypes.data
            ref_ptrs[r * 3 + 2] = quarter.ctypes.data
    ranges = np.asarray(ranges3, np.int32)
    sb = np.asarray(sign_bias4, np.int32)
    if prev_mvs is not None:
        p0, p1, m0, m1 = prev_mvs
        pr0, pr1 = p0.ctypes.data, p1.ctypes.data
        pm0, pm1 = m0.ctypes.data, m1.ctypes.data
    else:
        pr0 = pr1 = pm0 = pm1 = None
    f_inter, f_ref0, f_ref1, f_mode, f_mv0, f_mv1 = fields
    leaves = np.ascontiguousarray(leaves, np.int32)
    n = leaves.shape[0]
    out = np.zeros((n, 16), np.int32)
    lib.fast_loop_decide(
        mi_rows, mi_cols, tile_mi_start, tile_mi_end, border,
        frame_w, frame_h,
        src_plane.ctypes.data, src_plane.strides[0],
        ref_ptrs, ref_dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ranges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(lam), int(do_subpel), int(restrict),
        sb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pr0, pr1, pm0, pm1,
        f_inter.ctypes.data, f_ref0.ctypes.data, f_ref1.ctypes.data,
        f_mode.ctypes.data, f_mv0.ctypes.data, f_mv1.ctypes.data,
        leaves.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        _filters_addr(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def native_mc_predict_winners(ref_plane_sets, border: int, mi_rows: int,
                              mi_cols: int, jobs):
    """Batched winner MC (Y/U/V, compound-averaged when ref1 > 0).

    ref_plane_sets: dict {ref_id: (y, u, v) border-extended planes}.
    jobs: (n, 9) int32 (mi_row, mi_col, bsize, ref0, ref1, mv0r, mv0c,
    mv1r, mv1c).  Returns a list of (y, u, v) uint8 arrays per job, or
    None when the library is unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "mc_predict_winners"):
        return None
    from tpu_vp9_torch.bitstream.tables import BLOCK_WH, BlockSize

    ptrs = (ctypes.c_void_p * 9)()
    strides = np.zeros(9, np.int64)
    for rid, planes in ref_plane_sets.items():
        if planes is None:
            continue
        for p in range(3):
            arr = planes[p]
            ptrs[(rid - 1) * 3 + p] = arr.ctypes.data
            strides[(rid - 1) * 3 + p] = arr.strides[0]
    jobs = np.ascontiguousarray(jobs, np.int32)
    n = jobs.shape[0]
    sizes = np.empty(n, np.int64)
    shapes = []
    for i in range(n):
        w, h = BLOCK_WH[BlockSize(int(jobs[i, 2]))]
        shapes.append((w, h))
        sizes[i] = w * h + 2 * ((w // 2) * (h // 2))
    offsets = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    out = np.empty(int(sizes.sum()), np.uint8)
    lib.mc_predict_winners(
        ptrs, strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        border, mi_rows, mi_cols,
        jobs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        _filters_addr(), out.ctypes.data,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    preds = []
    for i in range(n):
        w, h = shapes[i]
        o = int(offsets[i])
        y = out[o : o + w * h].reshape(h, w)
        o += w * h
        cw, ch = w // 2, h // 2
        u = out[o : o + cw * ch].reshape(ch, cw)
        o += cw * ch
        v = out[o : o + cw * ch].reshape(ch, cw)
        preds.append((y, u, v))
    return preds


def native_optimize_coeffs_batch(levels, coeffs, tx_size: int, tx_type: int,
                                 probs_full, ctx0, lam: float, q_dc: int,
                                 q_ac: int, q_shift: int):
    """Trellis-optimize a batch of quantized level blocks in place.

    levels: (B, n, n) int32 C-contiguous (modified); coeffs: (B, n, n)
    float32 transform coefficients.  Returns (B,) new eobs or None when
    the library is unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "optimize_coeffs_batch"):
        return None
    levels = np.ascontiguousarray(levels, np.int32)
    coeffs = np.ascontiguousarray(coeffs, np.float32)
    b, n, _ = levels.shape
    c0 = np.full(b, ctx0, np.int32) if np.isscalar(ctx0) \
        else np.ascontiguousarray(ctx0, np.int32)
    probs = np.ascontiguousarray(probs_full, np.uint8)
    eobs = np.zeros(b, np.int32)
    lib.optimize_coeffs_batch(
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, n, int(tx_size), int(tx_type),
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        c0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        float(lam), int(q_dc), int(q_ac), int(q_shift),
        eobs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return levels, eobs


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_rt_serialize(geom, split32, m32, m16f, strip, prev_mvs, fc,
                        counts_on: bool, scan_ks=(0, 0, 0, 0),
                        sign_bias=(0, 0, 0, 0)):
    """Serialize one RT P-frame tile natively (classification fused).

    geom: tpu_encdec.Geom.  m32/m16f/strip: per-zone dicts with keys
    mv (B,2 int), ref (B int8 or None), skip (B bool/u8), lv_y/lv_u/lv_v
    (int16 blocks); m16f/strip may be None.  prev_mvs: snapshot tuple or
    None.  Returns (tile_bytes, counts_dict_or_None, grid_fields,
    out_modes) where grid_fields = (f_inter, f_ref0, f_ref1, f_mode,
    f_mv0, f_mv1, f_skip) and out_modes rows are (mode, mode_ctx,
    nearest_r, nearest_c) in decode order.  None if unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "rt_serialize"):
        return None
    from tpu_vp9_torch.bitstream.tokenize import full_probs_for
    from tpu_vp9_torch.bitstream.tables import TxSize

    g = geom
    mi_rows, mi_cols = g.mi_rows, g.mi_cols

    scan = any(int(k) > 0 for k in scan_ks)

    def zone_args(z, n):
        if z is None:
            return (None, None, None, None, None, None)
        mv = np.ascontiguousarray(z["mv"], np.int32)
        # device zones carry a 0/1/2 LAST/GOLDEN/ALTREF selector; the
        # serializer wants RefFrame ids (1=LAST, 2=GOLDEN, 3=ALTREF)
        ref = (np.ascontiguousarray(
                   np.asarray(z["ref"]).astype(np.int8) + 1)
               if z.get("ref") is not None else None)
        skip = np.ascontiguousarray(z["skip"], np.uint8)
        if scan:
            # int8 scan-ordered prefixes from the device (K per block)
            ly = np.ascontiguousarray(z["lvs_y"], np.int16)
            lu = np.ascontiguousarray(z["lvs_u"], np.int16)
            lv = np.ascontiguousarray(z["lvs_v"], np.int16)
        else:
            ly = np.ascontiguousarray(z["lv_y"], np.int16)
            lu = np.ascontiguousarray(z["lv_u"], np.int16)
            lv = np.ascontiguousarray(z["lv_v"], np.int16)
        return (mv, ref, skip, ly, lu, lv)

    a32 = zone_args(m32, 32)
    a16 = zone_args(m16f, 16)
    ast = zone_args(strip, 16)
    split_arr = (np.ascontiguousarray(split32, np.int32)
                 if split32 is not None else None)
    if prev_mvs is not None:
        p0 = np.ascontiguousarray(prev_mvs[0], np.int8)
        p1 = np.ascontiguousarray(prev_mvs[1], np.int8)
        pm0 = np.ascontiguousarray(prev_mvs[2], np.int32)
        pm1 = np.ascontiguousarray(prev_mvs[3], np.int32)
    else:
        p0 = p1 = pm0 = pm1 = None

    def comp_pack(c):
        out = np.zeros(33, np.uint8)
        out[0] = int(c.sign)
        out[1:11] = np.asarray(c.classes, np.uint8)
        out[11] = int(np.asarray(c.class0).reshape(-1)[0])
        out[12:22] = np.asarray(c.bits, np.uint8)
        out[22:28] = np.asarray(c.class0_fp, np.uint8).reshape(-1)
        out[28:31] = np.asarray(c.fp, np.uint8)
        out[31] = int(c.class0_hp)
        out[32] = int(c.hp)
        return out

    sb_arr = np.ascontiguousarray(np.asarray(sign_bias, np.int32))
    part_p = np.ascontiguousarray(fc.partition_probs, np.uint8)
    skip_p = np.ascontiguousarray(fc.skip_probs, np.uint8)
    ii_p = np.ascontiguousarray(fc.intra_inter_probs, np.uint8)
    sr_p = np.ascontiguousarray(fc.single_ref_probs, np.uint8)
    im_p = np.ascontiguousarray(fc.inter_mode_probs, np.uint8)
    nj_p = np.ascontiguousarray(fc.nmv.joints, np.uint8)
    c0_p = comp_pack(fc.nmv.comps[0])
    c1_p = comp_pack(fc.nmv.comps[1])
    cy32 = np.ascontiguousarray(
        full_probs_for(fc, TxSize.TX_32X32, False, True), np.uint8)
    cuv16 = np.ascontiguousarray(
        full_probs_for(fc, TxSize.TX_16X16, True, True), np.uint8)
    cy16 = np.ascontiguousarray(
        full_probs_for(fc, TxSize.TX_16X16, False, True), np.uint8)
    cuv8 = np.ascontiguousarray(
        full_probs_for(fc, TxSize.TX_8X8, True, True), np.uint8)

    counts = None
    if counts_on:
        from tpu_vp9_torch.codec.adapt import new_mode_counts
        from tpu_vp9_torch.codec.intra_frame import new_counts_sink

        counts = {**new_counts_sink(), **new_mode_counts()}

    def cnt(key):
        return _i64p(counts[key]) if counts is not None else None

    def coefc(ts, uv):
        if counts is None:
            return None, None
        c = counts[("coef", ts)][1 if uv else 0, 1]
        e = counts[("eob", ts)][1 if uv else 0, 1]
        assert c.flags["C_CONTIGUOUS"] and e.flags["C_CONTIGUOUS"]
        return _i64p(c), _i64p(e)

    ccy32, cey32 = coefc(TxSize.TX_32X32, False)
    ccuv16, ceuv16 = coefc(TxSize.TX_16X16, True)
    ccy16, cey16 = coefc(TxSize.TX_16X16, False)
    ccuv8, ceuv8 = coefc(TxSize.TX_8X8, True)

    shape = (mi_rows, mi_cols)
    f_inter = np.zeros(shape, np.uint8)
    f_ref0 = np.zeros(shape, np.int8)
    f_ref1 = np.full(shape, -1, np.int8)
    f_mode = np.zeros(shape, np.int8)
    f_mv0 = np.zeros(shape + (2,), np.int32)
    f_mv1 = np.zeros(shape + (2,), np.int32)
    f_skip = np.zeros(shape, np.uint8)
    n_leaves_cap = g.rows32 * g.cols32 * 4 + (g.cols16 if g.strip else 0) + 64
    out_modes = np.zeros((n_leaves_cap, 4), np.int32)
    cap = max(1 << 16, g.width * g.height)
    out = np.zeros(cap, np.uint8)

    def p_or_none(a):
        return a.ctypes.data if a is not None else None

    n = lib.rt_serialize(
        mi_rows, mi_cols, g.rows32, g.cols32, 1 if strip is not None else 0,
        p_or_none(split_arr),
        int(scan_ks[0]), int(scan_ks[1]), int(scan_ks[2]), int(scan_ks[3]),
        *(p_or_none(x) for x in a32),
        *(p_or_none(x) for x in a16),
        *(p_or_none(x) for x in ast),
        p_or_none(p0), p_or_none(p1), p_or_none(pm0), p_or_none(pm1),
        sb_arr.ctypes.data,
        part_p.ctypes.data, skip_p.ctypes.data, ii_p.ctypes.data,
        sr_p.ctypes.data, im_p.ctypes.data, nj_p.ctypes.data,
        c0_p.ctypes.data, c1_p.ctypes.data,
        cy32.ctypes.data, cuv16.ctypes.data, cy16.ctypes.data,
        cuv8.ctypes.data,
        1 if counts_on else 0,
        cnt("partition"), cnt("skip"), cnt("intra_inter"),
        cnt("single_ref"), cnt("inter_mode"),
        cnt("mv_joints"), cnt("mv_sign"), cnt("mv_classes"),
        cnt("mv_class0"), cnt("mv_bits"), cnt("mv_class0_fp"),
        cnt("mv_fp"),
        ccy32, cey32, ccuv16, ceuv16, ccy16, cey16, ccuv8, ceuv8,
        f_inter.ctypes.data, f_ref0.ctypes.data, f_ref1.ctypes.data,
        f_mode.ctypes.data, f_mv0.ctypes.data, f_mv1.ctypes.data,
        f_skip.ctypes.data,
        out_modes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n <= 0:
        return None
    fields = (f_inter, f_ref0, f_ref1, f_mode, f_mv0, f_mv1, f_skip)
    return bytes(out[:n].tobytes()), counts, fields, out_modes
