"""Strip geometries in the port (mi_rows % 4 == 2: 720p and 4K, here
128x112 and 96x80), against the JAX package.

Below the 32 grid of a strip geometry lies a 16-pixel strip of 16x16
blocks at row ``strip_y``. The P-frame step encodes it as a second zone
(``encode_zone`` at n=16: a flat +-40 full-pel search, the quarter-pel
search on its windows, the zone's decision, MC and transform), the
keyframe step with the above-only modes V, D45 and D63 (the transform
ADST_DCT, DCT_DCT, ADST_DCT at TX16), and the session serializes it with
the 32 grid. Inputs are made from a numpy seed and go through both
packages on the CPU (the port's plain versions):
  - the strip zone alone, with and without GOLDEN and the rate tables;
  - the whole P-frame step at M9 and M8 and the keyframe step at three
    qindex values: every output array and the new references equal;
  - the ADST_DCT transform at n=16 against JAX's ``transform_recon
    (tx_type=)``: levels equal but where JAX's float32 ``|c| / q + 0.38``
    lies within 1e-3 of an integer (counted), eob and recon equal in
    every block whose levels are; the integer half at every eob; the
    premises of the CUDA kernel's ADST_DCT instance (its first forward
    product exact in any order, its second reading the DCT's F_col);
  - the port's ``RtSession`` and public ``Vp9Encoder`` at M9 and at M8
    (GOLDEN and rates, the descent off as in the JAX package): packets
    byte-identical to the JAX package's, decoded by the port's decoder
    bit-exactly to the recon; the Python serializer's packets the native
    one's;
  - the search windows of the strip at 720p and 4K stay inside the
    border-extended planes (torch slicing does not clamp as
    ``lax.dynamic_slice`` does).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config
from tpu_vp9.bitstream.tables import TxType
from tpu_vp9.ops import txfm as jtxfm
from tpu_vp9.pipeline import tpu_encdec as J
from tpu_vp9.pipeline.realtime import RtSession as JaxSession

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.ops import txfm as ptxfm
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.pipeline.realtime import RtSession as PortSession
from tpu_vp9_torch.utils.yuv import panning_frames

torch.set_num_threads(1)

# the test geometries: mi_rows 14 and 10, both % 4 == 2; 96 is an odd
# multiple of 32 (the padded-width loop filter)
STRIP_DIMS = [(128, 112), (96, 80)]
DIM_IDS = ["128x112", "96x80"]
ZONE_KEYS = ("mv", "ref", "skip", "eob_y", "eob_u", "eob_v", "lv_y", "lv_u",
             "lv_v", "rec_y", "rec_u", "rec_v", "dist_b", "rate_b")
KEY_KEYS = ("mode", "skip", "eob_y", "eob_u", "eob_v", "lv_y", "lv_u",
            "lv_v")
BOUNDARY_BAND = 1e-3  # JAX's float32 quantizer input near an integer
ADST_DCT = int(T.TxType.ADST_DCT)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=msg)


def _scalars(qidx):
    from tpu_vp9_torch.ops.loopfilter import pick_filter_level, \
        sharpness_limits

    lvl = pick_filter_level(qidx, False)
    lim_t, mblim_t = sharpness_limits(0)
    return (T.dc_quant(qidx), T.ac_quant(qidx),
            max(1, (T.ac_quant(qidx) ** 2) >> 6), lvl, int(lim_t[lvl]),
            int(mblim_t[lvl]))


def _step_inputs(w, h, seed):
    """One P-frame's inputs for both packages, as numpy: source planes,
    LAST and GOLDEN border-extended planes, the previous MVs of the 32
    grid and of the strip (the first strip MVs far out, past the window's
    reach), rate tables. GOLDEN holds the source's own content in the
    strip's left half (its ZERO candidate is perfect there) and an older
    frame elsewhere; LAST is the frame before."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    frames = list(panning_frames(w, h, 5, seed=seed))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))

    def planes(fr):
        return [np.asarray(p) for p in (fr.y, fr.u, fr.v)]

    cur, before = planes(frames[4]), planes(frames[3])
    src = [P.pad_plane(p, *shp) for p, shp in zip(cur, shapes)]
    gold_planes = [p.copy() for p in planes(frames[0])]
    for k, (gp, sp) in enumerate(zip(gold_planes, cur)):
        y0, xn = g.strip_y >> (k > 0), (w // 2) >> (k > 0)
        gp[y0:, :xn] = sp[y0:, :xn]
    last = [t.numpy() for t in port_realtime.upload_refs(before, g, "cpu")]
    gold = [t.numpy() for t in
            port_realtime.upload_refs(gold_planes, g, "cpu")]
    prev32 = rng.integers(-64, 65, (g.n_blocks32, 2)).astype(np.int32)
    prev16 = rng.integers(-64, 65, (g.cols16, 2)).astype(np.int32)
    prev16[0] = (-330, 327)
    prev16[1] = (4000, -4000)
    fc = T.default_frame_context()
    fc.inter_mode_probs = rng.integers(
        1, 256, fc.inter_mode_probs.shape).astype(fc.inter_mode_probs.dtype)
    return g, src, last, gold, prev32, prev16, P.make_rate_tabs(fc, 120)


def _jax_rates(tabs):
    return {k: (jnp.asarray(v) if k != "mv_cost_max" else v)
            for k, v in tabs.items()}


def _jax_step(w, h, golden):
    """The JAX package's P-frame step as its session makes it (the same
    arguments, so that the tests of this file share one compile of each
    geometry and configuration: the steps, the sessions and the public
    encoders)."""
    return J.make_pframe_step(J.make_geom(w, h), split16=False,
                              golden=golden, blob_recon=True, aq=False,
                              descend_frac=4)


@pytest.mark.parametrize("with_gold", [False, True],
                         ids=["proxies", "golden_rates"])
def test_strip_zone_matches_jax_zone(with_gold):
    """``encode_zone`` at n=16 (the strip) against JAX's, every output
    array: with the rate proxies and LAST alone, and with GOLDEN and the
    frame's rate tables."""
    w, h = STRIP_DIMS[0]
    g, src, last, gold, _, prev16, tabs = _step_inputs(w, h, seed=w + h)
    sc = P.step_scalars(*_scalars(120))
    dc_q, ac_q, lam = _scalars(120)[:3]
    filt = torch.as_tensor(np.asarray(P.FILTERS, np.int32))
    kw = {}
    jkw = {}
    if with_gold:
        kw = dict(gold=tuple(_t(p) for p in gold),
                  rates=P.upload_rate_tabs(tabs, "cpu"))
        jkw = dict(gold=tuple(jnp.asarray(p) for p in gold),
                   rates=_jax_rates(tabs))
    got = P.encode_zone(*(_t(p) for p in src), *(_t(p) for p in last),
                        _t(prev16), g, sc, filt, P.new_bits_table("cpu"),
                        n=16, **kw)
    fn = jax.jit(lambda s, l, pm: J.encode_zone(
        *s, *l, pm, J.make_geom(w, h), 16, jnp.int32(dc_q), jnp.int32(ac_q),
        jnp.int32(lam), P.FILTERS, **jkw))
    want = fn(tuple(jnp.asarray(p) for p in src),
              tuple(jnp.asarray(p) for p in last), jnp.asarray(prev16))
    for k in ZONE_KEYS:
        _eq(got[k], want[k], k)
    assert tuple(got["rec_y"].shape) == (16, w)
    assert int((got["mv"] != 0).any(dim=1).sum()) > g.cols16 // 2
    if with_gold:
        ref = got["ref"].numpy()
        assert 0 < ref.sum() < ref.size  # both references in use


@pytest.mark.parametrize("m8,dims", [(False, (128, 112)), (True, (128, 112)),
                                     (False, (96, 80))],
                         ids=["m9_128x112", "m8_128x112", "m9_96x80"])
def test_pframe_step_matches_jax_step(m8, dims):
    """The whole step at M9 (LAST, proxies) and at M8 (GOLDEN and the rate
    tables; the descent off at a strip geometry): the 32 zone, the strip
    ("m16"), the loop-filtered planes and the new references."""
    w, h = dims
    g, src, last, gold, prev32, prev16, tabs = _step_inputs(w, h,
                                                            seed=w - h)
    scalars = _scalars(120)
    jsrc = [jnp.asarray(a) for a in src + last]
    jstep = _jax_step(w, h, m8)
    if m8:
        jouts, jrefs = jstep(
            *jsrc, *(jnp.asarray(a) for a in gold), jnp.asarray(prev32),
            jnp.asarray(prev16), *(jnp.asarray(v, jnp.int32)
                                   for v in scalars),
            *(jnp.asarray(tabs[k]) for k in ("mode_cost", "joint_cost",
                                             "nmv_row", "nmv_col",
                                             "ref_cost", "lam_bits")))
        pouts, prefs = P.make_pframe_step(g, "cpu", golden=True)(
            *(_t(a) for a in src + last + gold), _t(prev32), _t(prev16),
            P.step_scalars(*scalars), P.upload_rate_tabs(tabs, "cpu"))
    else:
        jouts, jrefs = jstep(
            *jsrc, jnp.asarray(prev32), jnp.asarray(prev16),
            *(jnp.asarray(v, jnp.int32) for v in scalars))
        pouts, prefs = P.make_pframe_step(g, "cpu")(
            *(_t(a) for a in src + last), _t(prev32), _t(prev16),
            P.step_scalars(*scalars))
    assert set(pouts) == {"m32", "m16", "rec_y", "rec_u", "rec_v"}
    for zone in ("m32", "m16"):
        for k in ZONE_KEYS:
            _eq(pouts[zone][k], jouts[zone][k], f"{zone} {k}")
    for k in ("rec_y", "rec_u", "rec_v"):
        _eq(pouts[k], jouts[k], k)
    for a, b in zip(prefs, jrefs):
        _eq(a, b, "new reference")
    if m8:
        assert int(pouts["m16"]["ref"].sum()) > 0


@pytest.mark.parametrize("qindex", [10, 100, 255])
@pytest.mark.parametrize("dims", STRIP_DIMS, ids=DIM_IDS)
def test_kframe_step_matches_jax_step(dims, qindex):
    """The keyframe step: the wave's 32 zone, the strip's above-only modes
    through their transform types, the loop-filtered planes and the new
    references."""
    w, h = dims
    g = P.make_geom(w, h)
    fr = next(panning_frames(w, h, 1, seed=qindex + w))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    src = [P.pad_plane(np.asarray(p), *shp)
           for p, shp in zip((fr.y, fr.u, fr.v), shapes)]
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
    lam = max(1, (ac_q ** 2) >> 6)
    lf = (20, 7, 50)
    jouts, jrefs = J.make_kframe_step(J.make_geom(w, h))(
        *(jnp.asarray(p) for p in src),
        *(jnp.int32(v) for v in (dc_q, ac_q, lam, *lf)))
    pouts, prefs = P.make_kframe_step(g, "cpu")(
        *(_t(p) for p in src), P.step_scalars(dc_q, ac_q, lam, *lf))
    for zone in ("m32", "m16"):
        for k in KEY_KEYS:
            _eq(pouts[zone][k], jouts[zone][k], f"{zone} {k}")
    for k in ("rec_y", "rec_u", "rec_v"):
        _eq(pouts[k], jouts[k], k)
    for a, b in zip(prefs, jrefs):
        _eq(a, b, "new reference")
    assert int(pouts["kf_status"][0]) == 0
    modes = set(pouts["m16"]["mode"].tolist())
    assert modes <= {int(m) for m in P.KF_STRIP_MODES}


# ---------------------------------------------------------------------------
# the ADST_DCT transform at n=16
# ---------------------------------------------------------------------------


def _blocks(seed):
    """(src, pred) uint8 (B, 16, 16): 24 prediction errors (a smooth
    source, the prediction within +-60), 6 blocks of +-255 residuals, 4 of
    zero residual."""
    rng = np.random.default_rng(seed)
    n = 16
    yy, xx = np.mgrid[0:n, 0:n]
    phase = rng.uniform(0, 6, (24, 1, 1))
    src = np.clip(128 + 90 * np.sin(0.2 * yy + 0.3 * xx + phase)
                  + rng.normal(0, 8, (24, n, n)), 0, 255).astype(np.uint8)
    pred = np.clip(src.astype(int) + rng.integers(-60, 61, src.shape), 0,
                   255).astype(np.uint8)
    ext = rng.choice([0, 255], (6, n, n)).astype(np.uint8)
    ext[0], ext[1] = 255, 0
    same = rng.integers(0, 256, (4, n, n), dtype=np.uint8)
    return (np.concatenate([src, ext, same]),
            np.concatenate([pred, 255 - ext, same]))


@pytest.mark.parametrize("qindex", [0, 10, 100, 255])
def test_adst_dct_transform_matches_jax_but_for_boundary_flips(qindex):
    src, pred = _blocks(seed=qindex + 5)
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
    lv_j, eob_j, rec_j = (np.asarray(a) for a in J.transform_recon(
        jnp.asarray(src), jnp.asarray(pred), jnp.int32(dc_q),
        jnp.int32(ac_q), 16, tx_type=TxType.ADST_DCT))
    lv_p, eob_p, rec_p = P.transform_recon_ref(_t(src), _t(pred), dc_q, ac_q,
                                               16, ADST_DCT)
    flips = np.argwhere(lv_p.numpy() != lv_j)
    if len(flips):
        resid = (src.astype(np.int32) - pred).astype(np.float32)
        coeffs = np.asarray(jtxfm.fwd_txfm2d(
            jnp.asarray(resid), J._TS[16], TxType.ADST_DCT, jnp))
        q = np.full((16, 16), ac_q, np.float32)
        q[0, 0] = dc_q
        mag = np.abs(coeffs) / q + np.float32(0.38)
        for b, i, j in flips:
            assert abs(int(lv_p[b, i, j]) - int(lv_j[b, i, j])) == 1
            assert abs(mag[b, i, j] - np.round(mag[b, i, j])) < BOUNDARY_BAND
    print(f"qindex {qindex}: {len(flips)} level flips of {lv_j.size}")
    assert len(flips) <= lv_j.size // 1000
    same = ~(lv_p.numpy() != lv_j).reshape(len(src), -1).any(axis=1)
    np.testing.assert_array_equal(eob_p.numpy()[same], eob_j[same])
    np.testing.assert_array_equal(rec_p.numpy()[same], rec_j[same])
    assert not lv_j[-4:].any() and not eob_j[-4:].any()
    # the DCT_DCT transform of the same blocks differs: the type is used
    assert not np.array_equal(
        P.transform_recon_ref(_t(src), _t(pred), dc_q, ac_q, 16)[0].numpy(),
        lv_p.numpy())


def test_adst_dct_recon_from_levels_matches_jax_at_every_eob():
    """One nonzero level at each place of the ADST_DCT scan (not the
    DCT's) and the largest levels: the integer half equals JAX's."""
    n, nn = 16, 256
    dc_q, ac_q = T.dc_quant(60), T.ac_quant(60)
    scan = np.asarray(T.scan_order(J._TS[n], TxType.ADST_DCT)[0])
    assert not np.array_equal(
        scan, np.asarray(T.scan_order(J._TS[n], TxType.DCT_DCT)[0]))
    levels = np.zeros((nn + 2, nn), np.int32)
    levels[np.arange(nn), scan] = np.where(np.arange(nn) % 2, 20, -3)
    levels[nn] = 8191
    levels[nn + 1] = -8191
    levels = levels.reshape(-1, n, n)
    pred = np.random.default_rng(3).integers(0, 256, levels.shape,
                                             dtype=np.uint8)
    eob_p, rec_p = P.recon_from_levels(_t(levels), _t(pred), dc_q, ac_q, n,
                                       ADST_DCT)
    deq = J._dequantize(jnp.asarray(levels), jnp.int32(dc_q),
                        jnp.int32(ac_q), n)
    rec_j = jtxfm.inv_txfm_add(deq, jnp.asarray(pred).astype(jnp.int32),
                               J._TS[n], TxType.ADST_DCT, jnp)
    np.testing.assert_array_equal(rec_p.numpy(), np.asarray(rec_j))
    np.testing.assert_array_equal(eob_p.numpy()[:nn], np.arange(1, nn + 1))


def test_adst_dct_kernel_premises():
    """The CUDA kernel's ADST_DCT instance: its first forward product,
    F_col of the ADST (float32 entries on a grid of 2^-25) times residuals
    of 9 bits, is exact in float64 in any order of summation; and the row
    matrix of ADST_DCT is the DCT's F_col transposed over 2^6, which the
    instance stages beside its own F_col."""
    cpu = torch.device("cpu")
    f_col, f_row_t = (m.numpy() for m in ptxfm._fwd_matrices64(
        16, cpu, T.TxType.ADST_DCT))
    f_dct = ptxfm._fwd_matrices64(16, cpu)[0].numpy()
    np.testing.assert_array_equal(f_row_t, f_dct.T * 2.0 ** -6)
    assert not np.array_equal(f_col, f_dct)
    f_int = f_col * 2.0 ** 25
    assert np.array_equal(f_int, np.round(f_int))
    f_int = f_int.astype(np.int64)
    # every partial sum an integer multiple of 2^-25, of at most 42 bits
    assert int(np.abs(f_int).sum(axis=1).max()) * 255 < 2 ** 42
    rng = np.random.default_rng(116)
    for r in (rng.integers(-255, 256, (200, 16, 16)),
              rng.choice([-255, 255], (200, 16, 16))):
        exact = (f_int @ r).astype(np.float64) / 2.0 ** 25
        got = torch.matmul(torch.from_numpy(f_col),
                           torch.from_numpy(r).to(torch.float64)).numpy()
        rev = np.zeros(r.shape)
        for k in reversed(range(16)):
            rev = rev + f_col[None, :, k, None] * r[:, None, k, :]
        np.testing.assert_array_equal(got, exact)
        np.testing.assert_array_equal(rev, exact)


@pytest.mark.parametrize("n,tx_type", [(32, ADST_DCT), (8, ADST_DCT),
                                       (16, int(T.TxType.DCT_ADST))],
                         ids=["adst_dct_n32", "adst_dct_n8", "dct_adst_n16"])
def test_kernel_wrapper_refuses_a_type_it_has_no_instance_of(n, tx_type):
    """The kernel has DCT_DCT at every size and ADST_DCT at 16 only: the
    wrapper refuses any other type before it looks at the device."""
    src = torch.zeros((2, n, n), dtype=torch.uint8)
    with pytest.raises(ValueError, match="tx_type"):
        K.transform_recon(src, src, P.step_scalars(40, 48, 0, 0, 0, 0), n,
                          tx_type)


# ---------------------------------------------------------------------------
# windows, the session and the public encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(1280, 720), (3840, 2160)] + STRIP_DIMS,
                         ids=["720p", "4K"] + DIM_IDS)
def test_strip_windows_stay_inside_the_planes(dims):
    """The strip's +-WIN_R luma windows at ``strip_y`` and +-CHROMA_WIN_R
    chroma windows at ``strip_y / 2`` lie inside the border-extended
    planes, with room to spare below (a window that left the plane would
    raise)."""
    g = P.make_geom(*dims)
    assert g.strip and g.mi_rows % 4 == 2
    assert g.strip_y == 32 * g.rows32 and g.h_mi == g.strip_y + 16
    if dims == (1280, 720):
        assert (g.rows32, g.cols32, g.cols16, g.strip_y) == (22, 40, 80, 704)
    if dims == (3840, 2160):
        assert (g.rows32, g.cols32, g.cols16, g.strip_y) == (67, 120, 240,
                                                              2144)
    bd = 2 * P.BORDER
    for n, r, y0, hh, ww in ((16, P.WIN_R, g.strip_y, g.pad_h, g.pad_w),
                             (8, P.CHROMA_WIN_R, g.strip_y // 2,
                              g.pad_h // 2, g.pad_w // 2)):
        top, left, hgt, wid = P.window_bounds((hh + bd, ww + bd), n, 1,
                                              g.cols16, y0, r)
        assert top >= 0 and left >= 0
        assert top + hgt <= hh + bd - (P.BORDER - r - 4 - 16 // (n // 8))
        assert left + wid <= ww + bd


def test_strip_blocks_and_windows_are_contiguous():
    """The strip is one row of blocks, where a reshape of the plane stays a
    strided (or, for the windows, overlapping) view; the kernels take
    contiguous tensors only, so the blocks and windows the strip zone hands
    them are contiguous, as the 32 grid's are."""
    g = P.make_geom(128, 112)
    plane = torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8)
    ref = P.extend_borders_device(plane, g.width, g.height)
    for n, y0, rows, cols in ((16, g.strip_y, 1, g.cols16),
                              (8, g.strip_y // 2, 1, g.cols16),
                              (32, 0, g.rows32, g.cols32)):
        assert P._extract_blocks(plane, y0, rows, cols, n).is_contiguous()
        assert P._extract_search_windows(ref, n, rows, cols, y0)\
            .is_contiguous()


def _run(sess, frames, qindex):
    out = []
    for fr in frames:
        out += sess.send(fr, qindex=qindex)
    out += sess.flush()
    assert [e.pts for e in out] == list(range(len(frames)))
    return out


def _decode_exact(efs, w, h):
    """Decode with the port's decoder; every plane bit-exact to the
    recon."""
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(efs))
    for i, ef in enumerate(efs):
        write_ivf_frame(buf, ef.payload, i)
    buf.seek(0)
    dec = list(decode_ivf(buf))
    assert len(dec) == len(efs)
    for i, ((y, u, v, _), ef) in enumerate(zip(dec, efs)):
        for p, plane in enumerate((y, u, v)):
            np.testing.assert_array_equal(
                plane, ef.state.planes[p].recon[:plane.shape[0],
                                                :plane.shape[1]],
                err_msg=f"frame {i} plane {p}")
    return dec


@pytest.fixture
def host_outputs(monkeypatch):
    """Record the host dictionaries the port's session fetches."""
    seen = []
    real = port_realtime._device_out_to_host

    def spy(*args):
        host = real(*args)
        seen.append(host)
        return host

    monkeypatch.setattr(port_realtime, "_device_out_to_host", spy)
    return seen


@pytest.mark.parametrize("m8,dims", [(False, (128, 112)), (True, (128, 112)),
                                     (False, (96, 80))],
                         ids=["m9_128x112", "m8_128x112", "m9_96x80"])
def test_session_matches_jax_session(host_outputs, m8, dims):
    """Both sessions as they ship (the device keyframe, its strip
    included): every packet byte-identical; the strip's MVs the next
    frame's temporal candidates; at M8 (the descent off on both sides) the
    third picture is the first again, so that GOLDEN, still the keyframe,
    is picked in the strip, and GOLDEN is refreshed inside the clip."""
    w, h = dims
    n = 6 if m8 else 4
    frames = list(panning_frames(w, h, n, seed=w + h))
    kw = {}
    if m8:
        frames[2] = frames[0]
        kw = dict(split16=True, golden=True, golden_interval=3)
    jsess = JaxSession(w, h, want_recon=True, **kw)
    psess = PortSession(w, h, device="cpu", want_recon=True, **kw)
    assert not psess.split16 and not jsess.split16
    jefs = _run(jsess, frames, 120)
    pefs = _run(psess, frames, 120)
    psess.close()
    assert [e.is_keyframe for e in pefs] == [True] + [False] * (n - 1)
    for i, (a, b) in enumerate(zip(pefs, jefs)):
        assert a.payload == b.payload, f"packet {i} differs from JAX's"
    _decode_exact(pefs, w, h)
    assert len(host_outputs) == n - 1
    assert all("m16" in hst and "split32" not in hst for hst in host_outputs)
    if m8:
        assert sum(int((hst["m16"]["ref"] == 1).sum())
                   for hst in host_outputs) > 0


@pytest.mark.parametrize("m8", [False, True], ids=["m9", "m8"])
def test_python_serializer_matches_native(monkeypatch, m8):
    """Without the native library the session classifies the modes over
    the 32 grid and the strip and serializes in Python: the same packets."""
    w, h = 128, 112
    frames = list(panning_frames(w, h, 4, seed=21))
    kw = dict(golden=True, golden_interval=2) if m8 else {}
    native = _run(PortSession(w, h, device="cpu", **kw), frames, 120)
    monkeypatch.setattr(port_realtime, "serialize_device_frame",
                        lambda *a, **k: None)
    python = _run(PortSession(w, h, device="cpu", **kw), frames, 120)
    assert [e.payload for e in python] == [e.payload for e in native]


def _api_packets(api, enc_mode, frames, **kw):
    """Packets of a public encoder at ``enc_mode``, low-delay CQP at
    128x112, the recon kept (a recon file named); ``tpu_realtime=2``
    makes the JAX encoder take its realtime session on CPU-JAX."""
    enc = api.Vp9Encoder(**kw)
    config = jax_config if api is jax_api else port_config
    enc.set_parameter(config.EncoderConfig(
        source_width=128, source_height=112, enc_mode=enc_mode, qp=40,
        pred_structure=config.PredStructure.LOW_DELAY_P, tpu_realtime=2,
        recon_file="unused.yuv"))
    enc.init()
    assert enc._rt is not None and enc._rt.g.strip
    for fr in frames:
        enc.send_picture(fr)
    enc.flush()
    pkts = []
    while (pkt := enc.get_packet()) is not None:
        pkts.append(pkt)
    enc.close()
    return pkts


@pytest.mark.parametrize("enc_mode", [8, 9])
def test_public_encoder_matches_jax_encoder(enc_mode):
    """``tpu_vp9_torch.api.Vp9Encoder(device="cpu")`` against
    ``tpu_vp9.api.Vp9Encoder`` at 128x112, four frames: identical
    packets."""
    frames = list(panning_frames(128, 112, 4, seed=13))
    port = _api_packets(port_api, enc_mode, frames, device="cpu")
    ref = _api_packets(jax_api, enc_mode, frames)
    assert [p.is_keyframe for p in port] == [True, False, False, False]
    assert [(p.pts, p.data) for p in port] == [(p.pts, p.data) for p in ref]
