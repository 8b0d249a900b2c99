"""The port's device keyframe against the JAX package's.

``tpu_vp9_torch.pipeline.tpu_encdec.make_kframe_step(geom, "cpu")`` (the
wavefront's plain version ``kframe_wave_ref`` and the loop filter's
``loop_filter_ref``, both in that module) against ``tpu_vp9.pipeline.tpu_encdec.
make_kframe_step`` on CPU-JAX, on the same padded planes made from a seed
with numpy, at three strip-free geometries (aligned; the overhang row,
mi_rows % 4 == 3; width % 64 == 32) and three qindex values.

Tolerance: none. Modes, levels, eobs and skip must be equal, the filtered
recon and the border-extended references bit-identical; zero flips are
expected. The JAX package's forward transform is float32 and the port's
float64, so a level could differ where JAX's float32 coefficient lies
within 1e-3 of a quantizer boundary (``|c| / q + 0.38`` near an integer):
only there is a difference allowed, and since a flipped level changes the
recon that later blocks predict from, it cascades along the wave. So a
difference is held to the first differing block in wave order: every
block before it equal, its unfiltered recon included; its mode equal; and
each of its levels that differs within 1e-3 of the boundary by JAX's own
float32 coefficient. A failure names that block and its margin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_vp9.ops import txfm as jax_txfm
from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.ops.txfm import TX_SIZE
from tpu_vp9_torch.ops.loopfilter import pick_filter_level, sharpness_limits
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.utils.yuv import panning_frames

torch.set_num_threads(1)

GEOMETRIES = [(128, 96), (160, 120), (96, 64)]
GEOM_IDS = ["aligned", "overhang", "odd_64_width"]
QINDICES = (10, 110, 255)
FLIP_BAND = 1e-3


def _planes(w, h, seed):
    """Padded (y, u, v) uint8 planes: a panning texture with a noise block
    and a flat block in the luma."""
    g = P.make_geom(w, h)
    rng = np.random.default_rng(seed)
    fr = next(panning_frames(w, h, 1, seed=seed))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    y, u, v = (P.pad_plane(np.asarray(p), *s)
               for p, s in zip((fr.y, fr.u, fr.v), shapes))
    y[:32, :32] = rng.integers(0, 256, (32, 32))
    y[32:64, 32:64] = 200
    return g, [np.ascontiguousarray(p) for p in (y, u, v)]


def _scalars(qidx):
    lim_t, mblim_t = sharpness_limits(0)
    lvl = pick_filter_level(qidx, True)
    ac = T.ac_quant(qidx)
    return (T.dc_quant(qidx), ac, max(1, (ac ** 2) >> 6), lvl,
            int(lim_t[lvl]), int(mblim_t[lvl]))


def _jax_step(w, h, planes, scalars):
    step = J.make_kframe_step(J.make_geom(w, h))  # memoized per geometry
    return step(*(jnp.asarray(p) for p in planes),
                *(jnp.asarray(s, jnp.int32) for s in scalars))


M32_BLOCK_KEYS = ("mode", "lv_y", "lv_u", "lv_v", "eob_y", "eob_u", "eob_v")
PLANES = (("y", 32), ("u", 16), ("v", 16))


def _wave_order(g):
    """Raster block indices in wave order: by anti-diagonal, then row."""
    rows = np.arange(g.n_blocks32) // g.cols32
    diag = rows + np.arange(g.n_blocks32) % g.cols32
    return np.lexsort((rows, diag))


def _block_view(plane, g, bi, n):
    r, c = divmod(int(bi), g.cols32)
    return plane[n * r:n * r + n, n * c:n * c + n]


def _check_flip(g, planes, sc, jm, pm, w, h):
    """The port's and JAX's block data differ somewhere: allowed only as a
    level flip at a quantizer boundary. Let ``bi`` be the first block in
    wave order whose mode, levels or eobs differ. Every block before it
    must match in full, its unfiltered recon included (JAX's from its
    step with the loop filter off), so both packages predicted ``bi`` from
    the same samples; the mode of ``bi`` must be equal; and at every
    (plane, coefficient) of ``bi`` whose level differs, JAX's float32
    ``|c| / q + 0.38`` must lie within FLIP_BAND of an integer."""
    dc_q, ac_q, lam = sc[:3]
    diff = np.zeros(g.n_blocks32, bool)
    for k in M32_BLOCK_KEYS:
        diff |= (pm[k].numpy() != np.asarray(jm[k])).reshape(
            g.n_blocks32, -1).any(axis=1)
    order = _wave_order(g)
    pos = int(np.argmax(diff[order]))
    bi, before = int(order[pos]), order[:pos]
    where = f"block {bi} (first in wave order of {int(diff.sum())} differing)"
    jraw, _ = _jax_step(w, h, planes, (dc_q, ac_q, lam, 0, 0, 0))
    praw = P.kframe_wave_ref(*(torch.from_numpy(p) for p in planes), g,
                             dc_q, ac_q, lam)
    for (name, n), prec in zip(PLANES, praw[7:]):
        jrec = np.asarray(jraw[f"rec_{name}"])
        for bj in before:
            np.testing.assert_array_equal(
                _block_view(prec.numpy(), g, bj, n),
                _block_view(jrec, g, bj, n),
                err_msg=f"unfiltered rec_{name} of block {bj}, before the "
                        f"first differing {where}")
    jmode, pmode = int(np.asarray(jm["mode"])[bi]), int(pm["mode"][bi])
    assert jmode == pmode, (f"{where}: mode {pmode} unlike JAX's {jmode} on "
                            "the same reference samples")
    r, c = divmod(bi, g.cols32)
    rr, cc = torch.tensor([r]), torch.tensor([c])
    margins = []
    for (name, n), src in zip(PLANES, planes):
        places = np.asarray(jm[f"lv_{name}"])[bi] != pm[f"lv_{name}"][bi].numpy()
        if not places.any():
            continue
        vis = g.height if n == 32 else (g.height + 1) >> 1
        jrec = torch.from_numpy(np.array(jraw[f"rec_{name}"]))
        ref, ha, hl = P._kf_refs(jrec, rr, cc, n, vis)
        pred = P.predict_intra_all(ref, ha, hl, n)[0, jmode].numpy()
        resid = (_block_view(src, g, bi, n).astype(np.int32)
                 - pred).astype(np.float32)
        coef = jax_txfm.fwd_txfm2d(jnp.asarray(resid[None]), TX_SIZE[n],
                                   T.TxType.DCT_DCT, jnp)[0]
        q = jnp.full((n, n), np.float32(ac_q)).at[0, 0].set(np.float32(dc_q))
        if n == 32:
            q = q * 0.5
        mag = np.asarray(jnp.abs(coef) / q + 0.38)[places]
        margins += np.abs(mag - np.rint(mag)).tolist()
    assert margins, f"{where}: eobs or modes differ with equal levels"
    worst = max(margins)
    assert worst < FLIP_BAND, (
        f"{where} has {len(margins)} levels unlike JAX's, and JAX's float32 "
        f"coefficient of one lies {worst:.2e} from a quantizer boundary "
        f"(allowed below {FLIP_BAND}); later blocks differ in cascade")


@pytest.mark.parametrize("qidx", QINDICES)
@pytest.mark.parametrize("w,h", GEOMETRIES, ids=GEOM_IDS)
def test_kframe_step_matches_jax(w, h, qidx):
    g, planes = _planes(w, h, seed=w + h)
    sc = _scalars(qidx)
    jouts, jrefs = _jax_step(w, h, planes, sc)
    pouts, prefs = P.make_kframe_step(g, "cpu")(
        *(torch.from_numpy(p) for p in planes), P.step_scalars(*sc))
    jm, pm = jouts["m32"], pouts["m32"]
    assert set(pm) == set(jm)
    for k in ("lv_y", "lv_u", "lv_v"):
        assert pm[k].dtype == torch.int16
    if any((pm[k].numpy() != np.asarray(jm[k])).any() for k in M32_BLOCK_KEYS):
        _check_flip(g, planes, sc, jm, pm, w, h)
        return
    for k in jm:
        np.testing.assert_array_equal(pm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=f"m32 {k}")
    for k in ("rec_y", "rec_u", "rec_v"):
        np.testing.assert_array_equal(pouts[k].numpy(), np.asarray(jouts[k]),
                                      err_msg=k)
    for a, b in zip(prefs, jrefs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg="border-extended reference")
    modes = pm["mode"].numpy()
    assert len(set(modes.tolist())) >= 2  # more than one mode in play


def test_kframe_wave_ref_matches_jax_wave():
    """The wavefront alone: with the loop filter off (level 0 copies) the
    JAX step's recon is its wave's unfiltered recon, edge-padded."""
    w, h = GEOMETRIES[1]
    g, planes = _planes(w, h, seed=3)
    qidx = 110
    dc, ac, lam = _scalars(qidx)[:3]
    jouts, _ = _jax_step(w, h, planes, (dc, ac, lam, 0, 0, 0))
    got = P.kframe_wave_ref(*(torch.from_numpy(p) for p in planes), g, dc,
                            ac, lam)
    names = ("mode", "lv_y", "lv_u", "lv_v", "eob_y", "eob_u", "eob_v")
    for name, t in zip(names, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jouts["m32"][name]),
                                      err_msg=name)
    for k, t in zip(("rec_y", "rec_u", "rec_v"), got[7:]):
        want = np.asarray(jouts[k])[:t.shape[0], :t.shape[1]]
        np.testing.assert_array_equal(t.numpy(), want, err_msg=k)


def test_kframe_wave_on_cpu_is_the_plain_version():
    """CPU planes reach the plain version through the step's dispatch,
    with no launch; the kernel's wrapper itself refuses them."""
    g, planes = _planes(96, 64, seed=5)
    ts = [torch.from_numpy(p) for p in planes]
    before = K.kframe_wave.launches
    sc = P.step_scalars(93, 112, 196, 10, 5, 20)
    got = P.kframe_wave_device(*ts, g, sc)
    want = P.kframe_wave_ref(*ts, g, 93, 112, 196)
    assert K.kframe_wave.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.kframe_wave(*ts, g, sc)
    assert K.kframe_wave.launches == before


def test_kframe_strip_geometry_is_refused():
    """A strip geometry, refused until the keyframe's strip was ported, is
    taken now: the step encodes its 32 zone and its strip ("m16"); the
    kernel's wrapper takes the geometry and refuses CPU planes as ever.
    Only a geometry ``make_geom`` refuses is refused."""
    g = P.make_geom(128, 112)  # mi_rows 14: the 16-pixel strip
    assert g.strip
    step = P.make_kframe_step(g, "cpu")
    planes = [torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8),
              torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8),
              torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8)]
    outs, refs = step(*planes, P.step_scalars(93, 112, 196, 10, 5, 20))
    assert tuple(outs["m16"]["mode"].shape) == (g.cols16,)
    assert tuple(outs["m16"]["lv_y"].shape) == (g.cols16, 16, 16)
    assert tuple(outs["rec_y"].shape) == (g.pad_h, g.pad_w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.kframe_wave(*planes, g, P.step_scalars(93, 112, 196, 10, 5, 20))
    # 176x144 has a strip too, but its width is no multiple of 32: the
    # geometry itself is refused first, in both packages
    for make in (P.make_geom, J.make_geom):
        with pytest.raises(ValueError, match="width % 32"):
            make(176, 144)
