"""The step's window extraction and border extension: the dispatches
against the JAX package, ``tpu_vp9_torch/csrc/windows.cu`` on the CPU
against its plain versions, and the P-frame step with its mode decision,
windows, borders and motion compensation kernels on the CPU against the
plain step.

1. ``pipeline/tpu_encdec.py:extract_windows`` (several window sets of a
   zone, as a call site cuts them) and ``extend_borders`` (a recon's
   three planes) against the JAX package's ``_extract_search_windows``
   and ``extend_borders_device``, byte for byte: the 32 zone, the strip
   (n=16 and 8 at ``strip_y``), odd crops.
2. The two kernels built by g++ behind ``tests/cuda_standin/
   cuda_runtime.h`` (a host thread per CUDA thread; ``extend_borders``
   64 CTAs of the grid at once through ``standin_launch_all``,
   ``extract_windows`` a CTA per window and set) and launched by the
   wrappers ``ops/cuda_kernels.py:extract_windows`` and ``extend_borders``
   on CPU tensors (their device check answers "cuda"), byte for byte
   against the plain versions: up to eight window sets in one launch,
   the aligned path (rows of 8-byte stores from whole source words), rows
   that start inside a word (odd x0, an odd pitch, a plane one byte into
   its storage: the words realigned), sides that are no multiple of 8 (a
   byte a lane), every window at the plane's edge; the borders' aligned
   rows (16-byte interior words, broadcast border words) at the real
   row lengths of 1080p, 720p and 4K, the 1080p recon whole (1080 of 1088
   rows), a crop width no multiple of 16, border 0 and 96, a 1 x 1 crop,
   and their other rows (odd widths and crops, a plane one byte into its
   storage) in the same launch; and their refusals.
3. ``make_pframe_step`` with the dispatches ``mode_decide_mc``,
   ``descent_decide_mc``, ``extract_windows`` and ``extend_borders`` on
   the stand-ins (the three sources built) against the plain step: M8
   with GOLDEN and the descent, RA's ALTREF with GOLDEN, a strip geometry
   at tune SQ; every output and the new references equal, the launches
   counted (one window launch a zone and one more with ALTREF: MC reads
   the planes in place; the decisions run inside the MC launches).

What this cannot show: that nvcc accepts the source, or its speed;
``chip_smoke.py`` checks the kernels on the card.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.utils.yuv import panning_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
NAMES = ("extract_windows", "extend_borders", "mode_decide", "mc_predict")
# the decisions folded into MC: mc_predict.cu's decided launches, counted
# as mc_predict's
DECIDED = ("mode_decide_mc", "descent_decide_mc")

# each source's launch helpers as the stand-in runs them: every CTA of the
# grid at once (extract_windows: a CTA per window, one after another;
# extend_borders: 64 CTAs at once; mc_predict: sixteen CTAs at once); a
# trapped kernel fails its launch
_STANDIN_LAUNCH = {
    "windows": """
cudaError_t launch_extract(const WinJobs& js, int n_win, int n_jobs,
                           cudaStream_t) {
  for (int j = 0; j < n_jobs; ++j) {
    standin_launch(n_win, kThreads, [&] {
      blockIdx.y = j;
      extract_windows_kernel(js);
    });
  }
  return cudaSuccess;
}

cudaError_t launch_borders(const Jobs& js, cudaStream_t) {
  const int ctas = (js.rows + kRowWarps - 1) / kRowWarps;
  for (int c0 = 0; c0 < ctas; c0 += 64) {
    standin_launch_all(ctas - c0 < 64 ? ctas - c0 : 64, kThreads, [&] {
      blockIdx.x += c0;
      extend_borders_kernel(js);
    });
  }
  return cudaSuccess;
}

""",
    "mode_decide": """
cudaError_t launch_md(const MdArgs& a, cudaStream_t) {
  standin_launch_all((a.b + kWarps - 1) / kWarps, kThreads,
                     [&] { mode_decide_kernel(a); });
  return standin_take_trap();
}

""",
    "mc_predict": """
template <int N, int D>
cudaError_t launch(const McArgs& a, cudaStream_t) {
  const int ctas = (a.nblk + kWarps - 1) / kWarps;
  for (int p = 0; p < kPlanes; ++p) {
    for (int c0 = 0; c0 < ctas; c0 += 16) {
      standin_launch_all(ctas - c0 < 16 ? ctas - c0 : 16, kThreads, [&] {
        blockIdx.x += c0;
        blockIdx.y = p;
        mc_predict_kernel<N, D>(a);
      });
    }
  }
  return standin_take_trap();
}

template <int N, int D>
int occupancy(int* ctas_per_sm, int* smem_bytes) {
  *ctas_per_sm = 1;
  *smem_bytes = kSmem<N>;
  return 0;
}

"""}
_FIRST_HELPER = {"windows": "cudaError_t launch_extract(",
                 "mode_decide": "cudaError_t launch_md(",
                 "mc_predict": "template <int N, int D>\ncudaError_t launch("}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape, msg
    np.testing.assert_array_equal(got.numpy(), want, err_msg=msg)


def _planes(g, seed):
    """Random padded (y, u, v) planes of geometry ``g``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shp, dtype=np.uint8)
            for shp in ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
                        (g.pad_h // 2, g.pad_w // 2))]


# ---------------------------------------------------------------------------
# 1. the dispatches against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(128, 96), (128, 88), (96, 80),
                                  (128, 90)])
def test_extend_borders_matches_jax(dims):
    """A recon's three planes in one call, the chroma crop rounded up
    (128x90: 64 x 45, odd)."""
    g = P.make_geom(*dims)
    planes = _planes(g, sum(dims))
    got = P.extend_borders(tuple(_t(p) for p in planes), P.recon_crops(g))
    for p, crop, out in zip(planes, P.recon_crops(g), got):
        _eq(out, J.extend_borders_device(jnp.asarray(p), *crop))


def test_extend_borders_matches_jax_at_odd_crops():
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, shp, dtype=np.uint8)
              for shp in ((50, 70), (25, 35), (31, 17))]
    crops = ((67, 49), (33, 25), (1, 1))
    got = P.extend_borders(tuple(_t(p) for p in planes), crops, border=24)
    for p, crop, out in zip(planes, crops, got):
        _eq(out, J.extend_borders_device(jnp.asarray(p), *crop, border=24))


@pytest.mark.parametrize("dims", [(128, 96), (128, 112)])
def test_extract_windows_matches_jax(dims):
    """The MC site's five sets (LAST's U and V, GOLDEN's Y, U, V) of the
    32 zone in one call, and at a strip geometry the strip's luma and
    chroma sets at ``strip_y``."""
    g = P.make_geom(*dims)
    ref = [P.extend_borders_device(_t(p), *c)
           for p, c in zip(_planes(g, 7), P.recon_crops(g))]
    gold = [P.extend_borders_device(_t(p), *c)
            for p, c in zip(_planes(g, 8), P.recon_crops(g))]
    zones = [(0, g.rows32, g.cols32, 32)]
    if g.strip:
        zones.append((g.strip_y, 1, g.cols16, 16))
    for y0, rows, cols, n in zones:
        nc = n // 2
        jobs = [(ref[1], nc, y0 // 2, P.CHROMA_WIN_R),
                (ref[2], nc, y0 // 2, P.CHROMA_WIN_R),
                (gold[0], n, y0, P.WIN_R),
                (gold[1], nc, y0 // 2, P.CHROMA_WIN_R),
                (gold[2], nc, y0 // 2, P.CHROMA_WIN_R)]
        got = P.extract_windows(jobs, rows, cols)
        assert len(got) == len(jobs)
        for (plane, m, yb, r), out in zip(jobs, got):
            assert out.is_contiguous()
            want = J._extract_search_windows(
                jnp.asarray(plane.numpy()), m, rows, cols, yb,
                np.arange(cols, dtype=np.int64) * m, r=r)
            _eq(out, want, f"n={m} y0={yb}")


def test_window_specs_refuse_a_region_past_the_plane():
    plane = torch.zeros((100, 100), dtype=torch.uint8)
    with pytest.raises(ValueError, match="leave"):
        P.window_specs([(plane, 32, 0, P.WIN_R)], 4, 4)


# ---------------------------------------------------------------------------
# 2. the kernels under the g++ stand-in
# ---------------------------------------------------------------------------


def _build(tmp, name):
    """``csrc/<name>.cu`` up to its launch helpers (its dynamic shared
    memory the stand-in's buffer), the stand-in's helpers, then the
    source's launchers, built with g++."""
    with open(os.path.join(CSRC, f"{name}.cu")) as fh:
        src = fh.read()
    cut = src.index(_FIRST_HELPER[name])
    tail = src[src.index("}  // namespace"):]
    body = src[:cut].replace(
        "extern __shared__ __align__(16) unsigned char smem[];",
        "unsigned char* smem = standin_smem;")
    cpp, lib = tmp / f"{name}_standin.cpp", tmp / f"lib{name}.so"
    cpp.write_text(body + _STANDIN_LAUNCH[name] + tail)
    subprocess.run(
        [shutil.which("g++"), "-std=c++20", "-O1", "-fwrapv",
         "-ffp-contract=off", "-shared", "-fPIC", "-I", STANDIN, "-I", CSRC,
         "-o", str(lib), str(cpp), "-lpthread"], check=True,
        capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """{wrapper name: the stand-in build's launcher, with ``_LAUNCHERS``'
    argument types}."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the stand-in of the CUDA sources")
    tmp = tmp_path_factory.mktemp("standin")
    libs = {name: _build(tmp, name)
            for name in ("windows", "mode_decide", "mc_predict")}
    fns = {}
    for name in NAMES + DECIDED:
        lib, sym, n_ptr, n_float, n_int = K._LAUNCHERS[name]
        fn = getattr(libs[lib], sym)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_float
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@pytest.fixture
def on_standin(standin, monkeypatch):
    """The four wrappers on CPU tensors launching the stand-in builds (the
    other wrappers keep their CPU path)."""
    real_kind = K._device_kind

    def kind(name, *tensors):
        return "cuda" if name in NAMES + DECIDED else real_kind(name,
                                                                 *tensors)

    def launch(name, dev, *args, words=None):
        err = standin[name](*args, None)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")

    monkeypatch.setattr(K, "_device_kind", kind)
    monkeypatch.setattr(K, "_launch", launch)
    return K


@pytest.mark.parametrize("case", ["mc-site", "search", "strip", "small",
                                  "unaligned"])
def test_extract_windows_on_standin_matches_plain(on_standin, case):
    """One launch of several sets: seven sets of mixed sides (LAST's
    chroma, GOLDEN's three planes, ALTREF's chroma; 66 x 66 windows, a
    byte a lane, beside 120 x 120 ones, 8 bytes a lane), LAST's luma
    search windows (the aligned path: x0, the pitch and sw as at every
    search site), the strip's sets, small odd windows on an odd-width
    plane (sw 13 and 21), and 8-byte rows that start inside a word (x0 1
    and 3, an odd pitch, a plane one byte into its storage), every window
    from the plane's edge on."""
    rng = np.random.default_rng(len(case))
    if case == "unaligned":
        rows, cols = 3, 4
        plane = _t(rng.integers(0, 256, (3 * 8 + 24 + 5, 4 * 8 + 24 + 9),
                                dtype=np.uint8))
        buf = torch.zeros(plane.numel() + 1, dtype=torch.uint8)
        buf[1:] = plane.reshape(-1)
        moved = buf[1:].view(plane.shape)
        assert moved.data_ptr() % 4 == 1 and plane.shape[1] % 2 == 1
        specs = [(plane, 8, 24, 0, 1), (plane, 8, 16, 2, 3),
                 (moved, 8, 24, 5, 0), (moved, 4, 32, 1, 2),
                 (plane, 8, 24, 5, 9)]
        got = on_standin.extract_windows(specs, rows, cols)
        for (p, n, sw, y0, x0), out in zip(specs, got, strict=True):
            want = p[y0:y0 + (rows - 1) * n + sw,
                     x0:x0 + (cols - 1) * n + sw].unfold(0, sw, n) \
                .unfold(1, sw, n).reshape(rows * cols, sw, sw)
            assert torch.equal(out, want), (n, sw, y0, x0)
        return
    if case == "small":
        rows, cols = 3, 5
        plane = _t(rng.integers(0, 256, (3 * 4 + 13 + 3, 5 * 4 + 13 + 1),
                                dtype=np.uint8))
        other = _t(rng.integers(0, 256, (33, 47), dtype=np.uint8))
        specs = [(plane, 4, 13, 0, 0), (plane, 4, 13, 3, 1),
                 (other, 3, 21, 0, 0), (other, 2, 13, 12, 26)]
        got = on_standin.extract_windows(specs, rows, cols)
        for (p, n, sw, y0, x0), out in zip(specs, got):
            want = p[y0:y0 + (rows - 1) * n + sw,
                     x0:x0 + (cols - 1) * n + sw].unfold(0, sw, n) \
                .unfold(1, sw, n).reshape(rows * cols, sw, sw)
            assert torch.equal(out, want), (n, sw, y0, x0)
        return
    g = P.make_geom(*((128, 112) if case == "strip" else (96, 64)))
    refs = [[P.extend_borders_device(_t(p), *c)
             for p, c in zip(_planes(g, seed), P.recon_crops(g))]
            for seed in (1, 2, 3)]
    last, gold, alt = refs
    if case == "strip":
        y0, rows, cols, n = g.strip_y, 1, g.cols16, 16
    else:
        y0, rows, cols, n = 0, g.rows32, g.cols32, 32
    chroma = [(p, n // 2, y0 // 2, P.CHROMA_WIN_R)
              for p in (last[1], last[2], gold[1], gold[2], alt[1], alt[2])]
    jobs = {"mc-site": [*chroma[:2], (gold[0], n, y0, P.WIN_R), *chroma[2:]],
            "search": [(last[0], n, y0, P.WIN_R)],
            "strip": [(last[0], n, y0, P.WIN_R), *chroma[:2],
                      (gold[0], n, y0, P.WIN_R), *chroma[2:4]]}[case]
    before = K.extract_windows.launches
    got = on_standin.extract_windows(P.window_specs(jobs, rows, cols), rows,
                                     cols)
    assert K.extract_windows.launches == before + 1
    want = [P._extract_search_windows(p, m, rows, cols, yb, r)
            for p, m, yb, r in jobs]
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a.is_contiguous() and a.data_ptr() % 16 == 0
        assert torch.equal(a, b), f"set {i}"
    if case == "search":
        # the aligned path's premises, as at every luma search site
        (plane, n, sw, y0, x0), = P.window_specs(jobs, rows, cols)
        assert (x0 % 4, plane.shape[1] % 4, n % 4, sw % 8) == (0, 0, 0, 0)


def _shapes(h, w):
    """A recon's three plane shapes at luma (h, w)."""
    return ((h, w), (h // 2, w // 2), (h // 2, w // 2))


# (plane shapes, crops, border) of each case; None: the geometry's recon
BORDER_CASES = {
    "recon": None,
    "odd": (((21, 37), (11, 19), (9, 7)), ((35, 21), (18, 9), (1, 1)), 9),
    "1080p": (_shapes(1088, 1920), ((1920, 1080), (960, 540), (960, 540)),
              96),
    "720p-rows": (_shapes(8, 1280), ((1280, 8), (640, 4), (640, 4)), 96),
    "4k-rows": (_shapes(6, 3840), ((3840, 5), (1920, 3), (1920, 2)), 96),
    "crop-w-odd": (_shapes(8, 1920), ((1917, 7), (959, 3), (1, 1)), 96),
    "border-0": (((16, 64), (8, 32), (7, 48)), ((50, 13), (32, 8), (1, 1)),
                 0),
    "border-8": (((6, 32), (3, 16), (3, 16)), ((32, 6), (16, 3), (13, 2)),
                 8),
    "mixed": (((6, 64), (5, 37), (4, 32)), ((64, 6), (30, 5), (17, 4)), 16)}


@pytest.mark.parametrize("case", BORDER_CASES)
def test_extend_borders_on_standin_matches_plain(on_standin, case):
    """A recon's three planes in one launch: the stand-in geometry's, the
    1080p recon (1080 of its 1088 rows visible) and rows of the real 720p
    and 4K row lengths, whose rows are whole 16-byte words (interior words
    loaded, border words broadcast), a crop width no multiple of 16 (its
    edge word byte by byte) and a 1 x 1 crop among them, border 0 (no
    border word); planes of odd widths and crops whose rows span words
    (each word byte by byte, the last one's tail too); and the two paths
    in one launch, a plane one byte into its storage on the byte path; rows
    of whole words at a border of 8 (no word of a row wholly border) on the
    byte path."""
    rng = np.random.default_rng(len(case))
    if BORDER_CASES[case] is None:
        g = P.make_geom(96, 80)
        planes = [_t(p) for p in _planes(g, 5)]
        crops, border = P.recon_crops(g), P.BORDER
    else:
        shapes, crops, border = BORDER_CASES[case]
        planes = [_t(rng.integers(0, 256, shp, dtype=np.uint8))
                  for shp in shapes]
    if case == "mixed":
        buf = torch.zeros(planes[2].numel() + 1, dtype=torch.uint8)
        buf[1:] = planes[2].reshape(-1)
        planes[2] = buf[1:].view(planes[2].shape)
        assert planes[2].data_ptr() % 16 != 0
    before = K.extend_borders.launches
    got = on_standin.extend_borders(planes, crops, border)
    assert K.extend_borders.launches == before + 1
    for p, c, out in zip(planes, crops, got, strict=True):
        want = P.extend_borders_device(p, *c, border)
        assert torch.equal(out, want), (tuple(p.shape), c)
        assert out.data_ptr() % 16 == 0
    # the aligned rows' premises at the real sizes and the stand-in's
    # geometry: every output row and the border whole 16-byte words
    if case not in ("odd", "border-8", "mixed"):
        assert border % 16 == 0
        assert all(p.shape[1] % 16 == 0 for p in planes)


def test_wrappers_refuse(on_standin):
    """The wrappers' refusals; extract_windows' launcher refuses a set whose
    windows leave their plane (right, bottom, before its start), after
    the sets it took."""
    plane = torch.zeros((64, 64), dtype=torch.uint8)
    for spec in ((8, 20, 0, 50), (8, 20, 40, 0), (8, 20, -1, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            on_standin.extract_windows([(plane, 8, 20, 0, 0),
                                        (plane, *spec)], 2, 2)
    with pytest.raises(ValueError, match="1 to 8"):
        on_standin.extract_windows([(plane, 8, 20, 0, 0)] * 9, 1, 1)
    with pytest.raises(TypeError, match="uint8"):
        on_standin.extract_windows([(plane.int(), 8, 20, 0, 0)], 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        on_standin.extract_windows([(plane[:, :40], 8, 20, 0, 0)], 1, 1)
    with pytest.raises(ValueError, match="crop"):
        on_standin.extend_borders([plane], [(65, 10)], 4)
    with pytest.raises(ValueError, match="crop"):
        on_standin.extend_borders([plane], [(0, 10)], 4)
    with pytest.raises(ValueError, match="contiguous"):
        on_standin.extend_borders([plane[:, :40]], [(40, 64)], 4)


def test_wrappers_take_cuda_tensors_only():
    plane = torch.zeros((64, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.extract_windows([(plane, 8, 20, 0, 0)], 1, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.extend_borders([plane], [(64, 64)], 4)


# ---------------------------------------------------------------------------
# 3. the step with the three kernels on the stand-in
# ---------------------------------------------------------------------------


def _step_args(w, h, seed, n_refs):
    """A P-frame step's planes (CPU tensors) on a panning clip: the
    source, then ``n_refs`` border-extended references (LAST, GOLDEN,
    ALTREF), a 16 x 16 patch moving its own way."""
    g = P.make_geom(w, h)
    frames = list(panning_frames(w, h, 4, seed=seed))
    cur = [np.asarray(p).copy() for p in (frames[3].y, frames[3].u,
                                          frames[3].v)]
    before = [np.asarray(p) for p in (frames[2].y, frames[2].u, frames[2].v)]
    cur[0][16:32, 32:48] = before[0][21:37, 26:42]
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    src = [_t(P.pad_plane(p, *s)) for p, s in zip(cur, shapes)]
    refs = []
    for f in (2, 0, 1)[:n_refs]:
        planes = [np.asarray(p) for p in (frames[f].y, frames[f].u,
                                          frames[f].v)]
        refs += list(port_realtime.upload_refs(planes, g, "cpu"))
    return g, src, refs


def _flat(outs):
    for key, v in sorted(outs.items()):
        if isinstance(v, dict):
            for k2, t in sorted(v.items()):
                yield f"{key} {k2}", t
        else:
            yield key, v


# (geometry, GOLDEN, ALTREF, split16, descend_frac, aq)
STEPS = {"m8-golden-descent": ((96, 64), True, False, True, 4, False),
         "ra-golden-altref": ((96, 64), True, True, True, 1, False),
         "strip-aq-golden": ((96, 80), True, False, False, 4, True)}


@pytest.mark.parametrize("case", STEPS)
def test_step_with_the_standin_kernels_matches_plain(on_standin, monkeypatch,
                                                     case):
    """The step once on the plain versions and once with its dispatches
    ``mode_decide_mc``, ``descent_decide_mc``, ``extract_windows`` and
    ``extend_borders`` taking the stand-in kernels: every output and the
    new references equal; per zone one window launch (two with ALTREF)
    and one MC launch that makes the zone's decision first (MC reads the
    planes in place), one more for the children's decision and MC, one
    border launch, and no launch of the standalone decision."""
    dims, golden, altref, split16, frac, aq = STEPS[case]
    g, src, refs = _step_args(*dims, seed=len(case),
                              n_refs=1 + golden + altref)
    qidx = 120
    ac_q = T.ac_quant(qidx)
    rates = P.upload_rate_tabs(
        P.make_rate_tabs(T.default_frame_context(), qidx), "cpu")
    prev32 = torch.zeros((g.n_blocks32, 2), dtype=torch.int32)
    prev16 = torch.zeros((max(1, g.cols16 if g.strip else 1), 2),
                         dtype=torch.int32)
    args = [*src, *refs, prev32, prev16,
            P.step_scalars(T.dc_quant(qidx), ac_q, max(1, (ac_q ** 2) >> 6),
                           20, 3, 40), rates]
    step = P.make_pframe_step(g, "cpu", split16=split16, golden=golden,
                              with_rates=True, altref=altref,
                              descend_frac=frac, aq=aq)
    want_outs, want_refs = step(*args)
    before = {name: getattr(K, name).launches for name in NAMES}

    def kernel_grid(planes, grid):
        return P.mc_window_grid(tuple(tuple(t.shape) for t in planes[0]),
                                tuple(grid))

    # the dispatches' plain versions taking the wrappers, with the
    # constants and the window grid the dispatches hand them, and the
    # step's row in place of the lam the plain versions take
    sc = args[len(src) + len(refs) + 2]

    monkeypatch.setattr(
        P, "mode_decide_mc_ref",
        lambda *a: K.mode_decide_mc(*a[:12], sc, *a[13:18],
                                    P.CAND_RATE_PROXY, *a[18:24],
                                    kernel_grid(a[18], a[25])))
    monkeypatch.setattr(
        P, "descent_decide_mc_ref",
        lambda *a: K.descent_decide_mc(
            *a[:10], sc, *a[11:13],
            (P.CAND_RATE_PROXY[0], P.CAND_RATE_PROXY[4]),
            *a[13:19], kernel_grid(a[13], a[20]), *a[21:]))
    monkeypatch.setattr(
        P, "extract_windows",
        lambda jobs, rows, cols: K.extract_windows(
            P.window_specs(jobs, rows, cols), rows, cols))
    monkeypatch.setattr(
        P, "extend_borders",
        lambda planes, crops, border=P.BORDER: K.extend_borders(
            planes, crops, border))
    got_outs, got_refs = step(*args)
    zones = 1 + g.strip
    assert {name: getattr(K, name).launches - before[name]
            for name in NAMES} == {"mode_decide": 0,
                                   "extract_windows": zones * (1 + altref),
                                   "extend_borders": 1,
                                   "mc_predict": zones + split16}
    got, want = dict(_flat(got_outs)), dict(_flat(want_outs))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    for a, b in zip(got_refs, want_refs, strict=True):
        assert torch.equal(a, b)
    if golden:
        refs_taken = set(got_outs["m32"]["ref"].tolist())
        assert 0 in refs_taken
