"""The device code of ``tpu_vp9_torch/csrc/kframe_wave.cu`` run on the CPU:
g++ builds the kernel behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread, the
float64 mma in its PTX fragment layout), with every CTA of the grid
running at once (``standin_launch_all``), so that each block row really
waits for the row above through the ticket and the tagged edge words.
Each launch is held against the plain version
``pipeline/tpu_encdec.py:kframe_wave_ref``, bit for bit: modes, levels,
eobs and the unfiltered recon. The stand-in mma sums its products in
order, so the second forward product sums in another order than torch's
matmul, as on the card; a level could then differ only within about 1e-12
of a rounding boundary, which these seeded inputs do not reach.

Every launch runs under a watchdog: one that has not finished in
``LAUNCH_TIMEOUT_S`` fails its test instead of hanging the run.

What this cannot show: that nvcc accepts the source, the card's own mma
and memory ordering, timing. ``chip_smoke.py`` checks the kernel on the
card.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.utils.yuv import panning_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
THREADS = 256  # the kernel's CTA
LAUNCH_TIMEOUT_S = 120
# polls of a wait in the stand-in: never reached by a launch that works
# (the watchdog bounds those), except where a test asks for a timeout
NO_TIMEOUT = 1 << 30

# the launcher of the stand-in build: every CTA of the grid at once, on a
# thread of its own that the caller waits for at most timeout_ms; 2 if it
# did not finish (its threads are then left behind)
_DRIVER = """
}  // namespace
#include <array>
#include <chrono>
#include <future>
extern "C" int standin_run(
    const void* src_y, const void* src_u, const void* src_v, void* rec_y,
    void* rec_u, void* rec_v, void* mode, void* lv_y, void* lv_u,
    void* lv_v, void* eob, const void* mats, const void* tabs, void* edge,
    void* sync, int src_pitch, int height, int rows, int cols, int dc_q,
    int ac_q, int lam, int max_polls, int grid, int timeout_ms) {
  // the step's row, kept alive for threads a timed-out launch leaves
  auto sc = std::make_shared<std::array<int, step_row::kWords>>();
  (*sc)[step_row::kDcQ] = dc_q;
  (*sc)[step_row::kAcQ] = ac_q;
  (*sc)[step_row::kLam] = lam;
  const Params P = make_params(src_y, src_u, src_v, rec_y, rec_u, rec_v,
                               mode, lv_y, lv_u, lv_v, eob, mats, tabs, edge,
                               sync, sc->data(), src_pitch, height, rows,
                               cols, max_polls);
  auto done = std::make_shared<std::promise<void>>();
  std::future<void> finished = done->get_future();
  std::thread runner([P, grid, done, sc] {
    standin_launch_all(grid, %(threads)d, [P] { kframe_wave_kernel(P); });
    done->set_value();
  });
  if (finished.wait_for(std::chrono::milliseconds(timeout_ms)) !=
      std::future_status::ready) {
    runner.detach();
    return 2;
  }
  runner.join();
  return 0;
}
"""
# the inputs of a launch that did not finish, kept alive for the threads
# it left behind
_STRANDED = []


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The kernel's device code built with g++ behind the stand-ins: the
    source up to its host launch code, its dynamic shared memory the
    stand-ins' buffer of the running CTA."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the stand-in of the CUDA source"
    with open(os.path.join(CSRC, "kframe_wave.cu")) as fh:
        src = fh.read()
    cut = src.index("cudaError_t prepare(")
    shared = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(shared) == 1
    body = src[:cut].replace(shared, "unsigned char* smem = standin_smem;")
    assert "namespace {" in body
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "kframe_wave_standin.cpp", out / "libkf.so"
    cpp.write_text(body + _DRIVER % {"threads": THREADS})
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-ffp-contract=off", "-shared",
         "-fPIC", "-I", STANDIN, "-I", CSRC, "-o", str(lib), str(cpp),
         "-lpthread"], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).standin_run
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
    fn.restype = ctypes.c_int
    return fn


def _run(fn, planes, g, dc_q, ac_q, lam, max_polls=NO_TIMEOUT, ticket=0):
    """One launch of the stand-in on CPU tensors, a CTA per block row
    (less ``ticket`` CTAs, whose rows are taken as started); outputs start
    as junk so that a place the kernel does not write shows. Returns the
    outputs in the wrapper's order, the sync words (ticket, error word)
    and the edge words."""
    rows, cols = g.rows32, g.cols32
    b = rows * cols
    mode = torch.full((b,), -5, dtype=torch.int32)
    lvs = [torch.full((b, n, n), 12345, dtype=torch.int16)
           for n in (32, 16, 16)]
    eob = torch.full((3, b), -7, dtype=torch.int32)
    recs = [torch.full((rows * n, cols * n), 77, dtype=torch.uint8)
            for n in (32, 16, 16)]
    mats, tabs = K._kf_tables_on(torch.device("cpu"))
    edge = torch.zeros((b, K.KF_EDGE_WORDS), dtype=torch.int64)
    sync = torch.tensor([ticket, 0], dtype=torch.int32)
    keep = (*planes, mode, *lvs, eob, *recs, edge, sync)
    rc = fn(*(t.data_ptr() for t in (*planes, *recs, mode, *lvs, eob, mats,
                                      tabs, edge, sync)),
            g.pad_w, g.height, rows, cols, dc_q, ac_q, lam, max_polls,
            rows - ticket, 1000 * LAUNCH_TIMEOUT_S)
    if rc != 0:
        _STRANDED.append(keep)
    assert rc == 0, f"the stand-in launch did not finish in " \
                    f"{LAUNCH_TIMEOUT_S} s"
    return (mode, *lvs, *eob.unbind(0), *recs), sync, edge


def _assert_same(got, want):
    names = ("mode", "lv_y", "lv_u", "lv_v", "eob_y", "eob_u", "eob_v",
             "rec_y", "rec_u", "rec_v")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def _check(fn, planes, g, qidx, lam=None):
    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    lam = max(1, (ac_q ** 2) >> 6) if lam is None else lam
    ts = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
    got, sync, edge = _run(fn, ts, g, dc_q, ac_q, lam)
    assert sync.tolist() == [g.rows32, 0]
    # every block's bottom rows published, tagged, as the recon has them
    assert bool(((edge >> 32) == 1).all())
    bottom = torch.cat([got[7][31::32].reshape(g.rows32, g.cols32, 32),
                        got[8][15::16].reshape(g.rows32, g.cols32, 16),
                        got[9][15::16].reshape(g.rows32, g.cols32, 16)],
                       dim=2).reshape(-1, 16, 4).to(torch.int64)
    data = bottom[..., 0] | bottom[..., 1] << 8 | bottom[..., 2] << 16 \
        | bottom[..., 3] << 24
    assert torch.equal(edge & 0xFFFFFFFF, data)
    _assert_same(got, P.kframe_wave_ref(*ts, g, dc_q, ac_q, lam))
    return got


def _chroma(y):
    """Padded (y, u, v) planes from a padded luma plane."""
    return [y, np.ascontiguousarray(y[::2, ::2]),
            np.ascontiguousarray(255 - y[1::2, 1::2])]


def _panning(g, seed):
    """Padded (y, u, v) planes of a panning texture with a noise block."""
    fr = next(panning_frames(g.width, g.height, 1, seed=seed))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    y, u, v = (P.pad_plane(np.asarray(p), *s)
               for p, s in zip((fr.y, fr.u, fr.v), shapes))
    y[:32, :32] = np.random.default_rng(seed).integers(0, 256, (32, 32))
    return [y, u, v]


@pytest.mark.parametrize("dims", [(32, 32), (128, 32), (32, 128)],
                         ids=["one_block", "one_row", "one_column"])
def test_standin_small_grids(standin, dims):
    """A 1x1 grid, a grid of one block row (no row waits) and one of one
    block column (every row waits for the whole row above)."""
    g = P.make_geom(*dims)
    _check(standin, _panning(g, seed=dims[0] + dims[1]), g, 100)


@pytest.mark.parametrize("qidx", [0, 100, 255])
def test_standin_overhang_geometry(standin, qidx):
    """mi_rows % 4 == 3: the last block row three quarters visible (as at
    1080p), its left columns clamped to the last visible row. At qindex 0
    on 0/255 blocks the levels reach the 8191 clip."""
    g = P.make_geom(96, 88)
    assert g.mi_rows % 4 == 3 and g.rows32 * 32 > g.height
    if qidx == 0:
        yy, xx = np.mgrid[0:g.pad_h, 0:g.pad_w]
        planes = _chroma(np.where((yy // 32 + xx // 32) % 2, 255,
                                  0).astype(np.uint8))
    else:
        planes = _panning(g, seed=qidx)
    got = _check(standin, planes, g, qidx)
    if qidx == 0:
        assert int(got[1].abs().max()) == 8191


def test_standin_unaligned_source(standin):
    """Source planes that start one byte into their storage: the kernel's
    byte-wise source loads."""
    g = P.make_geom(128, 64)
    planes = []
    for p in _panning(g, seed=5):
        buf = torch.zeros(p.size + 1, dtype=torch.uint8)
        buf[1:] = torch.from_numpy(p.reshape(-1))
        planes.append(buf[1:].view(p.shape))
    dc_q, ac_q = T.dc_quant(60), T.ac_quant(60)
    got, _, _ = _run(standin, planes, g, dc_q, ac_q, 150)
    _assert_same(got, P.kframe_wave_ref(*planes, g, dc_q, ac_q, 150))


def test_standin_constant_frame_ties_go_to_dc(standin):
    """A constant 128 at lam 0: every prediction with a neighbour is exact,
    so all modes tie at cost 0 and DC, the first, wins every block."""
    g = P.make_geom(96, 64)
    got = _check(standin, _chroma(np.full((g.pad_h, g.pad_w), 128,
                                          np.uint8)), g, 100, lam=0)
    assert got[0].tolist() == [0] * g.n_blocks32


def _every_mode_planes(g, seed):
    """Padded planes on which every mode wins a block at lam 0: noise,
    except the blocks (r, c) with r, c >= 1 and r + c odd, whose left and
    above neighbours are noise. The k-th of those, in raster order, is mode
    (k % 10)'s own prediction (luma and chroma) from the recon of the
    blocks before it, so that mode predicts it exactly (zero residual) and,
    on the noise's varied references, no other does."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(p) for p in _chroma(
        rng.integers(0, 256, (g.pad_h, g.pad_w), np.uint8))]
    dc_q, ac_q = T.dc_quant(60), T.ac_quant(60)
    vis = (g.height, (g.height + 1) >> 1, (g.height + 1) >> 1)
    k = 0
    for r in range(1, g.rows32):
        for c in range(1 + r % 2, g.cols32, 2):
            # the recon of every block before (r, c) is final
            recs = P.kframe_wave_ref(*ts, g, dc_q, ac_q, 0)[7:]
            for p, n in enumerate((32, 16, 16)):
                ref, ha, hl = P._kf_refs(recs[p], torch.tensor([r]),
                                         torch.tensor([c]), n, vis[p])
                pred = P.predict_intra_all(ref, ha, hl, n)[0, k % 10]
                ts[p][r * n:(r + 1) * n, c * n:(c + 1) * n] = pred
            k += 1
    return [t.numpy() for t in ts]


def test_standin_every_mode_wins(standin):
    """Mode patches on which each of the 10 modes wins some block."""
    g = P.make_geom(192, 160)
    got = _check(standin, _every_mode_planes(g, seed=3), g, 60, lam=0)
    won = torch.bincount(got[0].long(), minlength=10).tolist()
    assert all(won), won


@pytest.mark.parametrize("height", [64, 128], ids=["two_rows", "four_rows"])
def test_standin_wait_that_gives_up_sets_the_error_word(standin, height):
    """Block row 0 never runs (its ticket is taken as started): row 1's
    wait gives up after its polls and sets the error word to 2, the rows
    below give up too or stop when they see the word, none of them
    publishes, and the wrapper's check raises on the word. With two rows
    only row 1 runs, so the word is exactly 2."""
    g = P.make_geom(64, height)
    ts = [torch.from_numpy(np.ascontiguousarray(p))
          for p in _panning(g, seed=9)]
    _, sync, edge = _run(standin, ts, g, T.dc_quant(60), T.ac_quant(60),
                         150, max_polls=2000, ticket=1)
    assert sync[0] == g.rows32
    # rows 1 and below published nothing
    assert not bool(edge[g.cols32:].any())
    if g.rows32 == 2:
        assert int(sync[1]) == 2
        match = "block row 1 gave up"
    else:
        assert 2 <= int(sync[1]) <= g.rows32
        match = "gave up"
    with pytest.raises(RuntimeError, match=match):
        K.kf_check_status(sync[1:2])
