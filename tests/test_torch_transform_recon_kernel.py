"""The device code of ``tpu_vp9_torch/csrc/transform_recon.cu`` run on the
CPU: g++ builds the kernel behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread, the
float64 mma in its PTX fragment layout), and each launch is held against
the plain version ``pipeline/tpu_encdec.py:transform_recon_ref``, bit for
bit. The stand-in mma sums its four products in order, so the second
forward product sums in another order than torch's matmul, as on the
card; a level could then differ only within about 1e-12 of a rounding
boundary, which these seeded inputs do not reach.

What this cannot show: that nvcc accepts the source, the card's own mma,
timing, and bank conflicts. ``chip_smoke.py`` checks the kernel on the card.
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

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
THREADS = 128  # the kernel's CTA

# the launcher of the stand-in build: every instance of the kernel over a
# given grid of CTAs
_DRIVER = """
}  // namespace
extern "C" int standin_run(const uint8_t* src, const uint8_t* pred,
                           const double* f_col, const int* iscan,
                           int16_t* levels, int* eob,
                           uint8_t* recon, int nblk, int n, int dc_q,
                           int ac_q, int vec, int grid) {
  switch (n) {
%s
    default:
      return 1;
  }
  return 0;
}
"""
_CASE = """    case %(n)d:
      standin_launch(grid, %(threads)d, [&] {
        transform_recon_kernel<%(n)d>(src, pred, f_col, iscan, levels, eob,
                                      recon, nblk, dc_q, ac_q, vec);
      });
      break;"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The kernel's device code built with g++ behind the stand-ins: the
    source up to its host launch code, its dynamic shared memory the
    stand-ins' buffer."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the stand-in of the CUDA source"
    with open(os.path.join(CSRC, "transform_recon.cu")) as fh:
        src = fh.read()
    cut = src.index("template <int N>\ncudaError_t prepare(")
    shared = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(shared) == 1
    body = src[:cut].replace(shared, "unsigned char* smem = standin_smem;")
    assert "namespace {" in body
    cases = "\n".join(_CASE % {"n": n, "threads": THREADS}
                      for n in K.TXFM_BLOCK_SIZES)
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "transform_recon_standin.cpp", out / "libtr.so"
    cpp.write_text(body + _DRIVER % cases)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-ffp-contract=off", "-shared",
         "-fPIC", "-I", STANDIN, "-I", CSRC, "-o", str(lib), str(cpp),
         "-lpthread"], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).standin_run
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


def _run(fn, src, pred, dc_q, ac_q, n, grid, vec=True):
    """One launch of the stand-in on CPU tensors; outputs start as junk so
    that a place the kernel does not write shows."""
    b = src.shape[0]
    f_col, iscan = K._txfm_tables_on(n, torch.device("cpu"))
    levels = torch.full((b, n, n), 12345, dtype=torch.int16)
    eob = torch.full((b,), -7, dtype=torch.int32)
    recon = torch.full((b, n, n), 77, dtype=torch.uint8)
    assert fn(src.data_ptr(), pred.data_ptr(), f_col.data_ptr(),
              iscan.data_ptr(), levels.data_ptr(), eob.data_ptr(),
              recon.data_ptr(), b, n, dc_q, ac_q, int(vec), grid) == 0
    return levels, eob, recon


def _assert_same(got, want):
    for name, g, w in zip(("levels", "eob", "recon"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def _blocks(n, b, seed):
    """(src, pred) uint8 (b, n, n): prediction errors of a smooth source,
    four blocks of +-255 residuals and two of zero residual, last."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    k = b - 6
    phase = rng.uniform(0, 6, (k, 1, 1))
    src = np.clip(128 + 90 * np.sin(0.2 * yy + 0.3 * xx + phase)
                  + rng.normal(0, 8, (k, n, n)), 0, 255).astype(np.uint8)
    pred = np.clip(src.astype(int) + rng.integers(-60, 61, src.shape), 0,
                   255).astype(np.uint8)
    ext = rng.choice([0, 255], (4, n, n)).astype(np.uint8)
    ext[0], ext[1] = 255, 0
    same = rng.integers(0, 256, (2, n, n), dtype=np.uint8)
    return (torch.from_numpy(np.concatenate([src, ext, same])),
            torch.from_numpy(np.concatenate([pred, 255 - ext, same])))


@pytest.mark.parametrize("qindex", [0, 100, 255])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_standin_matches_plain_version(standin, n, qindex):
    """A batch of two groups and a partial third (128 / n blocks a group)
    on two CTAs, so that one CTA takes two groups in turn; at qindex 0 the
    levels reach the 8191 clip at n = 32."""
    per = THREADS // n
    src, pred = _blocks(n, 2 * per + 3, seed=n + qindex)
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
    got = _run(standin, src, pred, dc_q, ac_q, n, grid=2)
    _assert_same(got, P.transform_recon_ref(src, pred, dc_q, ac_q, n))
    if n == 32 and qindex == 0:
        assert int(got[0].abs().max()) == 8191


@pytest.mark.parametrize("n", [8, 16, 32])
def test_standin_reads_unaligned_blocks(standin, n):
    """src and pred views that start 1 and 3 bytes into their storage: the
    kernel's byte-wise loads (its launcher checks the alignment)."""
    src, pred = _blocks(n, max(THREADS // n + 1, 9), seed=40 + n)
    s_buf = torch.zeros(src.numel() + 1, dtype=torch.uint8)
    p_buf = torch.zeros(src.numel() + 3, dtype=torch.uint8)
    s_buf[1:] = src.reshape(-1)
    p_buf[3:] = pred.reshape(-1)
    got = _run(standin, s_buf[1:].view(src.shape), p_buf[3:].view(src.shape),
               40, 48, n, grid=1, vec=False)
    _assert_same(got, P.transform_recon_ref(src, pred, 40, 48, n))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_standin_eob_at_every_scan_place(standin, n):
    """Blocks with one nonzero level at a scan place each (every place at
    n = 8 and 16, every fourth at 32): the recon of those levels comes back
    with its levels and its eob."""
    nn = n * n
    step = 4 if n == 32 else 1
    places = np.arange(0, nn, step)
    dc_q, ac_q = T.dc_quant(60), T.ac_quant(60)
    scan = torch.as_tensor(np.asarray(T.scan_order(
        P.txfm.TX_SIZE[n], T.TxType.DCT_DCT)[0]))
    levels = torch.zeros((len(places), nn), dtype=torch.int32)
    levels[torch.arange(len(places)), scan[places]] = 20
    levels[0, scan[0]] = 4
    pred = torch.full((len(places), n, n), 128, dtype=torch.uint8)
    src = P.recon_from_levels(levels.reshape(-1, n, n), pred, dc_q, ac_q,
                              n)[1]
    got = _run(standin, src, pred, dc_q, ac_q, n, grid=3)
    _assert_same(got, P.transform_recon_ref(src, pred, dc_q, ac_q, n))
    assert len(set(got[1].tolist())) > len(places) // 2
