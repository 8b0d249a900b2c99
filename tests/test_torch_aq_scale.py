"""Tune SQ's per-block rate lambda: ``tpu_encdec.aq_scale_ref`` (the plain
version) and the device code of ``tpu_vp9_torch/csrc/aq_scale.cu``.

The plain version is held to the JAX package's ``_sb_lambda_scale``
within ``tests/test_torch_rt_aq.py``'s bound (2 float32 ulp a block at the
parity sizes; lam_bits 1 makes the product the scale), to the host chain
the step ran before the kernel (written out here: numpy's float32 steps,
its float64 log, exp and sum) bit for bit, and to the product with the
frame's lam_bits. The kernel's premise is checked: the float64 sum of the
logs is exact, so its order does not matter. Then the kernel's device
code, built with g++ behind ``tests/cuda_standin/cuda_runtime.h`` (one CTA
of 1024 host threads), is held to the plain version bit for bit at the
card's zone sizes, B = 80 (the 720p strip), 880 (720p), 2,040 (1080p) and
8,040 (4K), with all-equal, flat and saturated blocks, through the wrapper
``cuda_kernels.aq_scale`` (its launch replaced by the stand-in's).

What this cannot show: that nvcc accepts the source, and the card's float64
log and exp (``chip_smoke.py`` holds the kernel to the plain version on
the card).
"""

import ctypes
import math
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
LAM_BITS = K.RATE_SCALARS.index("lam_bits")
# the card's zones: (B, n)
ZONES = {"720p_strip": (80, 16), "720p": (880, 32), "1080p": (2040, 32),
         "4k": (8040, 32)}


def _scalars(lam_bits):
    """A rate tables' scalars row whose lam_bits word is ``lam_bits``."""
    row = np.zeros(len(K.RATE_SCALARS), np.int32)
    row[LAM_BITS] = np.float32(lam_bits).view(np.int32)
    return torch.from_numpy(row)


def _blocks(b, n, seed, kind="random"):
    """(b, n, n) uint8 source blocks: smooth, textured and noisy ones, and
    (kind "edges") flat, saturated and two-level blocks among them; "equal"
    gives every block the same pixels."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        one = rng.integers(0, 256, (n, n), dtype=np.uint8)
        return np.broadcast_to(one, (b, n, n)).copy()
    yy, xx = np.mgrid[0:n, 0:n]
    amp = rng.uniform(0, 120, (b, 1, 1))
    noise = rng.uniform(0, 40, (b, 1, 1))
    base = rng.uniform(30, 220, (b, 1, 1))
    out = np.clip(base + amp * np.sin(0.3 * yy + rng.uniform(0, 6, (b, 1, 1))
                                      * xx / n)
                  + noise * rng.standard_normal((b, n, n)), 0, 255)
    out = out.astype(np.uint8)
    if kind == "edges":
        out[0::7] = 0
        out[1::7] = 255
        out[2::7] = 128
        out[3::7, : n // 2] = 0
        out[3::7, n // 2:] = 255
    return out


def _sums(blocks):
    """The exact int32 sums (src_sum, src2) of the blocks, as the step's
    block_energy against zero blocks gives them."""
    b = blocks.astype(np.int64)
    return (torch.from_numpy(b.sum(axis=(1, 2)).astype(np.int32)),
            torch.from_numpy((b * b).sum(axis=(1, 2)).astype(np.int32)))


def _host_chain(src_sum, src2, n, lam_bits):
    """The host chain the step ran before the kernel, as it was written:
    float32 variance, + 16, float64 log rounded, numpy's float64 sum of the
    logs, * 0.25, float64 exp rounded, the clip, the float32 product."""
    f32 = np.float32
    sums = np.stack([src_sum.numpy(), src2.numpy()])
    mean = sums[0].astype(f32) / f32(n * n)
    var = np.maximum(sums[1].astype(f32) / f32(n * n) - mean * mean, f32(0))
    logv = np.log((var + f32(16)).astype(np.float64)).astype(f32)
    mean_log = f32(np.sum(logv, dtype=np.float64)) / f32(logv.size)
    scale = np.exp(((logv - mean_log) * f32(0.25)).astype(np.float64))
    scale = np.clip(scale.astype(f32), f32(0.5), f32(2.0))
    return scale * f32(lam_bits)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("b,n,kind", [(12, 32, "random"), (20, 32, "edges"),
                                      (8, 16, "random"), (40, 16, "edges")])
def test_plain_version_matches_jax(b, n, kind):
    """At lam_bits 1 the plain version is the scale: within 2 float32 ulp
    of the JAX package's ``_sb_lambda_scale`` a block (the bound of
    ``tests/test_torch_rt_aq.py`` at the parity sizes); at a frame's
    lam_bits it is that scale times lam_bits in float32, exactly."""
    blocks = _blocks(b, n, seed=b + n, kind=kind)
    src_sum, src2 = _sums(blocks)
    got = P.aq_scale_ref(src_sum, src2, n, _scalars(1.0))
    jb = jnp.asarray(blocks)
    want = np.asarray(J._sb_lambda_scale(jb, J._block_sq_sum(jb)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    assert int(_ulps(got.numpy(), want).max()) <= 2
    lam = np.float32(0.85 * (300 / 8.0) ** 2)
    scaled = P.aq_scale_ref(src_sum, src2, n, _scalars(lam))
    np.testing.assert_array_equal(scaled.numpy(), got.numpy() * lam)


@pytest.mark.parametrize("zone", ZONES)
@pytest.mark.parametrize("kind", ["random", "edges", "equal"])
def test_plain_version_is_the_host_chain(zone, kind):
    """Bit for bit the host chain the step ran before, at the card's zone
    sizes, every kind of content."""
    b, n = ZONES[zone]
    src_sum, src2 = _sums(_blocks(b, n, seed=b, kind=kind))
    lam = np.float32(0.85 * (128 / 8.0) ** 2)
    got = P.aq_scale_ref(src_sum, src2, n, _scalars(lam))
    np.testing.assert_array_equal(got.numpy(),
                                  _host_chain(src_sum, src2, n, lam))


@pytest.mark.parametrize("zone", ZONES)
def test_the_sum_of_the_logs_is_exact(zone):
    """The kernel's premise: every log is a float32 of at least log(16),
    so their float64 sum is exact in any order (numpy's pairwise sum, a
    reversed running sum and an exact sum agree), at the zone sizes and
    at the logs' extremes."""
    b, n = ZONES[zone]
    src_sum, src2 = _sums(_blocks(b, n, seed=b + 1, kind="edges"))
    f32 = np.float32
    mean = src_sum.numpy().astype(f32) / f32(n * n)
    var = np.maximum(src2.numpy().astype(f32) / f32(n * n) - mean * mean,
                     f32(0))
    for logv in (np.log((var + f32(16)).astype(np.float64)).astype(f32),
                 np.full(b, np.float32(np.log(16.0 + 127.5 ** 2)))):
        assert logv.min() > 2
        exact = math.fsum(float(v) for v in logv)
        running = 0.0
        for v in logv[::-1]:
            running += float(v)
        assert np.sum(logv, dtype=np.float64) == exact == running


# ---------------------------------------------------------------------------
# the kernel's device code under the stand-ins
# ---------------------------------------------------------------------------

_DRIVER = """
extern "C" int standin_run(const void* src_sum, const void* src2,
                           const void* lam_bits, void* out, int b, int n) {
  if (b < 1 || n < 1) return 1;
  standin_launch(1, kThreads, [&] {
    aq_scale_kernel(static_cast<const int*>(src_sum),
                    static_cast<const int*>(src2),
                    static_cast<const int*>(lam_bits),
                    static_cast<float*>(out), b, n);
  });
  return 0;
}
"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The kernel's device code built with g++ behind the stand-ins: the
    source up to its launcher, its shared words the stand-in's buffer,
    launched as one CTA of 1024 threads by the appended standin_run."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the stand-in of the CUDA source")
    with open(os.path.join(CSRC, "aq_scale.cu")) as fh:
        src = fh.read()
    cut = src.index("}  // namespace") + len("}  // namespace")
    shared = "extern __shared__ __align__(16) double part[];"
    assert src.count(shared) == 1
    body = src[:cut].replace(
        shared, "double* part = reinterpret_cast<double*>(standin_smem);")
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "aq_scale_standin.cpp", out / "libaq_scale.so"
    cpp.write_text(body + _DRIVER)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-ffp-contract=off", "-shared",
         "-fPIC", "-I", STANDIN, "-I", CSRC, "-o", str(lib), str(cpp),
         "-lpthread"], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).standin_run
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture
def on_standin(standin, monkeypatch):
    """``aq_scale``'s wrapper on CPU tensors launching the stand-in
    build."""
    real_kind = K._device_kind

    def kind(name, *tensors):
        return "cuda" if name == "aq_scale" else real_kind(name, *tensors)

    def launch(name, dev, *args, words=None):
        assert name == "aq_scale"
        assert standin(*args) == 0

    monkeypatch.setattr(K, "_device_kind", kind)
    monkeypatch.setattr(K, "_launch", launch)
    return K


@pytest.mark.parametrize("zone", ZONES)
@pytest.mark.parametrize("kind", ["random", "edges", "equal"])
def test_standin_matches_plain(on_standin, zone, kind):
    """One launch a zone, through the wrapper: bit for bit the plain
    version at B = 80, 880, 2,040 and 8,040, on content of every kind
    (all blocks equal: every scale 1 but for the mean's rounding)."""
    b, n = ZONES[zone]
    src_sum, src2 = _sums(_blocks(b, n, seed=3 * b, kind=kind))
    row = _scalars(np.float32(0.85 * (212 / 8.0) ** 2))
    before = K.aq_scale.launches
    got = on_standin.aq_scale(src_sum, src2, n, row)
    assert K.aq_scale.launches == before + 1
    want = P.aq_scale_ref(src_sum, src2, n, row)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if kind != "equal":
        assert len(np.unique(want.numpy())) > 3


def test_wrapper_refusals_and_the_dispatch():
    """The wrapper launches or raises: CPU tensors, sums of another dtype
    or length, a short scalars row; the step's dispatch takes the plain
    version for CPU tensors and launches nothing."""
    src_sum, src2 = _sums(_blocks(16, 32, seed=5))
    row = _scalars(2.0)
    before = K.aq_scale.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.aq_scale(src_sum, src2, 32, row)
    got = P.aq_scale(src_sum, src2, 32, row)
    np.testing.assert_array_equal(
        got.numpy(), P.aq_scale_ref(src_sum, src2, 32, row).numpy())
    assert K.aq_scale.launches == before
    meta = [t.to("meta") for t in (src_sum, src2, row)]
    with pytest.raises(TypeError, match="int32"):
        K.aq_scale(meta[0].long(), meta[1], 32, meta[2])
    with pytest.raises(TypeError, match="src2"):
        K.aq_scale(meta[0], meta[1][:3], 32, meta[2])
    with pytest.raises(TypeError, match="scalars"):
        K.aq_scale(meta[0], meta[1], 32, meta[2][:4])
