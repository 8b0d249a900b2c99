"""The one-level search of ``tpu_vp9_torch/csrc/sse_search.cu`` run on the
CPU: g++ builds the kernel and its launcher behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread), and
each launch is held against the plain version
``ops/cuda_kernels.py:sse_map_search_ref``, winner and map, bit for bit: the
strip zone's flat +-40 level of 16x16 blocks (95,684 bytes of shared memory,
past the 48 KB a kernel has without asking), the children's +-8 and the
half-resolution +-18 of int16 sums, with a planted match, ties and the
largest operands.

The launcher's opt-in is held too, as far as the stand-in's runtime calls
allow: a level past 48 KB sets the kernel's attribute once a device, before
the launch (the stand-in's launch refuses, as the runtime does, shared
memory the kernel was not opted in to); a level within 48 KB sets none; a
level past the device's sharedMemPerBlockOptin, and a refused attribute,
come back as errors with nothing run.

What this cannot show: that nvcc accepts the source, the card's own
limits, timing. ``chip_smoke.py`` checks the kernel on the card.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_vp9_torch.ops import cuda_kernels as K

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
H100_OPTIN = 227 * 1024  # an H100's sharedMemPerBlockOptin

_DRIVER = """
}  // namespace

%(launcher)s

// the stand-in runtime's settings and counts
extern "C" void standin_config(int device, int optin, int set_error) {
  standin_device = device;
  standin_smem_optin = optin;
  standin_set_attribute_error = set_error;
}
extern "C" int standin_set_calls() { return standin_set_attribute_calls; }
"""
_LAUNCH = """  sse_search_kernel<T, N, TX><<<b, threads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(wins), r, sw, rg, dy,
      dx, map);"""
_STANDIN_LAUNCH = """  standin_kernel_launch(sse_search_kernel<T, N, TX>, b, threads, smem, [&] {
    sse_search_kernel<T, N, TX>(
        static_cast<const T*>(src), static_cast<const T*>(wins), r, sw, rg,
        dy, dx, map);
  });"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The one-level kernel and its launcher built with g++ behind the
    stand-ins: the source up to the fused two-level kernel, its dynamic
    shared memory the stand-ins' buffer, its static shared words statics
    (the stand-in runs a grid's CTAs one after another), its launch the
    stand-in's, and the C entry point ``sse_map_search_launch``."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the stand-in of the CUDA source"
    with open(os.path.join(CSRC, "sse_search.cu")) as fh:
        src = fh.read()
    cut = src.index("// Both levels of the hierarchical search in one launch")
    cut = src.rindex("// ----", 0, cut)
    body = src[:cut]
    for old, new in (
            ("extern __shared__ float4 smem4[];",
             "float4* smem4 = reinterpret_cast<float4*>(standin_smem);"),
            ("__shared__ unsigned long long s_warp[32];",
             "static unsigned long long s_warp[32];"),
            ("__shared__ unsigned int s_src2;", "static unsigned int s_src2;"),
            (_LAUNCH, _STANDIN_LAUNCH)):
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    launcher = re.search(r'extern "C" int sse_map_search_launch\(.*?\n}\n',
                         src, re.S).group(0)
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "sse_search_standin.cpp", out / "libsse.so"
    cpp.write_text(body + _DRIVER % {"launcher": launcher})
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-ffp-contract=off", "-shared",
         "-fPIC", "-I", STANDIN, "-I", CSRC, "-o", str(lib), str(cpp),
         "-lpthread"], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.sse_map_search_launch.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p])
    dll.sse_map_search_launch.restype = ctypes.c_int
    dll.standin_config.argtypes = [ctypes.c_int] * 3
    dll.standin_config.restype = None
    dll.standin_set_calls.restype = ctypes.c_int
    return dll


def _run(dll, src, wins, n, r, want_map=True):
    """One launch on CPU tensors: (the launcher's error, dy, dx, map);
    the outputs start as junk so that a place not written shows."""
    b = src.shape[0]
    d = 2 * r + 1
    out = torch.full((2, b), -777, dtype=torch.int32)
    rel = torch.full((b, d, d), -777, dtype=torch.int32)
    err = dll.sse_map_search_launch(
        src.data_ptr(), wins.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), rel.data_ptr() if want_map else None, b, n, r,
        wins.shape[-1], src.element_size(), None)
    return err, out[0], out[1], rel


def _inputs(n, r, b, seed, half=False):
    """(src, wins): b blocks and their windows of n + 2r + 8, a planted
    exact match in block 0, and where b allows every candidate tying in
    block 1, the largest operands in block 2 (a window of the top value
    against a zero source) and in block 3 (against a source of the top
    value); uint8 pixels, or with ``half`` int16 2x2 sums of pixels."""
    rng = np.random.default_rng(seed)
    sw = n + 2 * r + 8
    top = 1020 if half else 255
    wins = rng.integers(0, top + 1, (b, sw, sw)).astype(np.int32)
    src = rng.integers(0, top + 1, (b, n, n)).astype(np.int32)
    oy, ox = rng.integers(0, 2 * r + 1, 2)
    wins[0, 4 + oy:4 + oy + n, 4 + ox:4 + ox + n] = src[0]
    for i, (s_val, w_val) in enumerate(((40, 40), (0, top), (top, top)), 1):
        if i < b:
            src[i], wins[i] = s_val, w_val
    dt = np.int16 if half else np.uint8
    return torch.from_numpy(src.astype(dt)), torch.from_numpy(wins.astype(dt))


@pytest.mark.parametrize("n,r,half", [(16, 40, False), (16, 8, False),
                                      (16, 18, True)],
                         ids=["strip_n16_r40", "children_n16_r8",
                              "half_res_n16_r18"])
def test_standin_level_matches_plain_version(standin, n, r, half):
    """Five blocks (five CTAs) at each of the step's one-level shapes: the
    winners and the maps bit for bit, with the map and without."""
    standin.standin_config(0, H100_OPTIN, 0)
    src, wins = _inputs(n, r, 5, seed=n + r, half=half)
    want = K.sse_map_search_ref(src, wins, n, r)
    err, dy, dx, rel = _run(standin, src, wins, n, r)
    assert err == 0
    assert torch.equal(dy, want[0]) and torch.equal(dx, want[1])
    assert torch.equal(rel, want[2])
    err, dy2, dx2, rel2 = _run(standin, src, wins, n, r, want_map=False)
    assert err == 0 and torch.equal(dy2, dy) and torch.equal(dx2, dx)
    assert bool((rel2 == -777).all())  # no map asked, none written
    assert int(rel[0].min()) < 0 and (int(dy[1]), int(dx[1])) == (-r, -r)
    top = int(wins[2].max())
    assert int(rel[2, 0, 0]) == n * n * top * top
    assert int(rel[3, 0, 0]) == -n * n * top * top


def test_standin_opts_in_once_before_the_launch(standin):
    """The strip's level (95,684 bytes) sets the kernel's attribute before
    its first launch on a device and not again; a level within 48 KB sets
    none. A launch that had not opted in would be refused by the
    stand-in's launch and show as an error here."""
    assert K.sse_level_smem(16, 40) == 95_684 > 48 * 1024
    standin.standin_config(3, H100_OPTIN, 0)
    src, wins = _inputs(16, 40, 2, seed=5)
    before = standin.standin_set_calls()
    for _ in range(2):
        err, dy, dx, rel = _run(standin, src, wins, 16, 40)
        assert err == 0
    assert standin.standin_set_calls() - before == 1
    want = K.sse_map_search_ref(src, wins, 16, 40)
    assert torch.equal(dy, want[0]) and torch.equal(rel, want[2])
    small_src, small_wins = _inputs(16, 8, 2, seed=6)
    err, *_ = _run(standin, small_src, small_wins, 16, 8)
    assert err == 0
    assert standin.standin_set_calls() - before == 1


def test_standin_refuses_a_level_past_the_device_limit(standin):
    """A level past the device's sharedMemPerBlockOptin (less the static
    words) is refused before any launch: at n=32 r=64 (256,324 bytes) on
    an H100, and the strip's own level on a device that offers 64 KB."""
    standin.standin_config(4, H100_OPTIN, 0)
    assert K.sse_level_smem(32, 64) > K.SSE_SMEM_BYTES
    src, wins = _inputs(32, 64, 1, seed=7)
    err, dy, _, rel = _run(standin, src, wins, 32, 64)
    assert err == 1 and int(dy[0]) == -777 and bool((rel == -777).all())
    standin.standin_config(5, 64 * 1024, 0)
    src, wins = _inputs(16, 40, 1, seed=8)
    err, dy, _, _ = _run(standin, src, wins, 16, 40)
    assert err == 1 and int(dy[0]) == -777


def test_standin_returns_a_refused_opt_in(standin):
    """An attribute the runtime refuses comes back as the launcher's
    error, and nothing runs; the next device that grants it runs."""
    standin.standin_config(6, H100_OPTIN, 98)
    src, wins = _inputs(16, 40, 1, seed=9)
    err, dy, _, _ = _run(standin, src, wins, 16, 40)
    assert err == 98 and int(dy[0]) == -777
    standin.standin_config(7, H100_OPTIN, 0)
    err, dy, dx, _ = _run(standin, src, wins, 16, 40)
    want = K.sse_map_search_ref(src, wins, 16, 40)
    assert err == 0 and torch.equal(dy, want[0]) and torch.equal(dx, want[1])
