"""Guards of the port: it imports neither jax nor the JAX package
``tpu_vp9``, it has no silent CPU fallback, and it refuses the routes it
has not ported."""

import ast
import glob
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import tpu_vp9_torch
from tpu_vp9_torch import api as port_api
from tpu_vp9_torch.config import (
    EncoderConfig, PredStructure, RateControlMode, Tune,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# an import hook that makes any import of jax or of the JAX package fail
_BLOCK_JAX = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name in ("jax", "tpu_vp9") or name.startswith(
                    ("jax.", "jaxlib", "tpu_vp9.")):
                raise ImportError(name + " is blocked in this process")
            return None

    sys.meta_path.insert(0, _NoJax())

    def assert_clean():
        bad = [k for k in sys.modules if k in ("jax", "tpu_vp9")
               or k.startswith(("jax.", "jaxlib", "tpu_vp9."))]
        assert not bad, bad
""")

PORT_FILES = sorted(
    glob.glob(os.path.join(REPO, "tpu_vp9_torch", "**", "*.py"),
              recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
    """Top-level package names a file imports, at any depth of its AST
    (function-level imports included)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_ast_scan_covers_the_port():
    names = {os.path.relpath(p, REPO) for p in PORT_FILES}
    for must in ("chip_smoke.py", "tpu_vp9_torch/api.py",
                 "tpu_vp9_torch/app.py", "tpu_vp9_torch/native.py",
                 "tpu_vp9_torch/decoder/decoder.py",
                 "tpu_vp9_torch/pipeline/realtime.py"):
        assert must in names
    assert len(names) > 40


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "tpu_vp9"}, roots
    if path.endswith("chip_smoke.py"):
        stdlib = set(sys.stdlib_module_names)
        assert roots - stdlib <= {"numpy", "torch", "tpu_vp9_torch"}, roots


# ---------------------------------------------------------------------------
# no fallback: a CUDA tensor reaches a kernel or an exception, never a plain
# version
# ---------------------------------------------------------------------------

KERNELS_PY = os.path.join(REPO, "tpu_vp9_torch", "ops", "cuda_kernels.py")
ENCDEC_PY = os.path.join(REPO, "tpu_vp9_torch", "pipeline", "tpu_encdec.py")
WRAPPERS = ("sad_full_search", "block_energy", "block_energy_at",
            "sse_map_search", "hier_search_fused", "txq_cost", "loop_filter",
            "kframe_wave", "transform_recon", "subpel_search")


def _functions(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _called(node):
    """Names of the functions a node's body calls (plain names and
    attributes alike)."""
    names = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            names.add(f.id if isinstance(f, ast.Name) else
                      f.attr if isinstance(f, ast.Attribute) else "")
    return names


def _ref_calls_outside_cpu_branches(fn):
    """Calls of a plain version (``*_ref``) in ``fn`` that do not sit in
    the body of an ``if`` whose test mentions "cpu"."""
    guarded = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.If) and "cpu" in ast.unparse(sub.test):
            for stmt in sub.body:
                guarded.update(id(n) for n in ast.walk(stmt))
    return [ast.unparse(n) for n in ast.walk(fn)
            if isinstance(n, ast.Call) and id(n) not in guarded
            and ast.unparse(n.func).endswith("_ref")]


def test_wrappers_cover_every_kernel_source():
    """Every CUDA source has a launcher entry, every launcher entry a
    wrapper of its name with a launch count, and the scan below covers
    them all, the loop filter's included."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    sources = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(REPO, "tpu_vp9_torch", "csrc", "*.cu"))}
    assert sources == {lib for lib, *_ in K._LAUNCHERS.values()}
    assert {"loop_filter", "kframe_wave", "transform_recon",
            "subpel_search"} <= sources and len(sources) == 8
    assert set(K._LAUNCHERS) == set(WRAPPERS)
    fns = _functions(KERNELS_PY)
    for name in WRAPPERS:
        assert name in fns
        assert isinstance(getattr(K, name).launches, int)
        assert "_launch" in _called(fns[name]), name


def test_kernel_module_catches_nothing():
    """No ``try`` anywhere in the wrappers' module, nor in the step's
    module: a failed launch or a refused argument propagates."""
    for path in (KERNELS_PY, ENCDEC_PY):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        assert not [n.lineno for n in ast.walk(tree)
                    if isinstance(n, ast.Try)], path


# wrapper -> (the step's dispatch, the steps that must call the dispatch,
# the other plain versions that call this plain version)
STEP_DISPATCH = {
    "loop_filter": ("loop_filter_device", ("pframe_step", "kframe_step"), ()),
    "kframe_wave": ("kframe_wave_device", ("kframe_step",), ()),
    "transform_recon": ("transform_recon",
                        ("encode_zone", "encode_children_masked"),
                        ("kframe_wave_ref",)),
    "subpel_search": ("subpel_search",
                      ("encode_zone", "encode_children_masked"), ()),
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_takes_the_plain_version_only_for_cpu_tensors(name):
    fn = _functions(KERNELS_PY)[name]
    assert not _ref_calls_outside_cpu_branches(fn)
    if name in STEP_DISPATCH:
        # its plain version lives with the step; the wrapper never calls it
        assert not [c for c in _called(fn) if c.endswith("_ref")]
        with open(KERNELS_PY) as fh:
            text = fh.read()
        assert f"import {name}_ref" not in text
        assert "tpu_vp9_torch.pipeline" not in text


def _check_step_dispatch(name):
    """In the step's module ``<kernel>_ref`` is called from its dispatch
    alone (and from the plain versions named in STEP_DISPATCH), inside the
    branch taken when every tensor lies on the CPU; everything else goes
    to the kernel's wrapper, and the steps call the dispatch, not the
    plain version."""
    disp_name, steps, plain_callers = STEP_DISPATCH[name]
    fns = _functions(ENCDEC_PY)
    callers = [n for n, f in fns.items() if f"{name}_ref" in _called(f)]
    assert sorted(callers) == sorted([disp_name, *plain_callers])
    disp = fns[disp_name]
    assert not _ref_calls_outside_cpu_branches(disp)
    branches = [n for n in ast.walk(disp) if isinstance(n, ast.If)
                and "cpu" in ast.unparse(n.test)]
    assert len(branches) == 1
    test = ast.unparse(branches[0].test)
    assert test.startswith("all(") and "device.type == 'cpu'" in test
    assert not branches[0].orelse
    last = disp.body[-1]
    assert isinstance(last, ast.Return)
    assert ast.unparse(last.value.func) in (name, f"cuda_kernels.{name}")
    for step in steps:
        assert disp_name in _called(fns[step]), step
        assert f"{name}_ref" not in _called(fns[step]), step


def test_loop_filter_dispatch_has_no_route_from_cuda_to_the_plain_version():
    _check_step_dispatch("loop_filter")


def test_kframe_wave_dispatch_has_no_route_from_cuda_to_the_plain_version():
    _check_step_dispatch("kframe_wave")


def test_transform_recon_dispatch_has_no_route_from_cuda_to_the_plain_version():
    _check_step_dispatch("transform_recon")


def test_subpel_search_dispatch_has_no_route_from_cuda_to_the_plain_version():
    _check_step_dispatch("subpel_search")


def test_kframe_wave_ref_transforms_with_the_plain_version():
    """The keyframe's plain version, which chip_smoke.py holds kframe_wave
    against on the card, stays plain there: it calls transform_recon_ref,
    not the step's dispatch (which would take the kernel)."""
    called = _called(_functions(ENCDEC_PY)["kframe_wave_ref"])
    assert "transform_recon_ref" in called
    assert "transform_recon" not in called


def test_kernel_module_imports_nothing_of_the_pipeline():
    with open(KERNELS_PY) as fh:
        tree = ast.parse(fh.read())
    mods = [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module]
    mods += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    assert mods and not [m for m in mods if "pipeline" in m], mods

def test_kernel_sources_include_nothing_of_another_package():
    """The CUDA sources include the toolkit's and the C++ library's headers
    and the port's own shared headers only."""
    allowed = {"<algorithm>", "<cstdint>", "<cuda_runtime.h>",
               "<cuda_pipeline.h>", "<cuda_fp16.h>"}
    csrc = os.path.join(REPO, "tpu_vp9_torch", "csrc")
    own = {f'"{os.path.basename(p)}"'
           for p in glob.glob(os.path.join(csrc, "*.cuh"))}
    assert {'"txfm_common.cuh"', '"convolve8.cuh"'} <= own
    for path in glob.glob(os.path.join(csrc, "*.cu*")):
        with open(path) as fh:
            incs = {ln.split(None, 1)[1].strip() for ln in fh
                    if ln.startswith("#include")}
        assert incs <= allowed | own, (path, incs - allowed - own)


def _fake_cuda_kframe_wave(monkeypatch, launch):
    """kframe_wave on CPU planes made to look like CUDA ones: the device
    check answers "cuda", ``_launch`` is ``launch``, and the plain version
    raises if it is reached."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    def no_plain(*a, **k):
        raise AssertionError("kframe_wave reached its plain version")

    monkeypatch.setattr(K, "_device_kind", lambda name, *t: "cuda")
    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(P, "kframe_wave_ref", no_plain)
    g = P.make_geom(160, 120)
    planes = [torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8),
              torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8),
              torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8)]
    return K, g, planes


def test_kframe_wave_on_cuda_launches_once_per_diagonal(monkeypatch):
    calls = []
    K, g, planes = _fake_cuda_kframe_wave(
        monkeypatch, lambda name, dev, *args: calls.append((name, args)))
    before = K.kframe_wave.launches
    out = K.kframe_wave(*planes, g, 93, 112, 196)
    n_diag = g.rows32 + g.cols32 - 1
    assert [c[0] for c in calls] == ["kframe_wave"] * n_diag
    assert K.kframe_wave.launches - before == n_diag
    # the diagonal, its first block row and its block count, in order
    got = [args[17:20] for _, args in calls]
    assert got == [(d, *K.kf_diagonal(d, g.rows32, g.cols32))
                   for d in range(n_diag)]
    assert sum(a[2] for a in got) == g.n_blocks32
    assert len(out) == 10


def test_kframe_wave_on_cuda_raises_when_the_launch_fails(monkeypatch):
    def refused(name, dev, *args):
        raise RuntimeError(f"{name}: CUDA launch failed with error 9")

    K, g, planes = _fake_cuda_kframe_wave(monkeypatch, refused)
    with pytest.raises(RuntimeError, match="launch failed"):
        K.kframe_wave(*planes, g, 93, 112, 196)


def _meta_stage_inputs(name):
    """Arguments of the step's dispatch ``name`` as tensors that do not lie
    on the CPU (meta tensors: shapes and dtypes, no data), at the M8
    zone's shape."""
    from tpu_vp9_torch.bitstream import tables as T

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if name == "transform_recon":
        return (meta((6, 32, 32), torch.uint8), meta((6, 32, 32), torch.uint8),
                T.dc_quant(120), T.ac_quant(120), 32)
    return (meta((6, 48, 48), torch.uint8), meta((6, 32, 32), torch.uint8),
            meta((6,), torch.int32), meta((6,), torch.int32), 32, 4)


def _fake_cuda_stage(monkeypatch, name, launch):
    """The step's dispatch ``name`` with the wrappers' device check
    answering "cuda", ``_launch`` replaced by ``launch`` and the plain
    version raising if it is reached."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    def no_plain(*a, **k):
        raise AssertionError(f"{name} reached its plain version")

    monkeypatch.setattr(K, "_device_kind", lambda nm, *t: "cuda")
    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(P, f"{name}_ref", no_plain)
    return K, getattr(P, name)


@pytest.mark.parametrize("name", ["transform_recon", "subpel_search"])
def test_stage_dispatch_sends_non_cpu_tensors_to_one_launch(monkeypatch,
                                                           name):
    calls = []
    K, dispatch = _fake_cuda_stage(
        monkeypatch, name, lambda nm, dev, *args: calls.append((nm, args)))
    args = _meta_stage_inputs(name)
    before = getattr(K, name).launches
    out = dispatch(*args)
    assert [c[0] for c in calls] == [name]
    assert getattr(K, name).launches - before == 1
    assert len(out) == 3 and all(t.device.type == "meta" for t in out)
    # the launcher's ints: blocks, then n and the quantizers, or n and r
    want = ((6, 32, args[2], args[3]) if name == "transform_recon"
            else (6, 32, 4))
    assert calls[0][1][-len(want):] == want


def test_stage_dispatch_raises_when_the_launch_fails(monkeypatch):
    def refused(nm, dev, *args):
        raise RuntimeError(f"{nm}: CUDA launch failed with error 9")

    for name in ("transform_recon", "subpel_search"):
        _, dispatch = _fake_cuda_stage(monkeypatch, name, refused)
        with pytest.raises(RuntimeError, match="launch failed"):
            dispatch(*_meta_stage_inputs(name))


@pytest.mark.parametrize("name", ["transform_recon", "subpel_search"])
def test_stage_wrapper_refuses_cpu_tensors(name):
    """The wrappers launch or raise: CPU tensors reach the plain version
    through the step's dispatch only."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    args = [t if not isinstance(t, torch.Tensor) else
            torch.zeros(t.shape, dtype=t.dtype)
            for t in _meta_stage_inputs(name)]
    before = getattr(K, name).launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(K, name)(*args)
    assert getattr(K, name).launches == before


def _run(code, env_extra=None, timeout=300):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpu_vp9_torch.__path__, "tpu_vp9_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    for m in ("ops.cuda_kernels", "ops.txfm", "pipeline.tpu_encdec",
              "pipeline.realtime", "app", "native", "decoder.decoder",
              "bitstream.tables", "codec.inter_frame"):
        assert f"tpu_vp9_torch.{m}" in mods
    code = _BLOCK_JAX + textwrap.dedent(f"""
        import importlib
        for m in {mods!r}:
            importlib.import_module(m)
        assert_clean()
        print("imported", len({mods!r}))
    """)
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"imported {len(mods)}" in res.stdout


def test_port_encode_runs_without_jax():
    """A 720p M7 P-frame reaches the device search (on the CPU here) in a
    process where neither jax nor tpu_vp9 can be imported."""
    code = _BLOCK_JAX + textwrap.dedent("""
        import torch
        torch.set_num_threads(1)
        from tpu_vp9_torch.config import EncoderConfig, PredStructure
        from tpu_vp9_torch.api import Vp9Encoder
        from tpu_vp9_torch.codec import inter_frame
        from tpu_vp9_torch.utils.yuv import panning_frames

        calls = []
        real = inter_frame.tpu_block_motion
        inter_frame.tpu_block_motion = lambda *a: calls.append(1) or real(*a)
        enc = Vp9Encoder(device="cpu")
        enc.set_parameter(EncoderConfig(
            source_width=1280, source_height=720, enc_mode=7, qp=50,
            pred_structure=PredStructure.LOW_DELAY_P))
        enc.init()
        for fr in panning_frames(1280, 720, 2):
            enc.send_picture(fr)
        enc.flush()
        assert len(calls) == 1
        assert_clean()
        print("encoded", sum(len(enc.get_packet().data) for _ in range(2)))
    """)
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "encoded" in res.stdout


def test_port_m9_encode_runs_without_jax():
    """A 128x96 M9 encode through the public API runs the port's realtime
    session on device="cpu" in a process where neither jax nor tpu_vp9 can
    be imported."""
    code = _BLOCK_JAX + textwrap.dedent("""
        import torch
        torch.set_num_threads(1)
        from tpu_vp9_torch.config import EncoderConfig, PredStructure
        from tpu_vp9_torch.api import Vp9Encoder
        from tpu_vp9_torch.pipeline import realtime
        from tpu_vp9_torch.utils.yuv import panning_frames

        enc = Vp9Encoder(device="cpu")
        enc.set_parameter(EncoderConfig(
            source_width=128, source_height=96, enc_mode=9, qp=40,
            pred_structure=PredStructure.LOW_DELAY_P))
        enc.init()
        assert isinstance(enc._rt, realtime.RtSession)
        for fr in panning_frames(128, 96, 3):
            enc.send_picture(fr)
        enc.flush()
        pkts = [enc.get_packet() for _ in range(3)]
        assert enc.get_packet() is None
        assert [p.is_keyframe for p in pkts] == [True, False, False]
        assert_clean()
        print("encoded", sum(len(p.data) for p in pkts))
    """)
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "encoded" in res.stdout


def test_port_m8_encode_runs_without_jax():
    """A 128x96 M8 encode through the public API (rate tables, GOLDEN with
    a refresh inside the clip, the split16 descent) runs on device="cpu"
    in a process where neither jax nor tpu_vp9 can be imported, and
    decodes with the port's decoder to the encoder's recon."""
    code = _BLOCK_JAX + textwrap.dedent("""
        import io
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from tpu_vp9_torch.api import Vp9Encoder
        from tpu_vp9_torch.bitstream.ivf import (
            write_ivf_frame, write_ivf_header)
        from tpu_vp9_torch.config import EncoderConfig, PredStructure
        from tpu_vp9_torch.decoder.decoder import decode_ivf
        from tpu_vp9_torch.utils.yuv import panning_frames

        enc = Vp9Encoder(device="cpu")
        enc.set_parameter(EncoderConfig(
            source_width=128, source_height=96, enc_mode=8, qp=40,
            pred_structure=PredStructure.LOW_DELAY_P,
            recon_file="unused.yuv"))
        enc.init()
        rt = enc._rt
        assert rt.split16 and rt.golden and rt.golden_interval == 8
        rt.golden_interval = 2
        recons = []
        emit = enc._emit
        enc._emit = lambda p: (emit(p), recons.append(enc.get_recon()))
        n = 5
        for fr in panning_frames(128, 96, n, seed=3):
            enc.send_picture(fr)
        enc.flush()
        pkts = [enc.get_packet() for _ in range(n)]
        assert enc.get_packet() is None
        assert [p.is_keyframe for p in pkts] == [True] + [False] * (n - 1)
        buf = io.BytesIO()
        write_ivf_header(buf, 128, 96, 30, 1, n)
        for p in pkts:
            write_ivf_frame(buf, p.data, p.pts)
        buf.seek(0)
        dec = list(decode_ivf(buf))
        assert len(dec) == n
        for (y, u, v, _), rec in zip(dec, recons):
            for a, b in zip((y, u, v), rec):
                assert np.array_equal(a, b)
        assert_clean()
        print("encoded", sum(len(p.data) for p in pkts))
    """)
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "encoded" in res.stdout


def _slice_cfg(**kw):
    base = dict(source_width=128, source_height=96, enc_mode=7, qp=40,
                pred_structure=PredStructure.LOW_DELAY_P)
    base.update(kw)
    return EncoderConfig(**base)


def test_default_device_without_cuda_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = port_api.Vp9Encoder()
    assert enc.device.type == "cuda"
    enc.set_parameter(_slice_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.init()


def test_app_without_cuda_fails_loudly(tmp_path):
    from tpu_vp9_torch.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 2))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(tmp_path / "out.ivf"), "-enc-mode", "7", "-pred-struct", "0",
         "-q", "40"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "SUMMARY" not in res.stdout


def test_m9_without_cuda_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = port_api.Vp9Encoder()
    enc.set_parameter(_slice_cfg(enc_mode=9))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.init()


@pytest.mark.parametrize("kw", [
    dict(pred_structure=PredStructure.RANDOM_ACCESS),
    dict(enc_mode=8, tune=Tune.SQ),
    dict(enc_mode=8, tpu_realtime=0),
    dict(enc_mode=8, rate_control_mode=RateControlMode.CBR,
         target_bit_rate=200_000),
    dict(enc_mode=8, source_height=112),
    dict(enc_mode=8, source_width=112),
    dict(enc_mode=8, tpu_mesh_shape=(1, 2)),
    dict(enc_mode=9, tpu_realtime=0),
    dict(enc_mode=9, rate_control_mode=RateControlMode.VBR,
         target_bit_rate=200_000),
    dict(enc_mode=9, source_height=112),
    dict(enc_mode=9, source_width=112),
    dict(enc_mode=9, pred_structure=PredStructure.RANDOM_ACCESS),
    dict(speed_control=True),
    dict(tpu_mesh_shape=(1, 2)),
], ids=["random_access", "m8", "m8_rt0", "m8_cbr", "m8_strip",
        "m8_width_not_32", "m8_mesh", "m9", "m9_vbr", "m9_strip",
        "m9_width_not_32", "m9_random_access", "speed_control", "mesh"])
def test_unported_routes_raise(kw):
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(_slice_cfg(**kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc.init()


@pytest.mark.parametrize("flags,why", [
    (["-gop-parallel", "2"], "-gop-parallel"),
    (["-nch", "2"], "-nch"),
    (["-distributed", "localhost:1234,2,0"], "-distributed"),
    (["-enc-mode", "9", "-pred-struct", "0", "-rt", "0"], "tpu_realtime 0"),
    (["-enc-mode", "8", "-pred-struct", "0", "-tune", "0"], "tune SQ"),
    (["-enc-mode", "8", "-pred-struct", "0", "-rc", "1"], "rate control"),
    ([], "random access"),
], ids=["gop_parallel", "nch", "distributed", "m9", "m8", "m8_vbr",
        "default_ra"])
def test_app_refuses_unported_options(tmp_path, flags, why):
    from tpu_vp9_torch.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 1))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip),
         "-device", "cpu", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode != 0
    assert why in res.stderr


def test_app_encodes_m9_on_cpu_device(tmp_path):
    """The M9 CLI line, decoded back."""
    from tpu_vp9_torch.decoder.decoder import decode_ivf
    from tpu_vp9_torch.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    out = tmp_path / "out.ivf"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 3, motion=True))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(out), "-enc-mode", "9", "-pred-struct", "0", "-q", "40",
         "-device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SUMMARY: 3 frames" in res.stdout
    with open(out, "rb") as fh:
        assert len(list(decode_ivf(fh))) == 3


def test_app_encodes_m8_on_cpu_device(tmp_path):
    """The M8 CLI line, decoded back."""
    from tpu_vp9_torch.decoder.decoder import decode_ivf
    from tpu_vp9_torch.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    out = tmp_path / "out.ivf"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 4, motion=True))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(out), "-enc-mode", "8", "-pred-struct", "0", "-q", "40",
         "-device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SUMMARY: 4 frames" in res.stdout
    with open(out, "rb") as fh:
        assert len(list(decode_ivf(fh))) == 4


def test_app_encodes_on_cpu_device(tmp_path):
    from tpu_vp9_torch.decoder.decoder import decode_ivf
    from tpu_vp9_torch.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    out = tmp_path / "out.ivf"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 3))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(out), "-enc-mode", "7", "-pred-struct", "0", "-q", "40",
         "-device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SUMMARY: 3 frames" in res.stdout
    with open(out, "rb") as fh:
        assert len(list(decode_ivf(fh))) == 3
