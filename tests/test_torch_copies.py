"""The port's copies of the JAX package's host modules do not drift.

``tpu_vp9_torch`` imports nothing of ``tpu_vp9``: it keeps its own copy of
every host module it needs, under the same relative path. Each copy must
equal its source once ``tpu_vp9_torch`` is read as ``tpu_vp9``, except
for the modules listed in ``CHANGED``, each with its reason; of those,
every public top-level function and class of the source must still exist
in the copy (bar the ones named as dropped on purpose).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXACT = [
    "bitstream/__init__.py", "bitstream/tables.py", "bitstream/headers.py",
    "bitstream/bool_coder.py", "bitstream/tokenize.py",
    "bitstream/prob_update.py", "bitstream/ivf.py",
    "codec/__init__.py", "codec/modeinfo.py", "codec/mv.py",
    "codec/rd_cost.py", "codec/adapt.py", "codec/fwd_update.py",
    "decoder/__init__.py", "decoder/decoder.py",
    "ops/intra.py", "ops/inter.py", "ops/loopfilter.py", "ops/me.py",
    "ops/hme.py", "config.py",
    "pipeline/presets.py", "pipeline/rate_control.py",
    "pipeline/picture_decision.py", "pipeline/picture_analysis.py",
    "pipeline/rc_curves.py", "utils/trace.py",
]

# module -> (why it differs, names of the source it drops on purpose)
CHANGED = {
    "codec/inter_frame.py": (
        "encode_pframe takes a device, calls the port's tpu_block_motion "
        "and lets its failure propagate (the JAX one falls back to the "
        "host search)", ()),
    "codec/intra_frame.py": (
        "openloop_mode_hints_np is built from tpu_intra (a jax module): "
        "it raises NotImplementedError until tpu_intra is ported", ()),
    "ops/txfm.py": (
        "xp=jnp branches dropped, xp=torch added where the device step "
        "needs it, and the step's float64 forward transform and "
        "quantizer appended", ()),
    "native.py": (
        "compiles native/vp9_native.cpp into tpu_vp9_torch/_build/ under "
        "a file lock, apart from the JAX package's build", ()),
    "pipeline/encoder.py": (
        "the tpu_intra keyframe-hint branches raise NotImplementedError "
        "and the accelerator probe is gone", ()),
    "utils/yuv.py": ("panning_frames appended (test content with global "
                     "motion)", ()),
    "api.py": (
        "the port's own Vp9Encoder(device): the random-access engines, "
        "speed control and meshes raise NotImplementedError",
        ()),
    "app.py": (
        "the port's own CLI: -device added; -nch, -gop-parallel and "
        "-distributed are refused",
        ("run_channels",)),
}


def _read(pkg, rel):
    with open(os.path.join(REPO, pkg, rel)) as fh:
        return fh.read()


def _public_names(text):
    return {n.name for n in ast.parse(text).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


@pytest.mark.parametrize("rel", EXACT)
def test_copy_equals_its_source(rel):
    copy = _read("tpu_vp9_torch", rel).replace("tpu_vp9_torch", "tpu_vp9")
    assert copy == _read("tpu_vp9", rel), (
        f"tpu_vp9_torch/{rel} drifted from tpu_vp9/{rel}")


def test_copied_tables_are_the_source_s():
    rel = os.path.join("bitstream", "vp9_tables.npz")
    with open(os.path.join(REPO, "tpu_vp9", rel), "rb") as a, \
            open(os.path.join(REPO, "tpu_vp9_torch", rel), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_copy_keeps_the_source_s_public_names(rel):
    why, dropped = CHANGED[rel]
    assert why
    copy = _read("tpu_vp9_torch", rel)
    assert "import jax" not in copy and "from tpu_vp9." not in copy
    missing = _public_names(_read("tpu_vp9", rel)) - _public_names(copy)
    assert missing == set(dropped), missing


def test_every_port_module_is_accounted_for():
    """A module of the port is a copy (exact or changed), or one of the
    port's own: a new copy cannot slip in unguarded."""
    own = {"__init__.py", "ops/__init__.py", "ops/_build.py",
           "ops/cuda_kernels.py", "pipeline/__init__.py",
           "pipeline/realtime.py", "pipeline/tpu_encdec.py",
           "pipeline/tpu_me.py", "utils/__init__.py", "utils/device.py"}
    found = set()
    root = os.path.join(REPO, "tpu_vp9_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                found.add(os.path.relpath(os.path.join(dirpath, name), root))
    assert found == own | set(EXACT) | set(CHANGED), (
        found ^ (own | set(EXACT) | set(CHANGED)))
