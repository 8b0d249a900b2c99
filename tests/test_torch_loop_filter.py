"""The port's loop filter: its plain version ``loop_filter_ref`` against the
JAX package's ``loop_filter_device`` with and without a split mask and at
geometries with the bottom 16-pixel strip, the content that reaches every
class of the edge filter (in the strip's edges too), the dispatch between
the plain version and the CUDA kernel's wrapper, and the wrapper's refusals.

Inputs come from numpy seeds; JAX runs its Pallas-free loop filter on the
CPU, the port its plain version, which is what CPU tensors take. Tolerance
0: the filter is integer arithmetic throughout. The kernel itself
(``csrc/loop_filter.cu``) runs only on a card, where ``chip_smoke.py`` holds
it against ``loop_filter_ref`` on the same kinds of content.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.ops.loopfilter import sharpness_limits
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)


def _sc(lvl, lim, mblim):
    """The step's row of scalars with the loop filter's level and limits,
    as the dispatch and the wrapper take them."""
    return P.step_scalars(40, 48, 100, lvl, lim, mblim)

# the last is no wider than 64: one superblock column, no band
DIMS = [(128, 128), (192, 120), (160, 96), (96, 64), (64, 64)]
# geometries with the strip (mi_rows % 4 == 2), the third one tile column
STRIP_DIMS = [(128, 112), (96, 80), (64, 48), (256, 176)]
LEVELS = (0, 9, 50)  # copies; thresh 0; thresh 3
LIM_T, MBLIM_T = sharpness_limits(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _planes(g, rng):
    """Padded (y, u, v) planes that reach every class of the edge filter:
    32x32 patches (16x16 in chroma) of three kinds. Blocky: 8x8 blocks of
    any level and a little noise (masked-out lanes at the large steps,
    filter4 with and without high edge variance at the small ones);
    gentle: neighbouring levels within 3 and noise of 0 or 1 (flat and
    flat2); extremes: blocks at 0 or 255 and small steps right beside them
    (the filters' clamps)."""
    def plane(h, w, patch):
        ph, pw = h // patch + 1, w // patch + 1
        kind = np.kron(rng.integers(0, 3, (ph, pw)),
                       np.ones((patch, patch), np.int64))[:h, :w]
        bh, bw = h // 8 + 1, w // 8 + 1

        def blocks(levels):
            return np.kron(levels, np.ones((8, 8)))[:h, :w]

        blocky = blocks(rng.integers(0, 256, (bh, bw))) \
            + rng.normal(0, 2, (h, w))
        base = np.kron(rng.integers(60, 200, (ph, pw)),
                       np.ones((patch // 8, patch // 8), np.int64))
        gentle = blocks(base[:bh, :bw] + rng.integers(0, 4, (bh, bw))) \
            + rng.integers(0, 2, (h, w))
        ends = blocks(rng.choice([0, 2, 5, 250, 253, 255], (bh, bw))) \
            + rng.integers(-1, 2, (h, w))
        out = np.where(kind == 0, blocky, np.where(kind == 1, gentle, ends))
        return np.ascontiguousarray(np.clip(np.rint(out), 0, 255), np.uint8)

    return [plane(g.pad_h, g.pad_w, 32), plane(g.pad_h // 2, g.pad_w // 2, 16),
            plane(g.pad_h // 2, g.pad_w // 2, 16)]


def _mask(g, rng, kind):
    if kind == "none":
        return None
    if kind == "ones":
        return np.ones((g.rows32, g.cols32), np.int32)
    return rng.integers(0, 2, (g.rows32, g.cols32)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_lf(dims, with_mask):
    g = J.make_geom(*dims)
    if with_mask:
        return jax.jit(lambda y, u, v, lvl, lim, mblim, sp:
                       J.loop_filter_device(y, u, v, g, lvl, lim, mblim,
                                            split32=sp))
    return jax.jit(lambda y, u, v, lvl, lim, mblim:
                   J.loop_filter_device(y, u, v, g, lvl, lim, mblim))


@pytest.mark.parametrize("mask_kind", ["none", "random", "ones"])
@pytest.mark.parametrize("dims", DIMS, ids=[f"{w}x{h}" for w, h in DIMS])
def test_loop_filter_ref_matches_jax(dims, mask_kind):
    """``loop_filter_ref`` equals the JAX ``loop_filter_device`` bit for
    bit on all three planes, at lvl 0, a low and a high level, with the
    split mask the JAX step would hand it; the inputs stay as they were."""
    g = P.make_geom(*dims)
    assert not g.strip
    rng = np.random.default_rng(dims[0] * 1000 + dims[1])
    planes = _planes(g, rng)
    mask = _mask(g, rng, mask_kind)
    fn = _jax_lf(dims, mask is not None)
    for lvl in LEVELS:
        lim, mblim = int(LIM_T[lvl]), int(MBLIM_T[lvl])
        args = [jnp.asarray(p) for p in planes] + [
            jnp.int32(lvl), jnp.int32(lim), jnp.int32(mblim)]
        if mask is not None:
            args.append(jnp.asarray(mask))
        want = fn(*args)
        ins = [_t(p) for p in planes]
        got = P.loop_filter_ref(*ins, g, lvl, lim, mblim,
                                split32=None if mask is None else _t(mask))
        for k, (a, b, i, p) in enumerate(zip(got, want, ins, planes)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"plane {k} lvl {lvl}")
            np.testing.assert_array_equal(i.numpy(), p)
            assert a.dtype == torch.uint8
        if lvl == 0:
            for a, p in zip(got, planes):
                np.testing.assert_array_equal(a.numpy(), p)
        elif dims[0] >= 128:  # the small pictures have few live edges
            assert any(not np.array_equal(a.numpy(), p)
                       for a, p in zip(got, planes))


@pytest.mark.parametrize("dims", STRIP_DIMS,
                         ids=[f"{w}x{h}" for w, h in STRIP_DIMS])
def test_loop_filter_ref_matches_jax_with_the_strip(dims):
    """At a strip geometry (no mask: the JAX step has none there),
    ``loop_filter_ref`` equals the JAX ``loop_filter_device`` bit for bit
    on all three planes at lvl 0, 9 and 50; the inputs stay as they
    were."""
    g = P.make_geom(*dims)
    assert g.strip and g.h_mi == g.strip_y + 16
    rng = np.random.default_rng(dims[0] * 1000 + dims[1])
    planes = _planes(g, rng)
    fn = _jax_lf(dims, False)
    for lvl in LEVELS:
        lim, mblim = int(LIM_T[lvl]), int(MBLIM_T[lvl])
        want = fn(*[jnp.asarray(p) for p in planes], jnp.int32(lvl),
                  jnp.int32(lim), jnp.int32(mblim))
        ins = [_t(p) for p in planes]
        got = P.loop_filter_ref(*ins, g, lvl, lim, mblim)
        for k, (a, b, i, p) in enumerate(zip(got, want, ins, planes)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"plane {k} lvl {lvl}")
            np.testing.assert_array_equal(i.numpy(), p)
        if lvl:
            assert not np.array_equal(got[1].numpy(), planes[1])


def strip_class_counts(planes, g, lvl, lim, mblim):
    """Lanes of each filter class of the strip's own edges (the luma and
    chroma verticals of its rows, the chroma edge at its top), counted by
    ``loop_filter_ref`` on (y, u, v) CPU tensors."""
    counts, junk = {}, {}
    real_vert, real_horz = P._lf_vert, P._lf_horz

    def vert(plane, rows0, nrows, xs, *args, **kw):
        luma = plane.shape[0] == g.pad_h
        P.LF_CLASS_COUNTS = (counts if rows0 >= g.strip_y >> (not luma)
                             else junk)
        real_vert(plane, rows0, nrows, xs, *args, **kw)

    def horz(plane, ys, *args, **kw):
        top = plane.shape[0] != g.pad_h and g.strip_y >> 1 in ys
        P.LF_CLASS_COUNTS = counts if top else junk
        real_horz(plane, ys, *args, **kw)

    P._lf_vert, P._lf_horz = vert, horz
    try:
        P.LF_CLASS_COUNTS = junk
        P.loop_filter_ref(*planes, g, lvl, lim, mblim)
    finally:
        P._lf_vert, P._lf_horz = real_vert, real_horz
        P.LF_CLASS_COUNTS = None
    return counts


@pytest.mark.parametrize("lvl", [9, 50])
def test_content_reaches_every_filter_class_in_the_strip(lvl):
    """The strip's own edges meet every class the strip allows: masked
    out, filter4 with and without high edge variance, flat and (the luma
    verticals, width 16) flat2."""
    g = P.make_geom(256, 176)
    rng = np.random.default_rng(11)
    planes = [_t(p) for p in _planes(g, rng)]
    lim, mblim = int(LIM_T[lvl]), int(MBLIM_T[lvl])
    counts = strip_class_counts(planes, g, lvl, lim, mblim)
    assert all(counts.get(k, 0) > 0 for k in P.LF_CLASSES), counts


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_strip_geometry_with_a_mask_is_refused(device):
    """A split mask with a strip geometry raises ValueError, in the plain
    version and through the dispatch on any device, as the JAX package's
    ``loop_filter_device`` does."""
    g = P.make_geom(128, 112)
    y = torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8, device=device)
    c = torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8,
                    device=device)
    mask = torch.zeros((g.rows32, g.cols32), dtype=torch.int32,
                       device=device)
    with pytest.raises(ValueError, match="strip"):
        P.loop_filter_device(y, c, c, g, _sc(10, 5, 20), split32=mask)
    if device == "cpu":
        with pytest.raises(ValueError, match="strip"):
            P.loop_filter_ref(y, c, c, g, 10, 5, 20, split32=mask)
        with pytest.raises(ValueError, match="16-strip"):
            J.loop_filter_device(jnp.asarray(y.numpy()),
                                 jnp.asarray(c.numpy()),
                                 jnp.asarray(c.numpy()), J.make_geom(128, 112),
                                 jnp.int32(10), jnp.int32(5), jnp.int32(20),
                                 split32=jnp.asarray(mask.numpy()))


@pytest.mark.parametrize("lvl", [9, 50])
@pytest.mark.parametrize("mask_kind", ["none", "random", "ones"])
def test_content_reaches_every_filter_class(mask_kind, lvl):
    """The made-up planes drive lanes through every class of ``_lf_mixed``:
    masked out, filter4 with and without high edge variance, flat (filter8)
    and flat2 (filter16). Counting changes no output."""
    g = P.make_geom(192, 120)
    rng = np.random.default_rng(7)
    planes = [_t(p) for p in _planes(g, rng)]
    mask = _mask(g, rng, mask_kind)
    mask = None if mask is None else _t(mask)
    lim, mblim = int(LIM_T[lvl]), int(MBLIM_T[lvl])
    plain = P.loop_filter_ref(*planes, g, lvl, lim, mblim, split32=mask)
    P.LF_CLASS_COUNTS = {}
    try:
        counted = P.loop_filter_ref(*planes, g, lvl, lim, mblim,
                                    split32=mask)
        counts = P.LF_CLASS_COUNTS
    finally:
        P.LF_CLASS_COUNTS = None
    assert set(counts) == set(P.LF_CLASSES)
    assert all(counts[k] > 0 for k in P.LF_CLASSES), counts
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)


def test_level_zero_counts_no_lane():
    g = P.make_geom(128, 128)
    planes = [_t(p) for p in _planes(g, np.random.default_rng(1))]
    P.LF_CLASS_COUNTS = {}
    try:
        P.loop_filter_ref(*planes, g, 0, 1, 5)
        counts = P.LF_CLASS_COUNTS
    finally:
        P.LF_CLASS_COUNTS = None
    assert sum(counts.values()) == 0


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def _small_inputs(dims=(128, 128), seed=3):
    g = P.make_geom(*dims)
    rng = np.random.default_rng(seed)
    planes = [_t(p) for p in _planes(g, rng)]
    mask = _t(_mask(g, rng, "random"))
    return g, planes, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_cpu_tensors_take_the_plain_version(monkeypatch, with_mask):
    """``loop_filter_device`` on CPU tensors returns what
    ``loop_filter_ref`` returns, never enters the kernel's wrapper and
    counts no launch."""
    g, planes, mask = _small_inputs()
    mask = mask if with_mask else None

    def no_kernel(*a, **k):
        raise AssertionError("CPU tensors reached the kernel's wrapper")

    monkeypatch.setattr(P, "loop_filter", no_kernel)
    before = K.loop_filter.launches
    got = P.loop_filter_device(*planes, g, _sc(20, 7, 50), split32=mask)
    want = P.loop_filter_ref(*planes, g, 20, 7, 50, split32=mask)
    assert K.loop_filter.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("where", ["all", "y", "u", "v", "mask"])
def test_other_devices_never_take_the_plain_version(monkeypatch, where):
    """A tensor that is not on the CPU sends the call to the kernel's
    wrapper, which launches or raises; here it raises, because a "meta"
    tensor is no CUDA tensor (or not every tensor is on one device), and
    ``loop_filter_ref`` is never entered."""
    g, planes, mask = _small_inputs()

    def no_plain(*a, **k):
        raise AssertionError("a non-CPU tensor reached loop_filter_ref")

    monkeypatch.setattr(P, "loop_filter_ref", no_plain)
    names = ("y", "u", "v", "mask")
    args = [t.to("meta") if where in ("all", n) else t
            for n, t in zip(names, planes + [mask])]
    before = K.loop_filter.launches
    with pytest.raises(ValueError, match="device"):
        P.loop_filter_device(*args[:3], g, _sc(20, 7, 50), split32=args[3])
    assert K.loop_filter.launches == before


def test_the_step_calls_the_dispatch_once(monkeypatch):
    """``pframe_step`` filters through ``loop_filter_device``, once per
    step, with the split mask of the descent when there is one."""
    g = P.make_geom(128, 96)
    rng = np.random.default_rng(1)
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    src = [_t(rng.integers(0, 256, s, dtype=np.uint8)) for s in shapes]
    refs = [P.extend_borders_device(p, g.width >> (k > 0),
                                    g.height >> (k > 0))
            for k, p in enumerate(src)]
    prev = torch.zeros((g.n_blocks32, 2), dtype=torch.int32)
    calls = []
    real = P.loop_filter_device

    def record(y, u, v, geom, sc, split32=None):
        calls.append((*sc.tolist()[P.SC_LF_LVL:], split32))
        return real(y, u, v, geom, sc, split32=split32)

    monkeypatch.setattr(P, "loop_filter_device", record)
    prev16 = torch.zeros((1, 2), dtype=torch.int32)
    P.make_pframe_step(g, "cpu")(*src, *refs, prev, prev16,
                                 P.step_scalars(40, 50, 39, 10, 5, 20))
    assert len(calls) == 1 and calls[0][:3] == (10, 5, 20)
    assert calls[0][3] is None
    from tpu_vp9_torch.bitstream import tables as T
    rates = P.upload_rate_tabs(
        P.make_rate_tabs(T.default_frame_context(), 100), "cpu")
    P.make_pframe_step(g, "cpu", split16=True, golden=True)(
        *src, *refs, *refs, prev, prev16,
        P.step_scalars(40, 50, 39, 10, 5, 20), rates)
    assert len(calls) == 2
    assert tuple(calls[1][3].shape) == (g.rows32, g.cols32)


# ---------------------------------------------------------------------------
# the wrapper's refusals
# ---------------------------------------------------------------------------


def _bad_call(case):
    """(args, kwargs, exception, match) of one refused call."""
    g, (y, u, v), mask = _small_inputs()
    lvl, lim, mblim = 20, 7, 50
    exc, match = ValueError, case
    if case == "strip":  # with a mask
        g = P.make_geom(128, 112)
        y = torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8)
        u = v = torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8)
        mask = torch.zeros((g.rows32, g.cols32), dtype=torch.int32)
        match = "split mask with a strip geometry"
    elif case == "lvl below 0":
        lvl, match = -1, r"lvl=-1 outside \[0, 63\]"
    elif case == "lvl above 63":
        lvl, match = 64, r"lvl=64 outside \[0, 63\]"
    elif case == "negative limit":
        lim, match = -1, "negative limits"
    elif case == "y shape":
        y, match = y[:, :-1].contiguous(), "plane y of shape"
    elif case == "u shape":
        u, match = y, "plane u of shape"
    elif case == "v shape":
        v, match = v[:-2].contiguous(), "plane v of shape"
    elif case == "plane dtype":
        u, exc, match = u.to(torch.int32), TypeError, "plane u must be uint8"
    elif case == "non-contiguous plane":
        wide = torch.zeros((g.pad_h, 2 * g.pad_w), dtype=torch.uint8)
        y, match = wide[:, ::2], "plane y must be contiguous"
    elif case == "mask shape":
        mask, match = mask[:, :-1], "split32 of shape"
    elif case == "float mask":
        mask, exc, match = mask.float(), TypeError, "integer or bool"
    elif case == "geometry":
        g, match = dataclasses.replace(g, pad_h=g.pad_h + 32), "superblocks"
    elif case == "too tall":  # taller than VP9 codes
        g = P.make_geom(64, (1 << 16) + 24)
        y = torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8)
        u = v = torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8)
        mask, match = None, "larger than VP9 codes"
    elif case == "cpu tensors":
        match = "CUDA tensors"
    elif case == "mixed devices":
        u, match = u.to("meta"), "different devices"
    elif case == "mask on another device":
        y, u, v = (t.to("meta") for t in (y, u, v))
        match = "unsupported device|different devices"
    else:
        raise AssertionError(case)
    return (y, u, v, g, lvl, lim, mblim, mask), exc, match


@pytest.mark.parametrize("case", [
    "strip", "lvl below 0", "lvl above 63", "negative limit", "y shape",
    "u shape", "v shape", "plane dtype", "non-contiguous plane",
    "mask shape", "float mask", "geometry", "too tall", "cpu tensors",
    "mixed devices", "mask on another device"])
def test_wrapper_refuses(case):
    """``ops.cuda_kernels.loop_filter`` raises on what the kernel does not
    take, and never counts a launch for it."""
    args, exc, match = _bad_call(case)
    before = K.loop_filter.launches
    with pytest.raises(exc, match=match):
        K.loop_filter(*args[:4], _sc(*args[4:7]), split32=args[7])
    assert K.loop_filter.launches == before


def test_dispatch_refuses_strip_geometry_on_any_device():
    """A strip geometry with a split mask: refused on any device; without
    one the CPU takes it (the plain version) and another device goes to
    the kernel's wrapper, which refuses a tensor that is not on a card."""
    g = P.make_geom(128, 112)
    for dev in ("cpu", "meta"):
        y = torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8, device=dev)
        c = torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8,
                        device=dev)
        mask = torch.ones((g.rows32, g.cols32), dtype=torch.int32,
                          device=dev)
        with pytest.raises(ValueError, match="strip"):
            P.loop_filter_device(y, c, c, g, _sc(10, 5, 20), split32=mask)
        if dev == "cpu":
            out = P.loop_filter_device(y, c, c, g, _sc(10, 5, 20))
            assert all(torch.equal(a, b) for a, b in zip(out, (y, c, c)))
        else:
            with pytest.raises(ValueError, match="device"):
                P.loop_filter_device(y, c, c, g, _sc(10, 5, 20))


def test_launcher_table_names_the_loop_filter():
    lib, sym, n_ptr, n_float, n_int = K._LAUNCHERS["loop_filter"]
    assert (lib, sym) == ("loop_filter", "loop_filter_launch")
    # y, u, v, three outputs, the mask and the step's row of scalars (the
    # level and limits); the geometry (the strip's top among it) and the
    # parts mask
    assert (n_ptr, n_float, n_int) == (8, 0, 8)
    assert K.LF_ALL_PARTS == sum(K.LF_PARTS.values())
