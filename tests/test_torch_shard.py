"""The port's tile-column sharded P-frame step against the JAX package's.

``tpu_vp9_torch.pipeline.tpu_shard`` on the CPU (a mesh of the CPU device
repeated) against ``tpu_vp9.pipeline.tpu_shard`` on the tests' virtual CPU
devices, on the inputs of ``tests/test_multichip_encdec.py`` (smooth
planes, the reference the source shifted), bit for bit: levels, MVs,
eobs, the reference choice, the gathered recon, the filtered references,
distortion and rate, for meshes (1, 4), (2, 2) and (1, 1) at 256x128, with
GOLDEN and the rate tables, and at the strip geometry 256x80. The halo
exchange is held against the columns of a border-extended numpy plane.
Each JAX step is built once per module.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tpu_vp9.pipeline import tpu_shard as JS

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops.loopfilter import pick_filter_level, sharpness_limits
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.pipeline import tpu_shard as S

torch.set_num_threads(1)

QIDX = 120
KEYS = P.ZONE_KEYS


@pytest.mark.parametrize("n,wl,halo", [(4, 64, 16), (4, 16, 40), (1, 48, 96),
                                       (3, 24, 24)],
                         ids=["wide", "narrow", "one", "equal"])
def test_halo_exchange_gives_the_border_extended_columns(n, wl, halo):
    plane = np.random.default_rng(n + wl).integers(0, 256, (8, n * wl),
                                                   dtype=np.uint8)
    ext = np.pad(plane, ((0, 0), (halo, halo)), mode="edge")
    got = S._halo_exchange([torch.from_numpy(plane[:, t * wl:(t + 1) * wl])
                            for t in range(n)], halo)
    assert len(got) == n
    for t, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(),
                                      ext[:, t * wl:t * wl + wl + 2 * halo])


def _smooth(hh, ww, seed):
    r = np.random.default_rng(seed)
    base = r.integers(40, 200, (hh // 8, ww // 8)).astype(np.float32)
    up = np.kron(base, np.ones((8, 8), np.float32))
    return np.clip(up + r.normal(0, 2, (hh, ww)), 0, 255).astype(np.uint8)


def _inputs(g, n_frames, golden):
    """(src, ref, gold) lists of F frames of (y, u, v) padded planes, the
    previous MVs (F, B32, 2) and the strip's (F, cols16, 2), frame f's
    content rolled by f columns; the reference is the source shifted
    (motion to find), GOLDEN the source itself (blocks that take it)."""
    h, w = g.height, g.width
    rng = np.random.default_rng(11)
    base = (P.pad_plane(_smooth(h, w, 1), g.pad_h, g.pad_w),
            P.pad_plane(_smooth(h // 2, w // 2, 2), g.pad_h // 2,
                        g.pad_w // 2),
            P.pad_plane(_smooth(h // 2, w // 2, 3), g.pad_h // 2,
                        g.pad_w // 2))
    src = [tuple(np.roll(p, f * (2 - (i > 0)), axis=1)
                 for i, p in enumerate(base)) for f in range(n_frames)]
    ref = [(np.roll(s[0], 5, axis=1), np.roll(s[1], 2, axis=1),
            np.roll(s[2], 2, axis=1)) for s in src]
    gold = [tuple(p.copy() for p in s) for s in src] \
        if golden else None
    pm = rng.integers(-200, 200, (n_frames, g.n_blocks32, 2)).astype(
        np.int32)
    pm16 = rng.integers(-200, 200, (n_frames, g.cols16, 2)).astype(np.int32)
    return src, ref, gold, pm, pm16


def _scalars():
    lf = pick_filter_level(QIDX, False)
    lim_t, mblim_t = sharpness_limits(0)
    return (T.dc_quant(QIDX), T.ac_quant(QIDX), 100, lf, int(lim_t[lf]),
            int(mblim_t[lf]))


@functools.lru_cache(maxsize=None)
def _jax_step(w, h, n_frame, n_tile, golden):
    import tpu_vp9.pipeline.tpu_encdec as J

    devs = np.asarray(jax.devices()[:n_frame * n_tile])
    if devs.size < n_frame * n_tile:
        pytest.skip("not enough virtual devices")
    mesh = Mesh(devs.reshape(n_frame, n_tile), ("frame", "tile"))
    return mesh, JS.make_pframe_step_sharded(J.make_geom(w, h), mesh, n_tile,
                                             golden=golden)


def _run_jax(w, h, n_frame, n_tile, golden, inputs):
    mesh, step = _jax_step(w, h, n_frame, n_tile, golden)
    src, ref, gold, pm, pm16 = inputs
    shp = NamedSharding(mesh, PartitionSpec("frame", None, "tile"))
    shb = NamedSharding(mesh, PartitionSpec("frame", "tile"))

    def planes(frames, i):
        return jax.device_put(np.stack([f[i] for f in frames]), shp)

    g = P.make_geom(w, h)
    pm16_j = pm16 if g.strip else np.zeros((n_frame, n_tile, 2), np.int32)
    args = [planes(src, i) for i in range(3)] + \
        [planes(ref, i) for i in range(3)] + \
        [jax.device_put(pm, shb), jax.device_put(pm16_j, shb)] + \
        [jnp.asarray(v, jnp.int32) for v in _scalars()]
    if golden:
        t = P.make_rate_tabs(T.default_frame_context(), QIDX)
        args += [planes(gold, i) for i in range(3)]
        args += [jnp.asarray(t[k]) for k in ("mode_cost", "joint_cost",
                                            "nmv_row", "nmv_col",
                                            "ref_cost", "lam_bits")]
    outs, refs = step(*args)
    return ({k: np.asarray(v) for k, v in outs.items()},
            [np.asarray(r) for r in refs])


def _run_port(w, h, n_frame, n_tile, golden, inputs):
    g = P.make_geom(w, h)
    mesh = [[torch.device("cpu")] * n_tile for _ in range(n_frame)]
    step = S.make_pframe_step_sharded(g, mesh, n_tile, golden=golden)
    src, ref, gold, pm, pm16 = inputs

    def planes(frames, i):
        return torch.from_numpy(np.stack([f[i] for f in frames]))

    args = [planes(src, i) for i in range(3)] + \
        [planes(ref, i) for i in range(3)] + \
        [torch.from_numpy(pm), torch.from_numpy(pm16),
         P.step_scalars(*_scalars())]
    if golden:
        args += [planes(gold, i) for i in range(3)]
        args.append(P.upload_rate_tabs(
            P.make_rate_tabs(T.default_frame_context(), QIDX), "cpu"))
    outs, refs = step(*args)
    return ({k: v.numpy() for k, v in outs.items()},
            [r.numpy() for r in refs])


def _same(w, h, n_frame, n_tile, golden):
    g = P.make_geom(w, h)
    inputs = _inputs(g, n_frame, golden)
    want, want_refs = _run_jax(w, h, n_frame, n_tile, golden, inputs)
    got, got_refs = _run_port(w, h, n_frame, n_tile, golden, inputs)
    keys = KEYS + (tuple(f"m16_{k}" for k in KEYS) if g.strip else ())
    for k in keys + ("rec_y", "rec_u", "rec_v"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("dist", "rate"):
        np.testing.assert_array_equal(got[k], want[k].astype(np.int64),
                                      err_msg=k)
    for a, b in zip(got_refs, want_refs):
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("n_frame,n_tile", [(1, 4), (2, 2), (1, 1)])
def test_sharded_step_matches_jax(n_frame, n_tile):
    got = _same(256, 128, n_frame, n_tile, False)
    assert (got["mv"] != 0).any() and (got["skip"] == 0).any()


@pytest.mark.parametrize("n_frame,n_tile", [(1, 4), (2, 2)])
def test_sharded_golden_step_matches_jax(n_frame, n_tile):
    got = _same(256, 128, n_frame, n_tile, True)
    assert (got["ref"] == 1).any() and (got["ref"] == 0).any()


@pytest.mark.parametrize("n_tile", [2, 4])
def test_sharded_strip_step_matches_jax(n_tile):
    got = _same(256, 80, 1, n_tile, n_tile == 2)
    assert got["m16_mv"].shape == (1, 16, 2)


def test_sharded_step_equals_the_single_device_step():
    """The shards' outputs, put back in raster order, are the single-device
    step's, GOLDEN and the strip included (the property the card's check
    rests on)."""
    g = P.make_geom(256, 80)
    src, ref, gold, pm, pm16 = _inputs(g, 1, True)

    def ext(planes):
        cw, ch = g.width // 2, (g.height + 1) // 2
        return tuple(P.extend_borders_device(torch.from_numpy(p), *c)
                     for p, c in zip(planes, ((g.width, g.height), (cw, ch),
                                              (cw, ch))))

    rates = P.upload_rate_tabs(
        P.make_rate_tabs(T.default_frame_context(), QIDX), "cpu")
    single = P.make_pframe_step(g, "cpu", golden=True)
    sharded = S.make_rt_step_sharded(g, (1, 4), "cpu", golden=True)
    args = (*ext(ref[0]), *ext(gold[0]), torch.from_numpy(pm[0]),
            torch.from_numpy(pm16[0]), P.step_scalars(*_scalars()), rates)
    src_t = tuple(torch.from_numpy(p) for p in src[0])
    want, want_refs = single(*src_t, *args)
    got, got_refs = sharded(*src_t, *args)
    for zone in ("m32", "m16"):
        for k in KEYS:
            assert torch.equal(got[zone][k], want[zone][k]), (zone, k)
    assert int(got["m32"]["dist"]) == int(want["m32"]["dist"]
                                          + want["m16"]["dist"])
    for k in ("rec_y", "rec_u", "rec_v"):
        assert torch.equal(got[k], want[k])
    for a, b in zip(got_refs, want_refs):
        assert torch.equal(a, b)


def test_sharded_step_refuses_what_the_jax_step_refuses():
    with pytest.raises(ValueError, match="cols32 must divide"):
        S.make_pframe_step_sharded(P.make_geom(160, 96), [["cpu"] * 2], 2)
    with pytest.raises(ValueError, match="width % 64"):
        S.make_pframe_step_sharded(P.make_geom(224, 96), [["cpu"] * 7], 7)
    with pytest.raises(ValueError, match="split16"):
        S.make_rt_step_sharded(P.make_geom(256, 128), (1, 2), "cpu",
                               split16=True)


def test_too_few_cards_raise_as_in_the_jax_package(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="mesh requests 4 devices, 2 "
                                         "available"):
        S.make_rt_step_sharded(P.make_geom(256, 128), (2, 2), "cuda")
    assert S.mesh_devices(2, "cuda") == [torch.device("cuda", 0),
                                         torch.device("cuda", 1)]
