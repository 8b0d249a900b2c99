"""The step's per-frame scalars as one int32 device row
(``tpu_encdec.step_scalars``) and the buffers the sessions hold.

The row's words in ``cuda_kernels.STEP_SCALARS``' order, the order of
``csrc/step_scalars.cuh``, which the kernels read; the helper's refusals
while the values are host ints (a quantizer past ``TXFM_MAX_Q`` or below
1, a lambda past ``KF_MAX_LAM`` or below 0, a filter level past 63 or
below 0, a negative limit); a refill in place keeps the row's tensor and
the rate tables' tensors, only their values change; the sessions hold one
row (and one set of rate tables) for their life, refilled before each
frame; and a step run on a refilled row gives what it gives on a new row.
"""

import os
import re

import numpy as np
import pytest
import torch

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.pipeline.realtime import RtSession
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_row_is_the_headers_order():
    """STEP_SCALARS, the SC_* indices and csrc/step_scalars.cuh name the
    same words in the same order."""
    with open(os.path.join(REPO, "tpu_vp9_torch", "csrc",
                           "step_scalars.cuh")) as fh:
        src = fh.read()
    words = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int k(\w+) = (\d+);", src)}
    names = {"DcQ": "dc_q", "AcQ": "ac_q", "Lam": "lam", "LfLvl": "lf_lvl",
             "LfLim": "lf_lim", "LfMblim": "lf_mblim"}
    assert words.pop("Words") == len(K.STEP_SCALARS)
    assert {names[k]: v for k, v in words.items()} == {
        n: i for i, n in enumerate(K.STEP_SCALARS)}
    assert (P.SC_DC_Q, P.SC_AC_Q, P.SC_LAM, P.SC_LF_LVL, P.SC_LF_LIM,
            P.SC_LF_MBLIM) == tuple(range(len(K.STEP_SCALARS)))
    row = P.step_scalars(40, 48, 100, 20, 7, 50)
    assert row.dtype == torch.int32 and row.tolist() == [40, 48, 100, 20,
                                                          7, 50]


@pytest.mark.parametrize("values,match", [
    ((K.TXFM_MAX_Q + 1, 48, 100, 20, 7, 50), "quantizers"),
    ((40, K.TXFM_MAX_Q + 1, 100, 20, 7, 50), "quantizers"),
    ((0, 48, 100, 20, 7, 50), "quantizers"),
    ((40, 48, K.KF_MAX_LAM, 20, 7, 50), "lam="),
    ((40, 48, -1, 20, 7, 50), "lam="),
    ((40, 48, 100, 64, 7, 50), r"lvl=64 outside \[0, 63\]"),
    ((40, 48, 100, -1, 7, 50), r"lvl=-1 outside \[0, 63\]"),
    ((40, 48, 100, 20, -1, 50), "negative limits"),
], ids=["dc_q past max", "ac_q past max", "dc_q 0", "lam past max",
        "lam negative", "level 64", "level -1", "negative limit"])
def test_the_helper_refuses_what_the_kernels_do_not_take(values, match):
    """Refused while the values are host ints: nothing downstream reads
    the row back to check it; a held row is left as it was."""
    row = P.step_scalars(40, 48, 100, 20, 7, 50)
    with pytest.raises(ValueError, match=match):
        P.step_scalars(*values, out=row)
    assert row.tolist() == [40, 48, 100, 20, 7, 50]
    at_max = P.step_scalars(K.TXFM_MAX_Q, 1, K.KF_MAX_LAM - 1, 63, 0, 0)
    assert at_max.tolist() == [K.TXFM_MAX_Q, 1, K.KF_MAX_LAM - 1, 63, 0, 0]


def test_refills_keep_the_tensors():
    """A refill writes the held row and rate tables in place: the same
    tensors (the kernels' pointers), new values; the tables' host numbers
    follow."""
    row = P.step_scalars(40, 48, 100, 20, 7, 50)
    ptr = row.data_ptr()
    assert P.step_scalars(60, 70, 80, 9, 3, 11, out=row) is row
    assert row.data_ptr() == ptr and row.tolist() == [60, 70, 80, 9, 3, 11]
    fc = T.default_frame_context()
    rates = P.upload_rate_tabs(P.make_rate_tabs(fc, 60), "cpu")
    held = {k: rates[k] for k in P.RATE_TENSORS}
    tabs = P.make_rate_tabs(fc, 200)
    again = P.upload_rate_tabs(tabs, "cpu", out=rates)
    fresh = P.upload_rate_tabs(tabs, "cpu")
    assert again is rates
    for k in P.RATE_TENSORS:
        assert rates[k] is held[k] and torch.equal(rates[k], fresh[k]), k
    for k in ("mode_cost", "ref_cost", "lam_bits", "mv_cost_max"):
        assert rates[k] == fresh[k], k


def test_sessions_hold_one_row_refilled_every_frame():
    """RtSession's row (keyframes' and P-frames') and rate tables are the
    same tensors over a stream whose qindex changes every frame, each
    frame's values written before its step."""
    w, h = 128, 96
    sess = RtSession(w, h, device="cpu", split16=True, golden=True)
    row = sess._sc
    seen, tables = [], []
    real = sess._step

    def step(*args):
        seen.append((args[-2] if sess.golden else args[-1]).tolist())
        tables.append(args[-1]["scalars"])
        return real(*args)

    sess._step = step
    qs = (60, 120, 200, 90)
    for f, q in zip(synthetic_frames(w, h, len(qs), seed=3), qs):
        sess.send(f, qindex=q)
    sess.flush()
    sess.close()
    assert sess._sc is row
    assert all(t is tables[0] for t in tables)
    for vals, q in zip(seen, qs[1:]):
        ac_q = T.ac_quant(q)
        assert vals[:3] == [T.dc_quant(q), ac_q, max(1, (ac_q ** 2) >> 6)]


def test_a_step_on_a_refilled_row_gives_a_new_rows_outputs():
    """The P-frame step on a row refilled from another qindex's values
    equals the step on a row made for the new one."""
    g = P.make_geom(128, 96)
    rng = np.random.default_rng(5)
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    src = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
           for s in shapes]
    refs = P.extend_borders(
        tuple(torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
              for s in shapes), P.recon_crops(g))
    prev = (torch.zeros((g.n_blocks32, 2), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32))
    step = P.make_pframe_step(g, "cpu")
    held = P.step_scalars(T.dc_quant(60), T.ac_quant(60), 100, 20, 7, 50)
    step(*src, *refs, *prev, held)
    args = (T.dc_quant(200), T.ac_quant(200), 900, 40, 5, 30)
    P.step_scalars(*args, out=held)
    got, got_refs = step(*src, *refs, *prev, held)
    want, want_refs = step(*src, *refs, *prev, P.step_scalars(*args))
    for k in ("mv", "lv_y", "eob_y", "skip"):
        assert torch.equal(got["m32"][k], want["m32"][k]), k
    for a, b in zip(got_refs, want_refs):
        assert torch.equal(a, b)
