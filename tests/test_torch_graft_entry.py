"""The port's entry points, ``tpu_vp9_torch.graft_entry``, against
the JAX package's ``__graft_entry__``.

``entry()``'s function, run on the CPU on its own example arguments, gives
the JAX entry's function's outputs (jitted on CPU-JAX) bit for bit: the 32
grid's MVs, its luma levels and the new luma reference; its example
arguments are the JAX entry's planes and scalars (the scalars as the one
int32 row the port's step takes). ``dryrun_multichip(4)`` runs on the CPU
(a (2, 2) mesh of the CPU repeated, then an ``RtSession`` over a (1, 2)
mesh) and prints the JAX dry run's two lines. Without a card, both refuse
to run unless the CPU is asked for.
"""

import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as JG

from tpu_vp9_torch import graft_entry as G
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def entries():
    jfn, jargs = JG.entry()
    pfn, pargs = G.entry("cpu")
    return (jfn, jargs), (pfn, pargs)


def test_example_args_are_the_jax_entry_args(entries):
    """The same planes, references and previous MVs; the JAX entry's six
    device scalars are the port's row of scalars."""
    (_, jargs), (_, pargs) = entries
    assert len(pargs) == len(jargs) - 5
    for got, want in zip(pargs[:8], jargs[:8]):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = pargs[8]
    assert row.dtype == torch.int32
    assert row.tolist() == [int(v) for v in jargs[8:]]
    assert row.tolist()[P.SC_LAM] == G.LAM


def test_entry_fn_matches_jax_entry_fn(entries):
    """mv, lv_y and the new luma reference, bit for bit."""
    (jfn, jargs), (pfn, pargs) = entries
    want = jax.jit(jfn)(*jargs)
    got = pfn(*pargs)
    assert len(got) == len(want) == 3
    for name, g, w in zip(("mv", "lv_y", "ref_y"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_dryrun_multichip_on_the_cpu(capsys):
    """The sharded step over a (2, 2) mesh of the CPU, then the session
    over a (1, 2) mesh: the JAX dry run's two lines."""
    G.dryrun_multichip(4, "cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert re.fullmatch(
        r"dryrun_multichip OK: mesh=\(2, 2\) pframe_step_sharded "
        r"mv=\(2, 32, 2\) lv_y=\(2, 32, 32, 32\) refs=\(2, 128, 256\) "
        r"rate=\d+ dist=\d+", lines[0]), lines[0]
    assert re.fullmatch(
        r"dryrun_multichip OK: RtSession mesh=\(1,2\) serialized 3 frames "
        r"\(\d+ bytes\)", lines[1]), lines[1]


def test_entries_refuse_a_machine_without_a_card(monkeypatch):
    """The card is the default; without one the entries raise rather than
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.dryrun_multichip(2)
