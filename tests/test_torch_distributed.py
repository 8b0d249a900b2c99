"""Multi-host GOP-parallel encoding in the port (``torch.distributed``,
gloo), on one machine.

  - two processes join a gloo group at a rendezvous on 127.0.0.1, each
    encodes its chunks (round-robin by rank) on device="cpu", and each
    returns the whole packet list, equal to the sequential encode; each
    process is joined with a timeout and a hang fails the test;
  - the packets equal the JAX package's chunked encode on the host
    random-access route (96x80, enc_mode 8, ``tpu_realtime=0``, intra
    period 7, 20 frames);
  - a group that the caller initialized is used as it is, and left up;
  - the CLI: ``-distributed`` with two processes writes the sequential
    bytes in each; a malformed ``-distributed`` exits 1, as JAX's does.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from tpu_vp9 import config as jax_config
from tpu_vp9.pipeline.gop_parallel import encode_gop_parallel as jax_gop

from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.pipeline.distributed import encode_gop_distributed
from tpu_vp9_torch.utils.yuv import synthetic_frames, write_y4m

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds for each process to finish


def _cfg(config):
    return config.EncoderConfig(
        source_width=96, source_height=80, frame_rate=30, qp=45,
        enc_mode=8, intra_period=7, tpu_realtime=0).derive()


def _frames(n=20):
    return list(synthetic_frames(96, 80, n, seed=4, motion=True))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join_all(procs):
    """Wait for every process, at most TIMEOUT seconds each; kill them all
    and fail on a hang."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a process did not finish within {TIMEOUT} s")
    return outs


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


_RANK = textwrap.dedent("""
    import pickle, sys
    from tpu_vp9_torch.config import EncoderConfig
    from tpu_vp9_torch.pipeline.distributed import encode_gop_distributed
    from tpu_vp9_torch.utils.yuv import synthetic_frames

    port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cfg = EncoderConfig(source_width=96, source_height=80, frame_rate=30,
                        qp=45, enc_mode=8, intra_period=7,
                        tpu_realtime=0).derive()
    frames = list(synthetic_frames(96, 80, 20, seed=4, motion=True))
    reports = []
    pkts = encode_gop_distributed(
        frames, cfg, coordinator=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank, device="cpu", reports=reports)
    import torch.distributed as dist
    assert not dist.is_initialized()
    with open(out, "wb") as fh:
        pickle.dump((pkts, [r["start"] for r in reports]), fh)
""")


def test_two_processes_equal_sequential_and_jax(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"rank{r}.pkl" for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(port), str(r), str(outs[r])],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    for p, (_, err) in zip(procs, _join_all(procs)):
        assert p.returncode == 0, err[-2000:]
    got = [pickle.loads(o.read_bytes()) for o in outs]
    # chunks 0 and 2 on rank 0, chunk 1 on rank 1
    assert [starts for _, starts in got] == [[0, 16], [8]]
    seq = jax_gop(_frames(), _cfg(jax_config), workers=1)
    for pkts, _ in got:
        assert pkts == [tuple(p) for p in seq]
    assert [p[1] for p in got[0][0]] == list(range(20))


def test_an_initialized_group_is_used_and_left_up():
    """A one-process group that the caller made: the encode runs every
    chunk in this process and leaves the group initialized."""
    from tpu_vp9_torch.pipeline.gop_parallel import encode_gop_parallel

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        frames = _frames(10)
        cfg = _cfg(port_config)
        reports = []
        pkts = encode_gop_distributed(frames, cfg, device="cpu",
                                      reports=reports)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert [r["start"] for r in reports] == [0, 8]
    assert pkts == encode_gop_parallel(frames, cfg, workers=1, device="cpu")


def test_cli_distributed_writes_the_sequential_bytes(tmp_path):
    clip = tmp_path / "clip.y4m"
    with open(clip, "wb") as fh:
        write_y4m(fh, _frames(10))
    base = [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip),
            "-q", "45", "-enc-mode", "8", "-intra-period", "7", "-rt", "0",
            "-device", "cpu"]
    port = _free_port()
    procs = [subprocess.Popen(
        base + ["-b", str(tmp_path / f"d{r}.ivf"), "-distributed",
                f"127.0.0.1:{port},2,{r}"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    procs.append(subprocess.Popen(
        base + ["-b", str(tmp_path / "seq.ivf")], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for r, (p, (out, err)) in enumerate(zip(procs, _join_all(procs))):
        assert p.returncode == 0, err[-2000:]
        if r < 2:
            assert f"distributed {r + 1}/2" in out
    seq = (tmp_path / "seq.ivf").read_bytes()
    for r in (0, 1):
        assert (tmp_path / f"d{r}.ivf").read_bytes() == seq


@pytest.mark.parametrize("flags,why", [
    (["-distributed", "127.0.0.1:1234"], "coordinator:port,n,i"),
    (["-distributed", "127.0.0.1:1234,2,x"], "coordinator:port,n,i"),
    (["-distributed", "127.0.0.1:1234,2,0", "-rc", "1"], "requires CQP"),
], ids=["no_counts", "bad_rank", "vbr"])
def test_cli_malformed_distributed_exits_1(tmp_path, flags, why):
    clip = tmp_path / "clip.y4m"
    with open(clip, "wb") as fh:
        write_y4m(fh, _frames(2))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip),
         "-intra-period", "7", "-device", "cpu", *flags],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 1
    assert why in res.stderr
