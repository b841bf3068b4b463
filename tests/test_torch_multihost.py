"""The port's multi-process launcher (hdrf_tpu_torch.parallel.launch) on
the CPU: two processes join a gloo process group over tcp on localhost,
build the global mesh over both ranks' devices, run ``reduce_sharded`` on
the same seeded block and check it against the native oracle, each
printing ``oracle_match=True``."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_data", [1, 2])
def test_two_process_gloo_selftest(n_data):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hdrf_tpu_torch.parallel.launch",
         "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
         "--rank", str(rank), "--n-data", str(n_data), "--selftest", "1",
         "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=100)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, out + err
        assert f"rank {rank}/2: devices=2" in out, out
        assert f"mesh={n_data}x{2 // n_data}" in out, out
        assert "oracle_match=True" in out, out


def test_launch_alone_defaults_to_the_card():
    """Without --device cpu the launcher wants a card: with none it exits
    non-zero instead of using the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m",
                        "hdrf_tpu_torch.parallel.launch", "--selftest", "1"],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=100)
    assert r.returncode != 0 and "oracle_match" not in r.stdout
    assert "no CUDA device" in r.stderr
