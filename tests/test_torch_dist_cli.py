"""The port's CLI data-parallel on the CPU: ``--dp N`` (N local ranks
started with the spawn method, over gloo) and ``--multihost`` (ranks started
as torchrun would, joining from its environment) write the single-process
PNG byte for byte."""

import os
import socket
import subprocess
import sys

import pytest

from torch_dist_worker import start_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The 8-sphere stress scene at 32x16, 2 spp.
SCENE = ["--cpu", "--stress", "8", "--size", "32x16", "--spp", "2"]
CLI_TIMEOUT_S = 240


def cli(*args):
    res = subprocess.run([sys.executable, "-m", "paths_tpu_torch.cli", *SCENE, *args],
                         cwd=REPO, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                         env=dict(os.environ, PYTHONPATH=REPO))
    return res


def png(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    out = tmp_path_factory.mktemp("single") / "one.png"
    res = cli("-o", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    return png(out)


@pytest.mark.parametrize("dp, tile", [("2", "65536"), ("3", "100")])
def test_dp_png_matches_single_process(single, tmp_path, dp, tile):
    """--dp 3 with 100-pixel tiles: 512 pixels in tiles of 102, the last
    one padded on the third rank."""
    out = tmp_path / "dp.png"
    res = cli("--dp", dp, "--tile", tile, "-o", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    assert png(out) == single
    for r in range(int(dp)):
        assert f"[dist] rank {r} of {dp}: backend gloo, device cpu" in res.stdout
    assert res.stdout.count("rendered 32x16") == 1  # rank 0 alone prints
    assert f"on {dp} ranks" in res.stdout


def test_multihost_png_matches_single_process(single, tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "mh.png"

    def env(rank):
        return dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="localhost",
                    MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")

    outs = start_ranks(lambda r: ["-m", "paths_tpu_torch.cli", *SCENE, "--multihost",
                                  "-o", str(out)], 2, env=env)
    assert png(out) == single
    assert "on 2 ranks" in outs[0] and "rendered" not in outs[1]


@pytest.mark.parametrize("args, message", [
    (["--dp", "2", "--multihost"], "--dp is not supported with --multihost"),
    (["--dp", "0"], "at least one rank"),
])
def test_dp_refusals(args, message):
    res = cli(*args)
    assert res.returncode != 0 and message in res.stderr
