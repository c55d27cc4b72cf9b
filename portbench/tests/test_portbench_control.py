"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the float32 the configurations state, fails
each cell's check.  On the CPU at a test's size; on a card (marked
``cuda``) at the cell's own size on three seeds."""

import tempfile

import pytest
import torch

from portbench import harness
from portbench.tests.test_portbench_run import BENCH, small_cell

CELLS = [c["name"] for c in BENCH["workloads"]]


def fails(values: dict, limits: dict) -> bool:
    return any(not (v <= limits[k]) for k, v in values.items())


def _ctx(name, config, mix, seed, device):
    cell = {c["name"]: c for c in BENCH["workloads"]}[name]
    return harness.Ctx(device=device, config_name=cell["config"], config=config, mix=mix,
                       seed=seed)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name):
    with tempfile.TemporaryDirectory() as d:
        cfg, mix, limits = small_cell(name, d)
        ctx = _ctx(name, cfg, mix, 2**35 + 11, torch.device("cpu"))
        kind = harness.load_kind(mix["kind"])
        assert fails(kind.control(ctx, "bf16"), limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2**33 + 1, 2**33 + 2, 2**33 + 3])
def test_control_fails_at_cell_size(name, seed, card):
    cell = {c["name"]: c for c in BENCH["workloads"]}[name]
    ctx = _ctx(name, harness.load_config(cell["config"]), harness.load_mix(cell["traffic"]),
               seed, card)
    kind = harness.load_kind(ctx.mix["kind"])
    assert fails(kind.control(ctx, "bf16"), harness.load_limits(name))
