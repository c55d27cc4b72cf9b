"""Each cell's check catches the faults its timed path can have: the run
is driven on the CPU at a small size (the harness's look for a card
skipped) with the program broken underneath, and ``correct`` comes out
false under the cell's own limits.

- a step that returns its state unchanged (``integrator.path_step``, and
  the gradient mix's update);
- half of the batch left out, the mean taken over the rest (half of a
  wave's samples, or half of a gradient tile's lanes, also in the
  window's steps alone);
- an answer altered where it is produced (a wave's radiance handed to the
  neighbouring lane).
The cells run on one card: there is no exchange between cards to leave
out."""

import tempfile

import pytest
import torch

from portbench.tests import small
from portbench.tests.test_portbench_run import small_cell


def unchanged_step(static, scene, bounce, state, u):
    return state


def _half_samples(orig):
    def call(static, scene, cam, px, py, pid, start, n, seed):
        k = max(n // 2, 1)
        return orig(static, scene, cam, px, py, pid, start, k, seed) * (n / k)
    return call


def _shifted(orig):
    def call(*args):
        return torch.roll(orig(*args), 1, 0)
    return call


def _half_lanes(orig):
    def call(static, scene, cam, px, py, pid, sid, seed, target):
        k = px.shape[0] // 2
        return orig(static, scene, cam, px[:k], py[:k], pid[:k], sid[:k], seed, target[:k])
    return call


def _half_lanes_after_setup(orig):
    """Half of each tile's lanes left out in the window's steps only, past
    the three steps that set-up drives."""
    calls = [0]
    half = _half_lanes(orig)

    def call(*args):
        calls[0] += 1
        return (half if calls[0] > 3 else orig)(*args)
    return call


def _no_update(orig):
    def call(*args):
        loss, g = orig(*args)
        return loss, {f: torch.zeros_like(v) if torch.is_tensor(v) else v for f, v in g.items()}
    return call




def _patch_wave(mp, module, make):
    import importlib

    mod = importlib.import_module(module)
    mp.setattr(mod, "render_samples", make(mod.render_samples))


CASES = [
    ("stress500.render", "state_unchanged"), ("stress500.render", "half_batch"),
    ("stress500.render", "answer_altered"),
    ("doom.render", "state_unchanged"), ("doom.render", "half_batch"),
    ("doom.render", "answer_altered"),
    ("stress500.interactive", "state_unchanged"), ("stress500.interactive", "half_batch"),
    ("stress500.interactive", "answer_altered"),
    ("doom.grad", "state_unchanged"), ("doom.grad", "half_batch"),
    ("doom.grad", "half_batch_in_window"),
]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault, monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        cfg, mix, limits = small_cell(name, d)
        kind = mix["kind"]
        wave_module = ("paths_tpu_torch.progressive" if kind == "interactive"
                       else "paths_tpu_torch.render")
        if kind == "grad":
            import paths_tpu_torch.grad as G

            make = {"state_unchanged": _no_update, "half_batch": _half_lanes,
                    "half_batch_in_window": _half_lanes_after_setup}[fault]
            monkeypatch.setattr(G, "loss_and_grad", make(G.loss_and_grad))
        elif fault == "state_unchanged":
            monkeypatch.setattr("paths_tpu_torch.integrator.path_step", unchanged_step)
        elif fault == "half_batch":
            if kind == "interactive":
                mix = dict(mix, samples_per_pump=2)
            _patch_wave(monkeypatch, wave_module, _half_samples)
        else:
            _patch_wave(monkeypatch, wave_module, _shifted)
        # The interactive check holds the frame with the most full waves: the
        # window must reach past the first preview.
        r = small.run(cfg, mix, limits, seconds=4.0 if kind == "interactive" else 0.6)
    assert not r["correct"], (r["attempted"], r["compared"])
