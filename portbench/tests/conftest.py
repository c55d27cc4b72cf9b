"""One intra-op thread a test process: the tests run under several xdist
workers, and PyTorch's default of a thread a core would make them contend
(the interactive cells' windows then hold too few frames to check).  A
traced run profiles 0.3 s of its window, so that a test's short window
also holds work after the profiled part."""

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def short_profile(monkeypatch):
    from portbench import devtrace

    monkeypatch.setattr(devtrace, "PROFILE_SECONDS", 0.3)
