"""The port's native libraries as ``paths_tpu_torch/native.py`` declares,
builds and calls them, on the CPU: every CUDA entry point of ``csrc/``
declared once with its source's arity (a text read, no compiler),
``build_all`` building exactly the declared libraries, and ``launch``'s one
path -- arguments converted, the stream appended, a CUDA error raised
under the launch's key, a launch counted in ``profiling.LAUNCHES`` -- on a
stub entry point, so that no card is needed.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from paths_tpu_torch import native
from paths_tpu_torch import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA_SOURCES = sorted(p.name for p in native.CSRC.glob("*.cu"))


def _entry_points(source: str) -> dict:
    """{name: arity} of the ``extern "C"`` functions of csrc/<source>."""
    text = (native.CSRC / source).read_text()
    found = re.findall(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', text)
    return {name: len(args.split(",")) for name, args in found}


@pytest.mark.parametrize("source", CUDA_SOURCES)
def test_each_cuda_entry_point_is_declared_once_with_its_arity(source):
    entries = _entry_points(source)
    assert entries, f"no extern \"C\" entry point found in {source}"
    declared = native.LIBRARIES[source].entries
    assert set(declared) == set(entries)
    for name, arity in entries.items():
        e = declared[name]
        assert len(e.argtypes) == arity, name
        assert e.restype is ctypes.c_int and e.argtypes[-1] is ctypes.c_void_p, name
        assert e.keys and set(e.keys) <= set(P.LAUNCHES), name
        owners = [s for s, lib in native.LIBRARIES.items() if name in lib.entries]
        assert owners == [source], name
    keys = [k for lib in native.LIBRARIES.values() for e in lib.entries.values()
            for k in e.keys]
    assert len(keys) == len(set(keys)) == len(P.LAUNCHES)


def test_build_all_builds_exactly_the_declared_libraries():
    """build_all, run in a fresh process with the build stubbed: one job for
    each declared library and no other, verbose passed on, and no ops
    module imported."""
    code = """
import json, sys
from paths_tpu_torch import native
built = []
native.library = lambda source, verbose=False: built.append((source, verbose))
secs = native.build_all(verbose=True)
print(json.dumps([sorted(secs), sorted(built), sorted(native.LIBRARIES),
                  sorted(m for m in sys.modules if m.startswith("paths_tpu_torch.ops"))]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    secs, built, declared, ops = json.loads(res.stdout.strip().splitlines()[-1])
    assert secs == declared == sorted(s for s, _ in built)
    assert set(declared) >= set(CUDA_SOURCES) | {"bvh_builder.cc", "mesh_io.cc",
                                                  "cpu_tracer.cc"}
    assert all(verbose for _, verbose in built) and ops == []


@pytest.mark.parametrize("err", [0, 700])
def test_launch_converts_appends_the_stream_raises_and_counts(monkeypatch, err):
    """A stub entry point in place of the card's: tensors reach it as their
    data_ptr(), None as a null pointer, integers as themselves and the
    current stream last; a non-zero cudaError_t raises under the launch's
    key and is not counted, a zero one counts one launch under it."""
    calls = []

    def entry(*args):
        calls.append(args)
        return err

    monkeypatch.setattr(native, "_calls", {})
    monkeypatch.setattr(native, "library",
                        lambda source, verbose=False: types.SimpleNamespace(
                            lane_shading_uniform=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=4321))
    monkeypatch.setattr(P, "LAUNCHES", dict(P.LAUNCHES))
    before = dict(P.LAUNCHES)
    pix, sid, out = torch.arange(8), torch.arange(8), torch.empty(8)
    args = (5, None, pix, sid, None, 3, 1, 8, out)
    if err:
        with pytest.raises(RuntimeError, match="rng_uniform launch failed: cudaError_t 700"):
            native.launch("lane_shading_uniform", "rng_uniform", torch.device("cpu"), *args)
        assert P.LAUNCHES == before
    else:
        with P.launch_log() as log:
            native.launch("lane_shading_uniform", "rng_uniform", torch.device("cpu"), *args)
        assert P.LAUNCHES == {**before, "rng_uniform": before["rng_uniform"] + 1}
        assert log == ["rng_uniform"]
    assert calls == [(5, None, pix.data_ptr(), sid.data_ptr(), None, 3, 1, 8,
                      out.data_ptr(), 4321)]
