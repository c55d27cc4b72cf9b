"""The port stands alone: paths_tpu_torch and chip_smoke.py import neither
JAX nor anything of the reference package paths_tpu (not even its jax-free
modules), and loading a scene needs no YAML package."""

import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paths_tpu_torch")

# `paths_tpu_torch` starts with `paths_tpu`: match the reference package
# only when the name is not followed by `_torch`.
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|paths_tpu(?!_torch))\b"
    r"|from\s+(jax|paths_tpu(?!_torch))[\s.])",
    re.M,
)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if not rel.startswith("paths_tpu_torch"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return mods


# Modules the checks must cover (the walk below finds every module; this
# list guards against the walk silently missing a path's modules).
_EXPECTED = {
    "paths_tpu_torch.native", "paths_tpu_torch.bvh.build",
    "paths_tpu_torch.geom.triangle", "paths_tpu_torch.ops.tri_traverse",
    "paths_tpu_torch.ops.sphere_traverse", "paths_tpu_torch.ops.chunk_scan",
    "paths_tpu_torch.scene.models",
    "paths_tpu_torch.scene.obj_loader", "paths_tpu_torch.scene.ply_loader",
    "paths_tpu_torch.scene.yaml_loader", "paths_tpu_torch.scene.build",
    "paths_tpu_torch.integrator", "paths_tpu_torch.ops.packet_traverse",
    "paths_tpu_torch.sky", "paths_tpu_torch.scene.hdr_loader",
    "paths_tpu_torch.grad", "paths_tpu_torch.checkpoint",
    "paths_tpu_torch.progressive", "paths_tpu_torch.viewer",
    "paths_tpu_torch.debug", "paths_tpu_torch.dist", "paths_tpu_torch.profiling",
}


def test_no_forbidden_import_lines():
    files = _port_files()
    assert len(files) > 25
    assert _EXPECTED <= set(_port_modules())
    for path in files:
        with open(path) as f:
            src = f.read()
        m = _FORBIDDEN.search(src)
        assert m is None, f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'paths_tpu' or m.startswith('paths_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_loading_a_mesh_scene_needs_no_yaml_package():
    """The YAML loader has its own parser: a mesh scene loads and builds with
    the yaml module made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "from paths_tpu_torch.scene.yaml_loader import load_scene_description\n"
        "sd = load_scene_description('scenes/doom_standin.yml')\n"
        "assert sd.objects[0].mesh.model == 'doom', sd\n"
        "print(sd.models)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
