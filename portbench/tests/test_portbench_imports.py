"""No module of JAX or of the JAX package is loaded by a run, compared by
whole top-level name, and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from portbench import harness

ROOT = os.path.dirname(harness.BENCH_DIR)


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules({"paths_tpu_torch": 1, "paths_tpu_torch.render": 1,
                                      "numpy": 1, "jaxtyping": 1}) == []
    assert harness.forbidden_modules({"paths_tpu": 1, "jax.numpy": 1, "flax": 1,
                                      "jaxlib.xla": 1}) == ["flax", "jax.numpy",
                                                             "jaxlib.xla", "paths_tpu"]


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from portbench import harness\n"
        "from portbench.tests import small\n"
        "r = small.run(small.small_stress(), {'kind': 'render', 'spp': 2, 'tile_pixels': 512,"
        " 'warmup_spp': 1}, {'rel_mse': 1e-4, 'parted_pct': 0.5}, seconds=0.2)\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules(),"
        " 'paths_tpu_torch' in sys.modules]))\n")
    correct, bad, port = json.loads(_python(code))
    assert correct and bad == [] and port


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "import portbench.reference.trace, portbench.reference.progressive\n"
        "import portbench.reference.precision, portbench.reference.scene\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('paths_tpu_torch', 'paths_tpu', 'jax')))\n")
    assert _python(code) == "[]"
