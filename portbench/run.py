"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` beside this
folder; its configuration, traffic mix and per-layer metrics are files of
``portbench/`` found by name (``harness.py``).  The run needs a CUDA card and
fails without one.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``compared``: each number the
check compared, beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_env(root: str) -> dict:
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds (the program's own native builds go to
    ``build/paths_tpu_torch/`` beside its package), and no library of the
    run loads JAX."""
    cache = os.path.join(root, "build", "portbench")
    return {
        "TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
        "CUDA_CACHE_PATH": os.path.join(cache, "cuda"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(cache_env(ROOT))
    # The checkout's root, not this folder, heads the import path.
    sys.path[0] = ROOT
    from portbench import harness

    return harness.main(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
