"""Readings that a cell's limits are set from, in one process on the card:
the check's numbers of sound runs of the program on many seeds (short
windows at the cell's own size), and of controls: the reference put in the
program's place in bfloat16, or with a fault planted (the kind's
``control``).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 8 --controls bf16 --control-seeds 4,5,6 [--out file.jsonl]

Prints one JSON line a reading; --out also appends them to a file.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from portbench.run import cache_env

    os.environ.update(cache_env(ROOT))
    import torch

    from portbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in seeds:
        t = time.perf_counter()
        r = harness.run_cell(bench, cell, seed, args.seconds, False, dev, t)
        emit(dict(workload=args.workload, seed=seed, reading="program", correct=r["correct"],
                  compared={k: v["value"] for k, v in r["compared"].items()},
                  metrics={k: v["value"] for k, v in r["metrics"].items()},
                  seconds=time.perf_counter() - t))
    kind = None
    for fault in [c for c in args.controls.split(",") if c]:
        for seed in cseeds:
            t = time.perf_counter()
            ctx = harness.Ctx(device=dev, config_name=cell["config"],
                              config=harness.load_config(cell["config"]),
                              mix=harness.load_mix(cell["traffic"]), seed=seed)
            kind = kind or harness.load_kind(ctx.mix["kind"])
            vals = kind.control(ctx, fault)
            emit(dict(workload=args.workload, seed=seed, reading=fault, compared=vals,
                      seconds=time.perf_counter() - t))
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
