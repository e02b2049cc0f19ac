"""Readings of a cell's comparison on many seeds in one process: the
program's, and its control's.

    python3 -m port_bench.control --workload <name> --seeds 1,2,3 --seconds <s>

The cell is built and warmed up once; then for every seed its inputs are
drawn, its loop runs for ``--seconds`` and the sampled outputs are compared
with the configuration's plain reference in float64.  The control is that
reference computed in bfloat16 (the precision below the configuration's
float32) and put in the program's place on the same samples.  One JSON line
per seed.  The benchmark's own runs never run the control; its limits
(``port_bench/limits/``) are set between the two readings.
"""
import argparse
import json
import sys
import time

from port_bench import harness


def main(argv=None, device=None, overrides=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    cell = harness.resolve(args.workload)
    traffic = dict(cell["traffic"], **(overrides or {}))
    if device is None:
        if not torch.cuda.is_available():
            print("port_bench.control: no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    driver = harness.load_module("drivers", traffic["driver"])
    run = harness.Run()
    system = driver.setup(cell["config"], traffic, device, run)
    threads = torch.get_num_threads()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        driver.prepare(system, seed)
        if i == 0:
            driver.warm_up(system)
        seed_run = harness.Run()
        driver.window(system, args.seconds, seed_run)
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        found = driver.check(system, torch.bfloat16)
        torch.set_num_threads(threads)
        print(json.dumps({"seed": seed, "calls": seed_run.attempted,
                          "check_s": time.perf_counter() - t0, **found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
