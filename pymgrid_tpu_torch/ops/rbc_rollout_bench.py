"""Launch configurations of the fused-horizon RBC kernel, timed on the card.

Run from the repository root on a machine with one H100:

    python3 -m pymgrid_tpu_torch.ops.rbc_rollout_bench [--baseline OLD.cu] \
        [--out rbc_rollout_bench.json] [--sass-dir DIR]

It builds ``csrc/rbc_rollout.cu`` once for each launch configuration
(the shipped one, and 128 or 256 threads per block x 1, 2 or 4 replicas per
thread for every variant; one ``nvcc`` each, all started together), prints each
build's ``-Xptxas -v`` report and the size of each kernel's step loop in
SASS (:func:`step_loops`, from ``cuobjdump -sass`` where the toolkit has it), holds every configuration
bitwise against the plain version (scenario 0 at 131072 x 8759, scenario 1 at
4096 x 8759, all 25 scenarios at 1024 x 64), and times each with CUDA events
at the main path's shape on scenario 0 (no genset) and scenario 1 (genset),
in turns: every configuration forward, then backward.  ``--baseline`` names an earlier source of the kernel with the
first design's C interface (its launch takes the three series apart and a
run-time deploy order); it is built, checked and timed in the same turns,
first and last.  The last line is one JSON object with every number.
"""
import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from pymgrid_tpu_torch.microgrid import Microgrid
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.ops import _build
from pymgrid_tpu_torch.ops.rbc_rollout import VARIANTS, _FLOAT_FIELDS, make_rbc_rollout

# (threads per block, replicas per thread for every variant); None: the
# shipped configuration (256 threads, 2 replicas without the genset, 1 with)
CONFIGS = [None] + [(threads, replicas) for threads in (128, 256) for replicas in (1, 2, 4)]
BATCH, YEAR = 131072, 8759


def _defines(cfg):
    if cfg is None:
        return ()
    threads, replicas = cfg
    return (f"RBC_THREADS={threads}", f"RBC_REPLICAS={replicas}",
            f"RBC_GENSET_REPLICAS={replicas}")


def _label(cfg):
    return "default" if cfg is None else f"{cfg[0]}x{cfg[1]}"


def _sweep(scenario, batch):
    spec, params, _ = extract_spec(Microgrid.from_scenario(scenario), dtype=np.float32)
    pb = params["battery"]
    init = np.linspace(float(pb["min_capacity"][0]), float(pb["max_capacity"][0]), batch,
                       dtype=np.float32)
    init[0] = pb["init_charge"][0]
    return spec, params, torch.as_tensor(init, device="cuda")


def _event_ms(fn, iters):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _clock_during(fn, iters):
    """``nvidia-smi``'s SM clock and power draw, read once while ``fn`` runs
    ``iters`` times back to back (about a second for the kernel at the main
    path's shape), and the mean CUDA-event milliseconds of those calls."""
    reading = {}

    def sample():
        time.sleep(0.3)
        reading["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        ).stdout.strip()

    thread = threading.Thread(target=sample)
    thread.start()
    ms = _event_ms(fn, iters)
    thread.join()
    return reading.get("smi", ""), ms


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    nvcc = _build._nvcc()
    candidate = nvcc[: -len("nvcc")] + "cuobjdump"
    return candidate if os.path.exists(candidate) else None


def sass_text(lib_path):
    """``cuobjdump -sass`` of a library ("" where the tool is missing)."""
    tool = _cuobjdump()
    if tool is None:
        return ""
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout


def _instructions(function):
    out = []
    for line in function.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def _target(body):
    m = re.search(r"\bBRA\b(?:\.\S+)?\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", body)
    return int(m.group(1), 16) if m else None


def step_loops(text):
    """``{kernel: {"static": n, "paths": [shortest, longest] or None}}``
    from ``cuobjdump -sass``: the step loop is the largest loop (a
    backward branch) whose body holds a reciprocal (the divisions by the
    efficiency) and no block barrier; ``static`` counts every instruction of
    its body, ``paths`` the instructions of one iteration along its
    shortest and longest path (division slow paths, which are calls, count
    one instruction; None where the body holds an inner loop), ``rows`` the
    shared-memory rows it reads per iteration (two 16-byte loads a row: the
    steps one iteration takes; 0 where the rows come from global memory)."""
    out = {}
    for function in re.split(r"\n\s*Function : ", text)[1:]:
        name = function.split("\n")[0].strip()
        ins = _instructions(function)
        index = {addr: i for i, (addr, _) in enumerate(ins)}
        best = None
        for i, (_, body) in enumerate(ins):
            start = index.get(_target(body))
            if start is None or start > i:
                continue
            seg = [b for _, b in ins[start:i + 1]]
            if any("BAR.SYNC" in b for b in seg) or not any("MUFU.RCP" in b for b in seg):
                continue
            if best is None or i - start > best[1] - best[0]:
                best = (start, i)
        if best is None:
            continue
        start, end = best
        rows = sum(b.startswith("LDS.128") for _, b in ins[start:end + 1]) // 2
        out[name] = {"static": end - start + 1, "paths": _path_range(ins, index, start, end),
                     "rows": rows}
    return out


def _path_range(ins, index, start, end):
    lo, hi = {end: 1}, {end: 1}
    for k in range(end - 1, start - 1, -1):
        body = ins[k][1]
        t = index.get(_target(body))
        if t is not None and t <= k:
            return None                      # an inner loop
        succ = [] if body.startswith("EXIT") else [k + 1]
        if t is not None:
            succ = [t] if not body.startswith("@") else succ + [t]
        succ = [x for x in succ if x <= end and x in lo]
        if not succ:
            lo[k] = hi[k] = float("inf") if k != end else 1
            continue
        lo[k] = 1 + min(lo[x] for x in succ)
        hi[k] = 1 + max(hi[x] for x in succ if hi[x] != float("inf")) \
            if any(hi[x] != float("inf") for x in succ) else float("inf")
    return [lo[start], hi[start]]


class _Pr1Params(ctypes.Structure):
    """The first design's ``struct RbcParams`` (run-time deploy order)."""

    _fields_ = (
        [(n, ctypes.c_float) for n in _FLOAT_FIELDS]
        + [(n, ctypes.c_int32) for n in (
            "g_start_up", "g_wind_down", "g_abort", "g_init_status", "g_goal",
            "has_genset", "t0", "n_steps", "n_order")]
        + [("order", ctypes.c_int32 * 3)]
    )


def _build_baseline(path):
    src = open(path, "rb").read()
    lib = _build.BUILD_DIR / f"libbaseline-{hashlib.sha256(src).hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def baseline_call(lib, rollout):
    """``init -> out`` through the first design's launch, on ``rollout``'s
    constants and series."""
    fn = lib.rbc_rollout_launch
    fn.argtypes = [ctypes.POINTER(_Pr1Params)] + [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    c = rollout.constants
    cp = _Pr1Params(**{k: c[k] for k in _FLOAT_FIELDS},
                    **{k: c[k] for k in ("g_start_up", "g_wind_down", "g_abort",
                                         "g_init_status", "g_goal", "has_genset",
                                         "t0", "n_steps")})
    cp.n_order = len(rollout.order)
    for i, kind in enumerate(rollout.order):
        cp.order[i] = {"battery": 0, "grid": 1, "genset": 2}[kind]
    load, pv, grid = (s.contiguous() for s in rollout.series)

    def call(init):
        out = torch.empty_like(init)
        rc = fn(ctypes.byref(cp), load.data_ptr(), pv.data_ptr(), grid.data_ptr(),
                init.data_ptr(), out.data_ptr(), init.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: {rc}")
        return out

    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="an earlier kernel source with the first C interface")
    ap.add_argument("--iters", type=int, default=5, help="launches per timing")
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--sass-dir", help="also write each library's cuobjdump -sass here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rbc_rollout_bench needs a CUDA device; none is available")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    jobs = {cfg: _defines(cfg) for cfg in CONFIGS}
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        libs = {cfg: pool.submit(_build.build_library, "rbc_rollout", d)
                for cfg, d in jobs.items()}
        base = pool.submit(_build_baseline, args.baseline) if args.baseline else None
        libs = {cfg: f.result() for cfg, f in libs.items()}
        base = base.result() if base else None
    result = {"card": card, "configs": {}, "variants": VARIANTS}
    for cfg in CONFIGS:
        report = _build.build_report("rbc_rollout", jobs[cfg])
        print(f"--- ptxas, {_label(cfg)} (threads x replicas)\n{report}", flush=True)
        text = sass_text(libs[cfg])
        if args.sass_dir:
            with open(os.path.join(args.sass_dir, f"sass_{_label(cfg)}.txt"), "w") as f:
                f.write(text)
        loops = step_loops(text)
        print(f"--- SASS step loop (instructions), {_label(cfg)}: {json.dumps(loops)}", flush=True)
        result["configs"][_label(cfg)] = {"ptxas": report, "step_loops": loops}
    if base:
        print(f"--- ptxas, baseline\n{base[1]}", flush=True)
        text = sass_text(base[0])
        if args.sass_dir:
            with open(os.path.join(args.sass_dir, "sass_baseline.txt"), "w") as f:
                f.write(text)
        loops = step_loops(text)
        print(f"--- SASS step loop (instructions), baseline: {json.dumps(loops)}", flush=True)
        result["baseline"] = {"ptxas": base[1], "step_loops": loops}
        base_lib = ctypes.CDLL(str(base[0]))

    # bitwise against the plain version
    checks = [(0, BATCH, YEAR), (1, 4096, YEAR)] + [(n, 1024, 64) for n in range(25)]
    for scenario, batch, steps in checks:
        spec, params, init = _sweep(scenario, batch)
        rollouts = {cfg: make_rbc_rollout(spec, params, steps, "cuda", jobs[cfg])
                    for cfg in CONFIGS}
        first = next(iter(rollouts.values()))
        want = first.plain(init)
        for cfg, r in rollouts.items():
            got = r(init)
            if not torch.equal(got, want):
                raise SystemExit(f"{cfg} differs from plain on scenario {scenario} "
                                 f"({batch} x {steps}): max abs "
                                 f"{(got - want).abs().max().item()}")
        if base:
            got = baseline_call(base_lib, first)(init)
            if not torch.equal(got, want):
                raise SystemExit(f"baseline differs from plain on scenario {scenario}")
        print(f"bitwise: scenario {scenario} {batch} x {steps}, variant {first.variant} "
              f"{first.order}", flush=True)

    # timings, in turns: scenario 0 (the main path's, no genset) and
    # scenario 1 (the genset variant) at the main path's shape
    result["times_ms"], result["bound_ms"], result["best"] = {}, {}, {}
    for scenario in (0, 1):
        spec, params, init = _sweep(scenario, BATCH)
        rollouts = {cfg: make_rbc_rollout(spec, params, YEAR, "cuda", jobs[cfg])
                    for cfg in CONFIGS}
        calls = [(_label(cfg), (lambda rr, x: lambda: rr(x))(rollouts[cfg], init))
                 for cfg in CONFIGS]
        if base:
            call = baseline_call(base_lib, rollouts[CONFIGS[0]])
            calls = [("baseline", (lambda c, x: lambda: c(x))(call, init))] + calls
        times = {}
        for name, fn in calls + calls[::-1]:
            ms = _event_ms(fn, args.iters)
            times.setdefault(name, []).append(ms)
            print(f"time scenario {scenario} {name}: {ms:.4f} ms [{card}]", flush=True)
        bound = rollouts[CONFIGS[0]].bound_ms(BATCH)
        best = min((n for n in times if n != "baseline"), key=lambda n: min(times[n]))
        smi, ms = _clock_during(dict(calls)["default"], 200)
        result.setdefault("clock", {})[scenario] = {"smi": smi, "ms": ms}
        print(f"scenario {scenario} default, 200 launches: {ms:.4f} ms each; nvidia-smi "
              f"clocks.sm, clocks.max.sm, power.draw mid-run: {smi} [{card}]", flush=True)
        result["times_ms"][scenario], result["bound_ms"][scenario] = times, bound
        result["best"][scenario] = best
        print(f"scenario {scenario} (variant {rollouts[CONFIGS[0]].variant}): bound "
              f"{bound:.4f} ms; best {best} {min(times[best]):.4f} ms "
              f"({bound / min(times[best]):.1%} of bound) [{card}]", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    sys.exit(main())
