"""Each cell of the benchmark at a tiny size on the CPU, for its tests."""
import json

TINY = {
    "suite-rbc-collect": {"replicas": 8, "steps": 10, "warmup_steps": 4, "trace_steps": 10,
                          "sample_per_config": 2},
    "discrete-env-step": {"replicas": 64, "action_pool": 10, "sample": 8, "sample_block": 4,
                          "trace_steps": 5},
}
SEED = 2**33 + 12345      # larger than 32 signed bits hold, as the driver's seeds are


def run_cell(capsys, cell, trace=0, seconds=0.5, seed=SEED, **changes):
    """Run ``cell`` on the CPU at its tiny size, with ``changes`` to its
    traffic; returns ``(code, result)``, ``result`` the parsed last line of
    standard output or ``None``."""
    from port_bench import run

    code = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], device="cpu", overrides={**TINY[cell], **changes})
    lines = capsys.readouterr().out.strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None)
