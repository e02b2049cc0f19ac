"""rl_step_ms_p95: the 95th percentile (nearest rank) over every
one-step call of the window of the time from the call to the end of the
device synchronise after it, in milliseconds (host clock)."""
from port_bench.harness import p95


def read(run):
    latencies = [latency for _, latency, steps in run.calls if steps == 1]
    if not latencies or len(latencies) != len(run.calls):
        return None
    return 1e3 * p95(latencies)
