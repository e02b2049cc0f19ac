"""graph_replays_per_step: the port's counter ``pymgrid.suite.graph_replays``
(one a step where the suite's per-step rollout replays its recorded CUDA
graph) over the traced part's steps (program counter)."""
from port_bench.spans import counter_per_step


def read(run):
    return counter_per_step(run, "pymgrid.suite.graph_replays")
