"""lp_problems_per_step: the port's counter ``pymgrid.lp.problems`` (the
LPs every interior-point solve takes, from its batch's shape) over the
traced part's hours (program counter)."""
from port_bench.spans import counter_per_step


def read(run):
    return counter_per_step(run, "pymgrid.lp.problems")
