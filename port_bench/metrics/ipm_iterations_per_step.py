"""ipm_iterations_per_step: the port's counter ``pymgrid.lp.iterations``
(the iterations of every interior-point solve, one batched iteration
counted once whatever its batch) over the traced part's hours (program
counter)."""
from port_bench.spans import counter_per_step


def read(run):
    return counter_per_step(run, "pymgrid.lp.iterations")
