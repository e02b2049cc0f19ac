"""enqueue_ms_per_step.<cells>: the host's time from each call into the
program to its return, before the synchronise, summed over the window and
divided by the batched steps the calls ran, in milliseconds: the launch
cost of one step (host clock)."""


def read(run):
    if not run.calls:
        return None
    return 1e3 * sum(c[0] for c in run.calls) / sum(c[2] for c in run.calls)
