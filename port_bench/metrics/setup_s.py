"""setup_s: the whole set-up of a run, from the start of the process to
the start of the window: imports, the card's start, loading the scenarios,
building the program's objects and the warm-up (host clock)."""


def read(run):
    return run.setup_s
