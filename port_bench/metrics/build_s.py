"""build_s: the benchmark's span around the program's construction of
the configuration: loading the scenarios and building the runner or the env
and its tables on the device (host clock)."""


def read(run):
    return run.spans.get("build")
