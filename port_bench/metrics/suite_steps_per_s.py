"""suite_steps_per_s: every replica-step of the suite's rollouts in the
window over the window's seconds, from the first rollout's start to the last
rollout's end, synchronised (host clock)."""


def read(run):
    if not run.calls:
        return None
    return run.env_steps / run.window_s
