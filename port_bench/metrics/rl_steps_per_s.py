"""rl_steps_per_s: every replica-step the batched env ran in the window
over the window's seconds, the last call synchronised (host clock)."""


def read(run):
    if not run.calls:
        return None
    return run.env_steps / run.window_s
