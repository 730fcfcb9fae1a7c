"""Chain-steps completed a second over the window (host clock): chains x
iterations of every call of the window, over the time from the window's
start to the end of its last call."""


def read(run):
    if not run.calls:
        return None
    elapsed = run.calls[-1][1] - run.window_start
    return len(run.calls) * run.chain_steps_per_call / elapsed
