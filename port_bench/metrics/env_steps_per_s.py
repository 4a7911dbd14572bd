"""Env-steps a second: scenes x steps completed in the window over the
window's host seconds (every step of the window, resets and read-backs
included)."""


def read(run):
    return run["scenes"] * run["steps"] / run["window_s"]
