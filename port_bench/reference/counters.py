"""The stage marker the frozen modules call: a no-op here (the reference
is never timed)."""

import contextlib


@contextlib.contextmanager
def stage(name: str):
    yield
