"""Sequence-frames whose pose was returned in the window, over its seconds."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
