"""Seconds from the start of the process to the first frame of the window."""


def read(run):
    return run.setup_s
