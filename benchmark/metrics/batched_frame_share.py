"""Share (%) of the window's sequence-frames that went through one batched
step (``MultiTracker.batched_frames``) rather than a solo step."""


def read(run):
    start, end = run.counters["start"], run.counters["end"]
    if "batched_frames" not in end or not run.frames:
        return None
    return 100.0 * (end["batched_frames"] - start["batched_frames"]) / run.frames
