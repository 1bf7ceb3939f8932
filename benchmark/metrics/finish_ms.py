"""Host ms a sequence-frame in ``Tracker._finish`` (retirement, keyframe
decision and creation), before the profiled slice."""

SPANS = {"finish": "plslam_torch.models.tracking:Tracker._finish"}


def read(run):
    return 1e3 * run.span_s("finish") / run.host_frames if run.host_frames else None
