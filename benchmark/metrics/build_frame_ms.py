"""Host ms a sequence-frame in perception (``build_frame``), before the
profiled slice."""

SPANS = {"build_frame": "plslam_torch.models.frame:build_frame"}


def read(run):
    return 1e3 * run.span_s("build_frame") / run.host_frames if run.host_frames else None
