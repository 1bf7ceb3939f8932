"""Host ms a sequence-frame in the pose LM (``optimize_pose``), before the
profiled slice."""

SPANS = {"pose_lm": "plslam_torch.optim.pose:optimize_pose"}


def read(run):
    return 1e3 * run.span_s("pose_lm") / run.host_frames if run.host_frames else None
