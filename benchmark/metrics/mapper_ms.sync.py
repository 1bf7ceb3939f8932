"""Host ms a sequence-frame in the synchronous mappers' ``process_keyframe``,
before the profiled slice."""

SPANS = {"mapper": "plslam_torch.models.local_mapping:LocalMapper.process_keyframe"}


def read(run):
    return 1e3 * run.span_s("mapper") / run.host_frames if run.host_frames else None
