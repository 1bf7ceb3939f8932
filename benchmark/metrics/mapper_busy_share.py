"""Share (%) of the window, before the profiled slice, in which a mapper ran
``process_keyframe``."""

SPANS = {"mapper": "plslam_torch.models.local_mapping:LocalMapper.process_keyframe"}


def read(run):
    return 100.0 * run.span_union_s("mapper") / run.host_s() if run.host_s() > 0 else None
