"""CUDA kernels a sequence-frame of the profiled slice that the pose LM
launched: those whose start, tied to the host's clock by the marker kernel,
lies inside one of the program's ``pose_lm`` spans."""

from benchmark import program_spans


def read(run):
    n = program_spans.slice_kernels_in(run, "pose_lm")
    return n / run.slice["frames"] if n is not None and run.slice["frames"] else None
