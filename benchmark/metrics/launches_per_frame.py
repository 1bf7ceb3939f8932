"""CUDA kernels launched a sequence-frame in the profiled slice."""


def read(run):
    sl = run.slice
    return len(sl["kernels"]) / sl["frames"] if sl and sl["frames"] and sl["kernels"] else None
