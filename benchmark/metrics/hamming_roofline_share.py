"""Gated Hamming top-2: the bytes of queries, targets, gate and outputs of the
slice's calls, moved once at 3.35 TB/s, over the device time of the kernels
they launched (%)."""

import math

SLICE_CALLS = {"hamming": "plslam_torch.ops.hamming:hamming_top2",
               "hamming_batched": "plslam_torch.ops.hamming:hamming_top2_batched"}
KERNEL = "hamming_top2_kernel"


def read(run):
    from benchmark import roofline

    sl = run.slice
    if not sl:
        return None
    t = sum(e - s for name, s, e in sl["kernels"] if KERNEL in name) / 1e6
    bound = 0.0
    for label, shared in (("hamming", False), ("hamming_batched", True)):
        for _, args, _, _ in sl["calls"].get(label, []):
            q, tg, gate = args[:3]
            n, m = gate.shape[-2:]
            problems = math.prod(gate.shape[:-2])
            if problems * n == 0:
                continue  # no launch
            bound += roofline.hamming_bound_s(problems, n, m, shared)
    return 100.0 * bound / t if t > 0 and bound > 0 else None
