"""FAST score + NMS: the frozen bound of the slice's calls, from their inputs
(pixels of every level, sides that pass the pre-test), over the device time
of the kernels they launched (%)."""

SLICE_CALLS = {"fast": "plslam_torch.ops.fast:fast_score_nms_levels"}
KERNEL = "fast_score_nms_kernel"


def read(run):
    from benchmark import roofline

    sl = run.slice
    if not sl:
        return None
    t = sum(e - s for name, s, e in sl["kernels"] if KERNEL in name) / 1e6
    calls = sl["calls"].get("fast", [])
    if t <= 0 or not calls:
        return None
    bound = 0.0
    for _, args, kwargs, _ in calls:
        levels = args[0]
        th = float(args[1] if len(args) > 1 else kwargs["min_threshold"])
        npx = sum(lvl.numel() for lvl in levels)
        sides = sum(roofline.pretest_sides(lvl, th) for lvl in levels)
        bound += roofline.fast_bound_s(npx, sides)
    return 100.0 * bound / t
