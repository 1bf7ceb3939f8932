"""The control (the reference in the precision below the configuration's, in
the program's place) fails the comparison that the program passes: the
first cell at the small size, on the CPU."""

import json

from benchmark.cell import forbidden_modules
from benchmark.spec import Spec


def test_control_fails_where_the_program_passes(run_small):
    out = run_small("tum_fr3_rgbd.explore", 20.0, control=True)
    limits = Spec().config("tum_fr3_rgbd")["correct"]["limits"]
    assert out["correct"], json.dumps(out["checks"])
    failed = [k for k, lim in limits.items() if out["control"][k] > lim]
    # every number but the lost frames (the reference loses none) separates
    assert set(failed) == set(limits) - {"frames_without_pose"}, out["control"]
    assert forbidden_modules() == []
