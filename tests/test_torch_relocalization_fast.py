"""The fast-camera blackout scenario of tests/test_relocalization.py
(``smooth_trajectory(30)``, twice the speed) at 320x240 through
``Tracker.process``: the JAX package relocalizes within 5 return frames
although the jump from the last confident pose is several times the short-
lost gate's fixed 6 cm (the gate scales with the measured camera speed),
and the port relocalizes on the same return frame, within 5 cm of ground
truth. Each package runs on its own map.
"""

import dataclasses

from plslam_torch import convert
from plslam_torch.models import tracking as ttracking
from test_torch_relocalization import (blackout_frames, jax_cfg, jax_tracker, port_tracker,
                                       run_blackout)
from torch_parity import few_torch_threads  # noqa: F401


def test_fast_camera_blackout():
    frames, returning, poses = blackout_frames(fast=True)
    jcfg = jax_cfg()
    jlost, jat, jerr = run_blackout(jax_tracker(jcfg), frames, returning, poses)
    assert jlost == ttracking.LOST
    assert jat is not None and jat <= 5 and jerr < 0.05, (jat, jerr)
    tr = port_tracker(convert.config_from_dict(dataclasses.asdict(jcfg)))
    lost, at, err = run_blackout(tr, frames, returning, poses)
    assert lost == ttracking.LOST
    assert at == jat
    assert err < 0.05 and abs(err - jerr) < 5e-3, (err, jerr)
    # the jump was beyond the fixed budget: the measured speed let it through
    assert tr._speed_est > 0.06
