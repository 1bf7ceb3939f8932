"""An RGB-D camera, as TUM's: uint8 gray and depth in the settings'
``DepthMapFactor`` units as uint16, the wire format of ``Tracker.process``.
A blacked-out view (a hand over the lens) is mid gray with no depth."""

import numpy as np

from benchmark import scene

# (name, host dtype) of what the camera delivers a frame, in the order the
# system takes them
STREAMS = (("gray", np.uint8), ("depth", np.uint16))


def render(room, cfg, R, t):
    """The views at the poses R (n, 3, 3), t (n, 3), on the device: one
    tensor a stream."""
    return scene.to_wire(*room.render(cfg.camera, R, t), cfg.tracking.depth_map_factor)


def blank(frame):
    gray, depth = frame
    return np.full_like(gray, 120), np.zeros_like(depth)
