"""One camera: a ``Tracker`` with its own map and local mapper, the mapper on
a thread of its own (``"mapper": "async"``, as ``rgbd_tum`` runs it) or in
the tracker's (``"sync"``). A frame is one ``Tracker.process``."""

from benchmark.cell import System


class Solo(System):
    def __init__(self, cfg, conf, device):
        super().__init__(cfg, conf, device, 1)
        self.counters = self.trackers[0]

    def step(self, frames, timestamps):
        self.trackers[0].process(*frames[0], timestamps[0])


def build(cfg, conf, device):
    return Solo(cfg, conf, device)
