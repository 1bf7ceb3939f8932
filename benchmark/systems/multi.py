"""Several cameras through one ``MultiTracker``: a tracker, a map and a
local mapper each (synchronous: the wiring ``MultiTracker`` supports), one
batched step a frame for the sessions that track, a solo step for the
others."""

from benchmark.cell import System


class Fleet(System):
    def __init__(self, cfg, conf, device):
        from plslam_torch.parallel.multiseq import MultiTracker

        super().__init__(cfg, conf, device, conf["sessions"])
        self.counters = self.multi = MultiTracker(self.trackers)

    def step(self, frames, timestamps):
        self.multi.process(frames, timestamps)


def build(cfg, conf, device):
    return Fleet(cfg, conf, device)
