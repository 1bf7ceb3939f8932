"""One camera through the ``System`` facade, wired as ``rgbd_tum`` wires it
(``plslam_torch/utils/run_tum.py``; System.cc:86-118): the vocabulary the
configuration names, the keyframe database, an ``AsyncLocalMapper``, an
``AsyncLoopCloser`` and the ``Tracker``, the two workers on threads of their
own. A frame is one ``System.track_rgbd`` with the sensor's wire format
(uint8 gray, uint16 depth in DepthMapFactor units); a lost tracker
relocalizes against the keyframe database.

The vocabulary has the published one's shape (ORBvoc.txt: k 10, 6 levels,
10^6 words), which is not in the repository: the trained levels of the file
the configuration names, then seeded levels below them, built in set-up and
handed to the facade as a vocabulary file, as a user hands it ORBvoc.txt."""

import math
import os
import tempfile

import numpy as np

from benchmark.cell import System
from benchmark.spec import ROOT


def vocabulary_levels(conf: dict) -> tuple[list[np.ndarray], np.ndarray]:
    """(node centres by level, idf of the leaves) of the configuration's
    ``vocabulary``: the first ``trained_levels["levels"]`` levels of its
    file, then ``seeded_levels["levels"]`` more, each node of the level above
    split into k children: its centre with every bit flipped with
    probability ``bit_flip`` (2^-n: the AND of n uniform random bytes), drawn
    from ``seeded_levels["seed"]``. A seeded leaf's idf is its trained
    ancestor's plus ln k a level: DBoW2's ln(N / n_i) with the ancestor's
    documents split evenly over its leaves."""
    voc = conf["vocabulary"]
    trained, seeded = voc["trained_levels"], voc["seeded_levels"]
    z = np.load(os.path.join(ROOT, trained["file"]))
    levels = [z[f"level_{lvl}"] for lvl in range(trained["levels"])]
    idf = z["idf"].astype(np.float64)
    k = voc["k"]
    n_and = round(-math.log2(seeded["bit_flip"]))
    if 2.0 ** -n_and != seeded["bit_flip"]:
        raise ValueError(f"bit_flip {seeded['bit_flip']} is not a power of 1/2")
    rng = np.random.default_rng(seeded["seed"])
    for _ in range(seeded["levels"]):
        parent = np.repeat(levels[-1], k, axis=0)
        mask = np.full(parent.shape, 255, np.uint8)
        for _ in range(n_and):
            mask &= rng.integers(0, 256, parent.shape, dtype=np.uint8)
        levels.append(parent ^ mask)
        idf = np.repeat(idf, k) + math.log(k)
    if len(levels) != voc["levels"] or len(idf) != voc["words"]:
        raise ValueError(f"built {len(levels)} levels and {len(idf)} words, not "
                         f"{voc['levels']} and {voc['words']}")
    return levels, idf.astype(np.float32)


class Slam(System):
    def __init__(self, cfg, conf, device):
        from plslam_torch.models.system import System as Facade

        levels, idf = vocabulary_levels(conf)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "vocabulary.npz")
            np.savez(path, idf=idf, **{f"level_{lvl}": c for lvl, c in enumerate(levels)})
            del levels, idf
            self.slam = Facade(cfg, vocabulary_path=path, enable_loop_closing=True,
                               async_mapping=True, sensor="rgbd", device=device)
        self.trackers = [self.slam.tracker]
        self.mappers = [self.slam.local_mapper]
        self.counters = self.slam.tracker

    def step(self, frames, timestamps):
        self.slam.track_rgbd(*frames[0], timestamps[0])

    def settle(self):
        """Drain the tracker and let both workers finish their keyframes."""
        self.slam._quiesce()

    def close(self) -> list[str]:
        """``System.shutdown``; the errors of both workers."""
        errors = []
        try:
            self.slam.shutdown()
        except Exception as e:  # a worker that did not stop
            errors.append(repr(e))
        for worker in (self.slam.local_mapper, self.slam.loop_closer):
            if getattr(worker, "error", None) is not None:
                errors.append(repr(worker.error))
        return errors


def build(cfg, conf, device):
    return Slam(cfg, conf, device)
