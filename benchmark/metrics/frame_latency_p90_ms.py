"""The 90th percentile of the pose's age over every frame of the window: from
the frame's hand-over to the return of the call that gave its pose (linear
between the closest ranks)."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.ages_s, 90)) if run.ages_s else None
