"""Share (%) of the profiled slice's wall time in which no kernel ran: one
minus the union of the kernels' intervals over the slice's length."""


def read(run):
    sl = run.slice
    if not sl or not sl["kernels"] or sl["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
