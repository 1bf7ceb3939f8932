"""``hamming_mismatch_share``: for the Hamming top-2 calls of the sampled
frames, the share of query rows whose best, index or second differ from the
reference's on the same descriptors and gate. Control: the distances summed
in int8."""

import torch

from benchmark import reference as ref
from benchmark.checks import rows

NUMBERS = ("hamming_mismatch_share",)
CAPTURES = {"hamming": "plslam_torch.ops.hamming:hamming_top2"}


def readings(calls, ctx, control):
    n_rows = bad = 0
    for _, args, _, res in calls["hamming"]:
        q, t, gate = args[:3]
        lead = gate.dim() - 2
        qs, ts, gs = rows(q, lead), rows(t, lead), rows(gate, lead)
        best, idx, second = (rows(x, lead) for x in res)
        for b in range(gs.shape[0]):
            want = ref.hamming_top2(qs[b], ts[b], gs[b])
            got = (ref.hamming_top2(qs[b], ts[b], gs[b], torch.int8) if control
                   else (best[b].long(), idx[b].long(), second[b].long()))
            diff = torch.zeros_like(want[0], dtype=torch.bool)
            for w, g in zip(want, got):
                diff |= w != g
            n_rows += diff.numel()
            bad += int(diff.sum())
    return {"hamming_mismatch_share": bad / n_rows if n_rows else 0.0}
