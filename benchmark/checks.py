"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (``reference.py``), once the window has closed.

Each oracle that a configuration's ``correct.oracles`` lists is a module
``oracles/<name>.py`` with ``CAPTURES`` (label -> ``"module:attr"``: the
calls of the sampled frames whose arguments and results it judges, copied
as they returned), ``NUMBERS`` (the names of the numbers it reads) and
``readings(calls, ctx, control) -> {number: value}``. ``ctx`` holds the
run's ``sessions`` (their frames as handed over, and which got a pose back),
``cfg`` and ``device``. With ``control=True`` an oracle reads its numbers
with the reference, computed in the precision below the one the
configuration states, in the program's place.
"""

from __future__ import annotations

import torch


def capture_label(oracle: str, label: str) -> str:
    return f"correct.{oracle}.{label}"


def readings(oracles: dict, calls: dict, ctx, control: bool = False) -> dict:
    """Every oracle's numbers (``oracles``: name -> module; ``calls``: the
    hooks' recorded calls by label)."""
    out = {}
    for name, mod in oracles.items():
        mine = {label: calls.get(capture_label(name, label), []) for label in mod.CAPTURES}
        got = mod.readings(mine, ctx, control)
        if set(got) != set(mod.NUMBERS):
            raise ValueError(f"oracle {name} read {sorted(got)}, not {sorted(mod.NUMBERS)}")
        out.update(got)
    return out


def rows(x: torch.Tensor, lead: int) -> torch.Tensor:
    """``x`` with its ``lead`` leading axes flattened into one."""
    return x.reshape((-1,) + tuple(x.shape[lead:]))
