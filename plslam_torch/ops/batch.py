"""Helpers for functions that take optional leading batch axes (B
sequences tracked in one step): gathers per batch entry, and operations
whose result must not depend on the batch, so that a sequence tracked in a
batch gets the bits it gets alone.

- On the CPU a vectorised elementwise function (atan2, sin, cos) takes the
  last few elements of a contiguous run on a scalar path that rounds
  differently in the last bit. A (B, N) tensor is one run of B * N
  elements, so batch entry b would see other elements on that path than the
  same (N,) tensor alone does. ``rowwise`` writes into an output whose rows
  cannot be merged into one run, so every row is the run it is alone. On
  the card every element takes the same path.
- A library kernel may sum in another order for a batch than for one
  problem: a float cumsum or a reduction on the card, a matrix product on
  the CPU (MKL) and the card (cuBLAS), a small LU on the card. ``each``
  runs such an operation one batch entry at a time: B launches instead of
  one, where the path calls it a few times a step.
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (..., M, *F) at ``idx`` (..., N) of each batch entry:
    ``x[idx]`` for an unbatched ``x``."""
    nf = x.dim() - idx.dim()
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * nf), dim=idx.dim() - 1)


def pixels_at(img: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Values of ``img`` (..., H, W) at row-major pixel indices ``flat``
    (..., *S) of each image of the batch: one gather."""
    lead = img.shape[:-2]
    idx = flat.reshape(lead + (-1,))
    return img.reshape(lead + (-1,)).gather(-1, idx).reshape(flat.shape)


def rowwise(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` for an elementwise torch function, each row (last axis) of
    a batch computed as it is alone (see the module docstring)."""
    if xs[0].dim() < 2:
        return fn(*xs)
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    out = torch.empty(shape[:-1] + (shape[-1] + 1,), dtype=xs[0].dtype,
                      device=xs[0].device)[..., :-1]
    return fn(*xs, out=out)


def each(fn, lead: tuple, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` of each batch entry in turn: ``xs`` share the leading axes
    ``lead`` (none for an unbatched call, which is ``fn(*xs)`` itself), and
    the entries' results are stacked back under them."""
    if not lead:
        return fn(*xs)
    parts = [fn(*p) for p in zip(*(x.reshape((-1,) + x.shape[len(lead):]) for x in xs))]
    return torch.stack(parts).reshape(lead + parts[0].shape)
