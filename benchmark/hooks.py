"""Wrappers that the benchmark puts around named functions of the program
from outside: host spans, recorded calls, and the captures that ``correct``
judges. A target is ``"module:attr"`` or ``"module:Class.method"``."""

from __future__ import annotations

import functools
import importlib
import threading
import time

import torch


def resolve(target: str):
    """(owner, attribute name) of ``"module:attr"`` / ``"module:Class.attr"``."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *parents, name = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name


class Hooks:
    """Installs wrappers and takes them all off again in :meth:`close`.

    ``span(label, target)``: every call's (start, end, thread id) on the host
    clock goes to ``spans[label]``. ``record(label, target, when)``: while
    ``when()`` is true, every call's (args, kwargs, result) goes to
    ``calls[label]`` with the value of ``tag`` at that moment, from any
    thread or (``main_only``) from the thread that made the hooks."""

    def __init__(self):
        self.spans: dict[str, list] = {}
        self.calls: dict[str, list] = {}
        self._undo: list = []
        self._main = threading.get_ident()
        self.tag = None

    def _wrap(self, target: str, make):
        owner, name = resolve(target)
        orig = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
        fn = orig.__func__ if isinstance(orig, staticmethod) else orig
        wrapped = functools.wraps(fn)(make(fn))
        setattr(owner, name, staticmethod(wrapped) if isinstance(orig, staticmethod) else wrapped)
        self._undo.append((owner, name, orig))

    def span(self, label: str, target: str):
        out = self.spans.setdefault(label, [])

        def make(fn):
            def wrapper(*a, **k):
                s = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    out.append((s, time.perf_counter(), threading.get_ident()))
            return wrapper
        self._wrap(target, make)

    def record(self, label: str, target: str, when, main_only: bool = False,
               copy: bool = False):
        """``copy``: keep copies of the tensors, not the caller's own."""
        out = self.calls.setdefault(label, [])
        main = self._main
        keep = _copied if copy else (lambda x: x)

        def make(fn):
            def wrapper(*a, **k):
                res = fn(*a, **k)
                if when() and (not main_only or threading.get_ident() == main):
                    out.append((self.tag, keep(a), keep(k), keep(res)))
                return res
            return wrapper
        self._wrap(target, make)

    def close(self):
        """Puts every wrapped function back."""
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)


def _copied(x):
    """``x`` with every tensor in it (in tuples, lists, named tuples and
    dicts) replaced by a copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copied(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(v) for v in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return x
