"""The library's profiler spans: :func:`span`, re-exported by
``utils/profile.py`` as its documented entry.

A leaf module: it imports nothing of the package, so that the formats
and the products, which ``utils/profile.py`` itself imports, can mark
their work with it.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else a shared no-op context: with no profiler the
    call is one check, and it never reads a clock, synchronises or
    allocates."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
