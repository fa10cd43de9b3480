"""How the package calls a built kernel, for every wrapper in ``ops/cuda/``:
:func:`entry` binds a C entry point once, through ``ctypes.PyDLL`` (a
call keeps the interpreter lock: a launch takes microseconds, and
releasing and taking the lock again would add to them); :func:`stream`
and :func:`sm_count` read the device; :func:`check` raises on an entry's
CUDA error code; :func:`count` and :func:`zero` keep a wrapper's
``launches`` and ``launches_<tag>`` (form, variant) counters; and
:func:`run` is the one rule that runs a product's plain twin, its
``torch.autograd.Function`` or its direct launch.  Nothing here touches
the card at import time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from . import build

PTR, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int  # the entries' argument types


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.PyDLL:
    return ctypes.PyDLL(str(build.build([source])[source].path))


@functools.lru_cache(maxsize=None)
def entry(source: str, symbol: str, argtypes: Tuple, restype: Optional[type] = I32):
    """The C function ``symbol`` of ``source`` (built on first use), bound
    with ``argtypes`` and ``restype``: once for each distinct set of these
    arguments, so that a call with other argtypes gets its own binding."""
    fn = _library(source)[symbol]
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


# device index -> that device's current stream as a raw handle, read at
# each launch; torch's own getter where the build has one
stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """RuntimeError "<what> launch failed: CUDA error <err>" on a nonzero
    code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def count(owner, *tags: str) -> None:
    """One more in ``owner.launches`` and in each ``owner.launches_<tag>``."""
    counters = vars(owner)
    counters["launches"] += 1
    for tag in tags:
        counters["launches_" + tag] += 1


def zero(owner, tags: Iterable[str] = ()) -> None:
    """Set ``owner.launches``, ``owner.launches_<tag>`` for each of
    ``tags`` and every other launch counter ``owner`` has to 0."""
    names = {name for name in vars(owner) if name.startswith("launches")}
    for name in names.union(["launches"], [f"launches_{tag}" for tag in tags]):
        setattr(owner, name, 0)


def one_card(kernel: str, names: str, *tensors: torch.Tensor) -> None:
    """ValueError "<kernel> kernel needs <names> on one CUDA device, got
    <each tensor's device>" unless all are on the first one's CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        *head, last = (str(t.device) for t in tensors)
        raise ValueError(
            f"{kernel} kernel needs {names} on one CUDA device, got {', '.join(head)} and {last}"
        )


def on_cpu(*tensors: torch.Tensor) -> bool:
    """Whether every tensor is on the CPU, where the plain twins run."""
    for t in tensors:
        if not t.is_cpu:
            return False
    return True


def run(tensors: Sequence[torch.Tensor], plain: Callable, function: Callable, direct: Callable,
        *args):
    """A product of ``tensors`` by the one rule, the way taken called with
    ``args``: ``function`` (the wrapper's autograd ``Function``: its
    forward runs the plain twin on the CPU and the direct launch on the
    card, its backward the wrapper's VJP) where grad mode is on and one of
    them needs a gradient; else ``plain`` where all are on the CPU; else
    ``direct``.  ``args`` spare a wrapper on a hot path (K1, K5) making
    closures each call: its host path is a few microseconds."""
    if torch.is_grad_enabled():
        for t in tensors:
            if t.requires_grad:
                return function(*args)
    for t in tensors:
        if not t.is_cpu:
            return direct(*args)
    return plain(*args)
