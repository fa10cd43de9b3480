"""Row-sort kernel K6: co-sort each row of (n, 128) keys ascending, the
values riding the same permutation.

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/sort_rows.cu``; its note says
which TPU function it replaces, what bounds it (bytes: keys and values
read and written once) and how its design meets that bound.  This module
holds what surrounds it:

* :func:`sort_rows_plain`, the plain torch transcription of the JAX
  package's network (``_stage`` with ``torch.roll`` / ``torch.where``, the
  same k / j loop), used for tensors on the CPU and as the kernel's
  reference on the card.  Its ``calls`` attribute counts calls;
* :func:`sort_rows_kernel`, the counterpart of ``sort_rows_pallas``: CPU
  tensors take the plain version, CUDA tensors launch the kernel or raise
  (``launch.on_cpu``; K6 has no gradient, so no ``torch.autograd.Function``).
  Its ``launches`` attribute counts kernel launches.

Both run the same 28 compare-exchange stages with the JAX package's rule,
so they agree bit for bit, values under equal keys included.  Keys are
compared as signed ints: float32 keys through a map of their bits whose
order is the float order with -0.0 below +0.0, as ``jnp.minimum`` orders
them; a value moves only where the keys differ as numbers, so -0.0
against +0.0 moves the keys' bits and not the values (the JAX
``swap = new_key != key``).  Neither version leans on how a device's
``minimum`` breaks a tie of +0.0 and -0.0: torch's differs between its
scalar and vectorised CPU paths.  Both use one map of the bits, so a NaN
key sorts by its bits as well: after +inf with the sign bit clear, before
-inf with it set (``torch.sort`` puts every NaN last).  The port's
``compress_coo`` sorts with ``torch.sort``, as the JAX one sorts with
``lax.sort``: this kernel is on no other path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...formats.util import round_up
from . import launch
from .launch import I32, I64, PTR

LANES = 128
PER_LANE = 8  # csrc/sort_rows.cu: kPerLane, elements of a row per lane
ROWS_PER_WARP = 32 // (LANES // PER_LANE)
BLOCK = 256  # kThreads: 8 warps, 16 rows
# Resident 256-thread blocks per SM (kMinBlocks).
BLOCKS_PER_SM = 4

_ENTRY = {torch.int32: "sprs_sort_rows_i32", torch.float32: "sprs_sort_rows_f32"}
_ARGS = (PTR, PTR, PTR, PTR, I64, I32, I32, PTR)


def launch_config(n_rows: int, n_sm: int) -> Tuple[int, int]:
    """(grid, block) for ``n_rows`` rows on a card with ``n_sm`` SMs: 16
    lanes per row, two rows per warp, at most one full wave of resident
    blocks; the kernel's grid-stride loop over rows covers the rest."""
    blocks = -(-n_rows // (BLOCK // 32 * ROWS_PER_WARP))
    return max(1, min(blocks, n_sm * BLOCKS_PER_SM)), BLOCK


def _order_map(bits: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns (as int32) -> ints whose signed order is the
    float order with -0.0 (-1) below +0.0 (0); the map is its own
    inverse."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _stage(key, val, lane, j, k, floats):
    """One bitonic compare-exchange stage along the rows on ordered keys:
    element i meets i ^ j, keeps the min where bits j and k of i agree,
    else the max, and takes the partner's value only where its key
    changed as a number (for float keys, -0.0 and +0.0 are one number:
    ordered, they are -1 and 0)."""
    use_lo = (lane & j) == 0
    pk = torch.where(use_lo, torch.roll(key, -j, 1), torch.roll(key, j, 1))
    pv = torch.where(use_lo, torch.roll(val, -j, 1), torch.roll(val, j, 1))
    tj = j.bit_length() - 1
    tk = k.bit_length() - 1
    keep_min = (((lane >> tj) ^ (lane >> tk)) & 1) == 0
    new_key = torch.where(keep_min, torch.minimum(key, pk), torch.maximum(key, pk))
    changed = new_key != key
    if floats:
        changed &= ((new_key ^ (new_key >> 31)) | (key ^ (key >> 31))) != 0
    return new_key, torch.where(changed, pv, val)


def _pad_rows(keys, vals, rows_blk):
    """Rows padded with zeros to a multiple of the row block, as the JAX
    package pads its grid; the padding rows sort among themselves."""
    n_rows = keys.shape[0]
    rows_blk = min(rows_blk, round_up(max(n_rows, 8), 8))
    pad = round_up(n_rows, rows_blk) - n_rows
    if pad:
        keys = torch.cat([keys, keys.new_zeros((pad, LANES))])
        vals = torch.cat([vals, vals.new_zeros((pad, LANES))])
    return keys, vals


def sort_rows_plain(keys: torch.Tensor, vals: torch.Tensor, *, rows_blk: int = 512):
    """The plain torch K6: the JAX network, stage for stage, over the rows
    padded as the JAX package pads them."""
    sort_rows_plain.calls += 1
    _check_width(keys, vals)
    n_rows = keys.shape[0]
    key, val = _pad_rows(keys, vals, rows_blk)
    floats = keys.dtype == torch.float32
    if floats:
        key = _order_map(key.view(torch.int32))
    lane = torch.arange(LANES, dtype=torch.int32, device=keys.device).expand(key.shape[0], -1)
    k = 2
    while k <= LANES:
        j = k // 2
        while j >= 1:
            key, val = _stage(key, val, lane, j, k, floats)
            j //= 2
        k *= 2
    if floats:
        key = _order_map(key).view(torch.float32)
    return key[:n_rows], val[:n_rows]


sort_rows_plain.calls = 0


def _check_width(keys, vals):
    if keys.ndim != 2 or keys.shape[1] != LANES:
        raise ValueError(f"sort_rows: keys must be (n, {LANES}), got {tuple(keys.shape)}")
    if vals.shape != keys.shape:
        raise ValueError(
            f"sort_rows: vals {tuple(vals.shape)} must match keys {tuple(keys.shape)}"
        )


def _check(keys: torch.Tensor, vals: torch.Tensor) -> None:
    """Refuse, before any launch, the types and layouts that the kernel
    does not take (the device is checked by :func:`_launch`)."""
    if keys.dtype not in _ENTRY:
        raise TypeError(f"sort_rows kernel takes int32 or float32 keys, got {keys.dtype}")
    if vals.element_size() != 4:  # moved as raw 32-bit words
        raise TypeError(f"sort_rows kernel takes 4-byte vals, got {vals.dtype}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("sort_rows kernel needs contiguous keys and vals")
    if keys.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("sort_rows kernel needs 16-byte aligned keys and vals")


def _launch(keys: torch.Tensor, vals: torch.Tensor):
    launch.one_card("sort_rows", "keys and vals", keys, vals)
    _check(keys, vals)
    ks, vs = torch.empty_like(keys), torch.empty_like(vals)
    n_rows = keys.shape[0]
    if n_rows == 0:
        return ks, vs
    index = keys.get_device()
    grid, block = launch_config(n_rows, launch.sm_count(index))
    err = launch.entry("sort_rows", _ENTRY[keys.dtype], _ARGS)(
        keys.data_ptr(),
        vals.data_ptr(),
        ks.data_ptr(),
        vs.data_ptr(),
        n_rows,
        grid,
        block,
        launch.stream(index),
    )
    launch.check(err, "sort_rows kernel")
    launch.count(sort_rows_kernel)
    return ks, vs


def sort_rows_kernel(keys: torch.Tensor, vals: torch.Tensor, *, rows_blk: int = 512):
    """Co-sort each row of ``(n, 128)`` ``keys`` / ``vals`` ascending; the
    counterpart of ``sort_rows_pallas``.

    ``keys`` are int32 or float32 with exactly 128 columns (pad shorter
    segments with INT32_MAX / +inf); ``vals`` (4-byte) ride the same
    permutation.  Raises ValueError on another width.  On the CPU the
    plain version pads the rows to a multiple of ``rows_blk`` as the JAX
    package does; the kernel needs no padding (16 lanes per row, and
    the lanes of a row that does not exist load and store nothing), so on
    a CUDA device ``rows_blk`` changes nothing.
    """
    _check_width(keys, vals)
    if launch.on_cpu(keys, vals):
        return sort_rows_plain(keys, vals, rows_blk=rows_blk)
    return _launch(keys, vals)


launch.zero(sort_rows_kernel)
