"""u64 values carried as int64 bit patterns.

The JAX package computes on uint64 arrays. PyTorch's uint64 tensors lack
`<`, `>>`, `+`, `where` on compares and `searchsorted`, so the port keeps
every u64 value in an int64 tensor holding the same 64 bits. The rules:

* order: compare or sort on ``key(x) = x ^ (1 << 63)``, which maps u64
  order onto int64 order;
* a logical right shift is an arithmetic shift followed by a mask;
* ``*`` and ``+`` wrap mod 2**64 on int64 exactly as on uint64;
* u64::MAX is ``-1`` (``MAX``).

u32 planes (the parser's composite halves, the kernel's hash planes) are
int32 tensors holding the same 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

MAX = -1                 # u64::MAX as an int64 bit pattern
SIGN = -(1 << 63)        # 1 << 63 as an int64 bit pattern
LO32 = 0xFFFFFFFF


def to_i64(v: int) -> int:
    """Python int in [0, 2**64) -> the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def to_u64(v: int) -> int:
    """int64 bit pattern -> the u64 value as a Python int."""
    return v & ((1 << 64) - 1)


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """uint64 (or uint32) numpy array -> int64 (or int32) tensor."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors are always writable
        a = a.copy()
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 (or int32) tensor -> uint64 (or uint32) numpy array."""
    a = t.detach().cpu().contiguous().numpy()
    if a.dtype == np.int64:
        return a.view(np.uint64)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a


def key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key: u64 order of x == int64 order of key."""
    return x ^ SIGN


def lt(a, b) -> torch.Tensor:
    return key(_t(a, b)) < key(_t(b, a))


def le(a, b) -> torch.Tensor:
    return key(_t(a, b)) <= key(_t(b, a))


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(lt(a, b), b, a)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a constant 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | shr(x, 64 - r)


def sort(x: torch.Tensor, dim: int = -1, stable: bool = True):
    """Sort in u64 order; returns (values, indices) like torch.sort."""
    k, idx = torch.sort(key(x), dim=dim, stable=stable)
    return k ^ SIGN, idx


def split(x: torch.Tensor):
    """(lo, hi) int32 planes of an int64 tensor."""
    lo = (x & LO32).to(torch.int32)
    hi = shr(x, 32).to(torch.int32)
    return lo, hi


def join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 from (lo, hi) int32 planes."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & LO32)


def _t(a, like):
    """Promote a Python int operand to a tensor beside `like` (a fill on
    its device: no host-to-device copy, so no wait on a card)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.full((), to_i64(int(a)), dtype=torch.int64,
                      device=like.device)
