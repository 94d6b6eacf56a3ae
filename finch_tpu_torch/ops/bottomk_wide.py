"""Batched bottom-k for WIDE k-mers (32 <= k <= 63): two-word payloads.

The counterpart of ``finch_tpu/ops/bottomk_wide.py``, whose docstring
holds the design: candidates carry (hash, packed_lo, packed_hirc), where
the second payload word packs ``packed_hi << 2 | is_rc << 1 | 1`` (bit 0
is the is-real marker); each step hashes the batch, sorts it, sums the
counts of each run of equal hashes, truncates to capacity and merges into
the state with one more sort and run sum. There is no spill buffer and no
Pallas kernel there, so there is no hand kernel here: every step is plain
PyTorch calls, on `device`.

State (capacity C; hashes ascending in u64 order; all int64 u64 bit
patterns, see ``finch_tpu_torch.u64``):
    h[C]     u64::MAX in empty slots
    c[C]     counts, 0 in empty slots
    e[C]     reverse-complement counts
    plo[C]   bits [0, 64) of the packed code
    phirc[C] packed_hi << 2 | is_rc << 1 | 1, 0 in empty slots

What differs from the JAX package, with the state unchanged:

* The log-shift ``_scan`` (a TPU workaround) goes. A run's sums are
  ``torch.cumsum`` differenced at the run ends, which a
  ``torch.searchsorted`` over the run ids finds; the compaction sort of
  the runs goes too, because the runs of a sorted input are already in
  order and only the u64::MAX run can be a pad.
* Only the payload of the runs kept is gathered.
* A run's payload comes from its last element, as in the JAX package, but
  the u64::MAX run takes its last *real* element. The JAX package sorts on
  the hash alone, so a pad can follow a real u64::MAX hash and give it a
  zero payload; here the result is that of the order (hash, pads before
  reals), and a real u64::MAX keeps its k-mer.

Every input to ``_dedup_truncate_wide`` keeps one rule, which all callers
here meet: an entry with count 0 (a pad) has hash u64::MAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.ops.murmur3 import hash_packed_kmers_wide

MAX = u64.MAX


def empty_state(capacity: int, device="cpu"):
    """(h, c, e, plo, phirc): empty slots hold h = u64::MAX and zeros."""
    i64 = dict(dtype=torch.int64, device=device)
    return (torch.full((capacity,), MAX, **i64),) + tuple(
        torch.zeros((capacity,), **i64) for _ in range(4))


def _sort(h: torch.Tensor) -> torch.Tensor:
    """Stable ascending u64 order of h (the permutation)."""
    return torch.sort(u64.key(h), stable=True)[1]


def _dedup_truncate_wide(h, c, e, plo, phirc, out_len: int, order=None,
                         max_hash=None):
    """h ascending (u64 order). Returns the first `out_len` runs of equal
    hashes as a state (distinct hashes ascending, counts and extras summed
    per run, the payload of the run's last element; the u64::MAX run's
    last real one), pads after them, and, when `max_hash` is given, the
    number of real runs with hash <= max_hash before truncation.

    With `order`, the payload words are unsorted and `order` is the sort's
    permutation: only the kept runs' payloads are gathered."""
    n = h.shape[0]
    dev = h.device
    is_end = torch.ones(n, dtype=torch.bool, device=dev)
    is_end[:-1] = h[1:] != h[:-1]
    run = torch.cumsum(is_end, 0) - is_end.long()  # each entry's run id
    cs_c = torch.cumsum(c, 0)
    cs_e = torch.cumsum(e, 0)
    m = n if max_hash is not None else min(out_len, n)
    # the last entry of run j; n - 1 for j past the last run, whose sums
    # then difference to 0
    end = torch.searchsorted(
        run, torch.arange(m, dtype=torch.int64, device=dev), right=True) - 1
    end_c = cs_c[end]
    end_e = cs_e[end]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    run_c = end_c - torch.cat([zero, end_c[:-1]])
    run_e = end_e - torch.cat([zero, end_e[:-1]])
    real = run_c > 0
    run_h = h[end]
    below = None
    if max_hash is not None:
        below = (real & u64.le(run_h, max_hash)).sum()
    # payload: the run's last entry, or the last real u64::MAX entry for
    # the run that ends the input
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    last_real_max = torch.where((c > 0) & (h == MAX), idx, -1).max()
    pay = torch.where(end == n - 1,
                      torch.where(last_real_max >= 0, last_real_max, n - 1),
                      end)
    k = min(out_len, n)
    real, pay = real[:k], pay[:k]
    if order is not None:
        pay = order[pay]
    state = (torch.where(real, run_h[:k], MAX),
             torch.where(real, run_c[:k], 0),
             torch.where(real, run_e[:k], 0),
             torch.where(real, plo[pay], 0),
             torch.where(real, phirc[pay], 0))
    return state, below


def sketch_step(state, batch_plo, batch_phi, batch_rc, nvalid: int,
                max_hash: int, *, k: int, seed: int, has_max_hash: bool,
                stats: dict | None = None):
    """Fold one batch of wide packed canonical k-mers into the state.

    batch_plo/batch_phi are int64 code words, batch_rc the is-rc flags;
    lanes from `nvalid` on are padding. Returns (new_state, below): below
    is a 0-d tensor, the number of distinct hashes <= max_hash in the
    merged view before truncation (the scaled engine's grow-and-redo
    signal); with has_max_hash False nothing reads it, and it is 0 without
    being counted. No host sync."""
    sh = state[0]
    cap = sh.shape[0]
    b = batch_plo.shape[0]
    dev = batch_plo.device
    if stats is not None:
        stats["wide"] = stats.get("wide", 0) + 1

    with record_function("wide.hash"):
        h = hash_packed_kmers_wide(batch_plo, batch_phi, k=k, seed=seed)
    with record_function("wide.select"):
        thresh = sh[-1:]
        if has_max_hash:
            thresh = u64.maximum(
                thresh, torch.full_like(thresh, u64.to_i64(max_hash)))
        keep = torch.arange(b, device=dev) < nvalid
        keep &= u64.le(h, thresh)
        rc = batch_rc.to(torch.int64)
        ch = torch.where(keep, h, MAX)
        cc = keep.to(torch.int64)
        ce = rc * cc
        cplo = torch.where(keep, batch_plo, 0)
        cphirc = torch.where(keep, (batch_phi << 2) | (rc << 1) | 1, 0)

    # batch-local dedup to capacity: only the cap smallest distinct batch
    # hashes can reach the state (truncation is permanent)
    with record_function("wide.batch_sort"):
        order = _sort(ch)
        ch, cc, ce = ch[order], cc[order], ce[order]
    with record_function("wide.batch_runs"):
        bstate, _ = _dedup_truncate_wide(ch, cc, ce, cplo, cphirc, cap,
                                         order=order)
    with record_function("wide.merge_sort"):
        merged = [torch.cat([s, t]) for s, t in zip(state, bstate)]
        order = _sort(merged[0])
        merged = [x[order] for x in merged]
    with record_function("wide.merge_runs"):
        if not has_max_hash:
            new_state, _ = _dedup_truncate_wide(*merged, cap)
            return new_state, torch.zeros((), dtype=torch.int64, device=dev)
        return _dedup_truncate_wide(*merged, cap, max_hash=max_hash)


def grow_state(state, new_capacity: int):
    """Copy into a larger-capacity state (the scaled growth rail)."""
    out = empty_state(new_capacity, device=state[0].device)
    n = state[0].shape[0]
    for dst, src in zip(out, state):
        dst[:n] = src
    return out


def state_arrays(state):
    """(h, c, e, plo, phi) numpy uint64 views of the live entries, hash
    ascending; phi is the phirc word shifted back (logically: at k = 62
    and 63 the word's top bit is set)."""
    h, c, e, plo, phirc = state
    real = c > 0
    return tuple(u64.to_numpy(x[real])
                 for x in (h, c, e, plo, u64.shr(phirc, 2)))


def state_to_numpy(state):
    """The raw state as numpy uint64 arrays, pads included."""
    return tuple(u64.to_numpy(x) for x in state)


def state_from_numpy(h, c, e, plo, phi, capacity: int, device="cpu"):
    """A state of `capacity` slots from a host fold's live entries (numpy
    uint64, hash ascending and distinct; the inverse of state_arrays): the
    entries fill the first slots, pads the rest.

    The host keeps no is-rc bit (its strand is in `e`), so phirc is
    ``phi << 2 | 1`` with bit 1 clear. Nothing reads that bit back:
    state_arrays shifts it out, and a run's payload comes from its last
    element, which for one hash carries the same code whatever its strand.
    At k = 62 and 63 the shift moves phi's top bits into the word's sign
    bit, where the u64 carrier keeps them."""
    n = len(h)
    if n > capacity:
        raise FinchMessageError(
            f"{n} entries do not fit a wide state of capacity {capacity}")
    out = [np.full(capacity, np.uint64(2**64 - 1), dtype=np.uint64)] + [
        np.zeros(capacity, dtype=np.uint64) for _ in range(4)]
    phirc = (np.asarray(phi, dtype=np.uint64) << np.uint64(2)) | np.uint64(1)
    for dst, src in zip(out, (h, c, e, plo, phirc)):
        dst[:n] = src
    return tuple(u64.from_numpy(a, device) for a in out)


def merge_states(states):
    """Associative merge of per-shard wide states of one capacity."""
    merged = [torch.cat([s[i] for s in states]) for i in range(5)]
    order = _sort(merged[0])
    merged = [x[order] for x in merged]
    return _dedup_truncate_wide(*merged, states[0][0].shape[0])[0]
