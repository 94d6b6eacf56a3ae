"""Batched bottom-k sketch selection with count tracking, on torch tensors.

The counterpart of ``finch_tpu/ops/bottomk.py``; its module docstring
holds the batch-equivalence argument (the final sketch is the K smallest
distinct hashes with exact counts, whatever the batch boundaries, spill
layout or flush times). Only ``flush_state`` output is contract.

What differs from the JAX package:

* u64 values are int64 bit patterns (``finch_tpu_torch.u64``): every sort
  and compare goes through the sign-biased key.
* The data-dependent paging loops (``lax.while_loop`` there) are Python
  loops. Each stage sorts once, then reads how many leading pages hold a
  survivor in one host transfer; the appends never change the sorted
  block, so this equals the JAX loop conditions. Every host read is a
  device sync. ``sketch_step_gen`` is the step as a coroutine: it yields
  each device tensor it needs on the host and is sent the value back, so
  its caller decides when to wait. ``sketch_step`` reads each one at once
  and counts the reads in ``stats["syncs"]``; the mesh reads every
  shard's in one wait (``parallel/sharded_sketch.py``).
* The log-shift ``_scan`` loops (a v5e workaround) are ``torch.cumsum`` /
  ``torch.cummax`` / ``torch.cummin``.
* The kernel path is the JAX main path in its default configuration
  (``absorb=True, dedup_tier=True``): the extract kernel, unweighted or
  weighted as the adaptive-absorb hint says (``ops/extract.py``), and
  tiers A, D2, B, D and C with the dedup kernels (``ops/dedup.py``).
  ``absorb=False, dedup_tier=False`` gives the unweighted kernel with
  tiers A, B and C. The ``lax.cond``s become host reads of the flags.

The transposed two-stage sort is kept as in the JAX package, so the spill
layout and the scaled `below` bound agree with it entry for entry.

State (capacity C, spill S; hashes ascending):
    hashes[C] int64 (u64 bits) — u64::MAX in empty slots
    counts[C], extras[C] int64 — 0 in empty slots
    packed[C] int64 — 2-bit packed canonical k-mer codes
    spill[S]  int64 — spill-encoded candidates; u64::MAX when empty
    fill[1]   int32 — spill occupancy
    hint[1]   int32 — adaptive-absorb hint: 1 = run the weighted extract
"""

from __future__ import annotations

import numpy as np
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.ops import dedup, extract
from finch_tpu_torch.ops.murmur3 import hash_packed_kmers
from finch_tpu_torch.utils.metrics import span

MAX = u64.MAX

PAGE = 32768       # spill append granularity (entries)
STAGE1_H = 32      # height of the first transposed sort
STAGE1_ROWS = 4    # stage-1 rows re-compacted per stage-2 sort
STAGE2_H = 256     # height of the second transposed sort


def bucket_pow2(n: int, floor: int = 1024) -> int:
    """Next power of two >= n (>= floor): the engines' batch-pad rule."""
    b = floor
    while b < n:
        b <<= 1
    return b


def spill_capacity(capacity: int) -> int:
    """Spill sized to amortize merges ~8-32x without dwarfing tiny states."""
    return int(max(2 * PAGE, min(1 << 20, 8 * capacity)))


def empty_state(capacity: int, spill: int | None = None, device="cpu"):
    if spill is None:
        spill = spill_capacity(capacity)
    i64 = dict(dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return (
        torch.full((capacity,), MAX, **i64),
        torch.zeros((capacity,), **i64),
        torch.zeros((capacity,), **i64),
        torch.zeros((capacity,), **i64),
        torch.full((spill,), MAX, **i64),
        torch.zeros((1,), **i32),
        torch.zeros((1,), **i32),
    )


def state_from_numpy(arrays, device="cpu"):
    """The port's state from the JAX package's 7-tuple as numpy arrays
    (uint64 x5, int32 fill, int32 hint)."""
    if len(arrays) != 7:
        raise FinchMessageError("a sketch state has 7 arrays")
    out = []
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        want = np.int32 if i >= 5 else np.uint64
        if a.dtype != want:
            raise FinchMessageError(
                f"state array {i} must be {np.dtype(want).name}, got {a.dtype}")
        out.append(u64.from_numpy(a, device))
    return tuple(out)


def state_to_numpy(state):
    """Inverse of state_from_numpy: the 7-tuple as numpy arrays."""
    return (*(u64.to_numpy(t) for t in state[:5]),
            *(t.cpu().numpy() for t in state[5:]))


def _dedup_truncate(h, c, e, pk, out_len: int):
    """h sorted ascending in u64 order (duplicate runs adjacent; pads have
    h=u64::MAX, c=0). Returns the distinct hashes ascending with summed
    counts, cut to out_len, plus the full (h, c) view. A run's payload is
    its last element's, as in the JAX package."""
    is_end = torch.ones_like(h, dtype=torch.bool)
    is_end[:-1] = h[1:] != h[:-1]
    cs_c = torch.cumsum(c, 0)
    cs_e = torch.cumsum(e, 0)
    zero = torch.zeros(1, dtype=c.dtype, device=c.device)
    prev_c = torch.cat([zero, torch.cummax(
        torch.where(is_end, cs_c, 0), 0).values[:-1]])
    prev_e = torch.cat([zero, torch.cummax(
        torch.where(is_end, cs_e, 0), 0).values[:-1]])
    run_c = cs_c - prev_c
    run_e = cs_e - prev_e
    real = is_end & (run_c > 0)
    kh = torch.where(real, h, MAX)
    # two-key order (kh, pad_rank): real u64::MAX hashes sort before pads
    o1 = torch.argsort((~real).to(torch.int8), stable=True)
    o2 = torch.argsort(u64.key(kh[o1]), stable=True)
    order = o1[o2]
    kh = kh[order]
    kc = torch.where(real, run_c, 0)[order]
    ke = torch.where(real, run_e, 0)[order]
    kpk = torch.where(real, pk, MAX)[order]
    return (kh[:out_len], kc[:out_len], ke[:out_len], kpk[:out_len]), (
        kh, kc)


def _merge_candidates(state4, ch, cc, ce, cpk, max_hash):
    """Merge candidates into the 4-array state: sort + dedup + truncate.

    Returns (new_state4, below): below counts distinct hashes <= max_hash
    in the pre-truncation merged view (0-dim int64 tensor)."""
    sh, sc, se, spk = state4
    cap = sh.shape[0]
    mh = torch.cat([sh, ch])
    order = torch.argsort(u64.key(mh), stable=True)
    mh = mh[order]
    mc = torch.cat([sc, cc])[order]
    me = torch.cat([se, ce])[order]
    mpk = torch.cat([spk, cpk])[order]
    new_state, (full_h, full_c) = _dedup_truncate(mh, mc, me, mpk, cap)
    below = (u64.le(full_h, max_hash) & (full_c > 0)).sum()
    return new_state, below


def _spill_weight_shift(k: int) -> int:
    """Bit position of the run-weight field in spill entries: an entry is
    (weight << shift) | (composite + 1), weight = run_length - 1; 0 when k
    leaves no weight bits."""
    s = 2 * k + 2
    return s if s < 64 else 0


def _flush(state4, spill, max_hash, *, k: int, seed: int):
    """Rehash spilled composite payloads and merge them into the state;
    count = weight + 1 keeps every path exact."""
    ok = spill != MAX
    s = _spill_weight_shift(k)
    if s:
        comp = spill & ((1 << s) - 1)
        w = u64.shr(spill, s)
    else:
        comp = spill
        w = torch.zeros_like(spill)
    cpk_raw = u64.shr(comp - 1, 1)
    ch = torch.where(ok, hash_packed_kmers(cpk_raw, k=k, seed=seed), MAX)
    cc = torch.where(ok, w + 1, 0)
    ce = ((comp - 1) & 1) * cc
    cpk = torch.where(ok, cpk_raw, MAX)
    return _merge_candidates(state4, ch, cc, ce, cpk, max_hash)


def _compact_spill(spill, *, k: int):
    """Collapse duplicate composites across the whole spill into summed run
    weights (duplicate-burst pressure relief).

    Returns (compacted, n_real, ovf) as tensors: ovf is set when a run's
    total would not fit the weight field."""
    s = _spill_weight_shift(k)
    mask = (1 << s) - 1
    real_in = spill != MAX
    keyv = torch.where(real_in, spill & mask, MAX)
    order = torch.argsort(u64.key(keyv), stable=True)
    keyv = keyv[order]
    ent = spill[order]
    real = keyv != MAX
    w = torch.where(real, u64.shr(ent, s) + 1, 0)
    is_end = torch.ones_like(keyv, dtype=torch.bool)
    is_end[:-1] = keyv[1:] != keyv[:-1]
    cs = torch.cumsum(w, 0)
    prev = torch.cat([torch.zeros(1, dtype=cs.dtype, device=cs.device),
                      torch.cummax(torch.where(is_end, cs, 0),
                                   0).values[:-1]])
    total = cs - prev
    keep = is_end & real
    ovf = (keep & (u64.shr(total - 1, 64 - s) != 0)).any()
    out = torch.where(keep, keyv + ((total - 1) << s), MAX)
    # heads to the front: keys are unique per run, pads sink to the tail
    order = torch.argsort(u64.key(torch.where(keep, keyv, MAX)), stable=True)
    return out[order], keep.sum(), ovf


def _compact_worthwhile(k: int) -> bool:
    """Spill compaction needs a weight field of >= 12 bits (k <= 25)."""
    s = _spill_weight_shift(k)
    return bool(s) and (64 - s) >= 12


def _aggregate_runs(s2, shift: int):
    """Collapse duplicate composites in a column-sorted slab into weighted
    run heads (tier-B pre-aggregation); see the JAX package's docstring
    for why it is exact."""
    H, w = s2.shape
    s, _ = u64.sort(s2, dim=1)
    neq = s[:, 1:] != s[:, :-1]
    ones = torch.ones((H, 1), dtype=torch.bool, device=s.device)
    head = torch.cat([ones, neq], 1)
    endm = torch.cat([neq, ones], 1)
    col = torch.arange(w, dtype=torch.int64, device=s.device).expand(H, w)
    e = torch.where(endm, col, w)
    # suffix-min: nearest run end at or after each column
    e = torch.cummin(e.flip(1), 1).values.flip(1)
    run = e - col  # run_length - 1 at run heads
    keep = head & (s != MAX)
    out = torch.where(keep, s + (run << shift), MAX)
    return u64.sort(out, dim=0)[0]


class _Carry:
    """The paging loops' carry: state4, spill (owned by this step), fill
    (a host int) and below (a 0-dim tensor)."""

    def __init__(self, state4, spill, fill: int, below):
        self.state4 = state4
        self.spill = spill
        self.fill = fill
        self.below = below


def _read(x, stats):
    """Host read of a device value (one sync): the span ``engine.sync``,
    whose calls are the `syncs` counted here."""
    if stats is not None:
        stats["syncs"] = stats.get("syncs", 0) + 1
    with span("engine.sync"):
        return x.tolist()


def _append_page(carry: _Carry, cand, mh_arg, *, k: int, seed: int,
                 compact: bool = False):
    """Append one candidate page to the spill, flushing first if needed.

    compact=True (duplicate-burst tiers): on overflow, first try to
    collapse duplicates across the spill; when that frees >= 25% of it
    (and no weight overflows) the state merge is skipped."""
    need = cand.shape[0]
    sp = carry.spill.shape[0]
    if carry.fill + need > sp:
        compacted = False
        if compact and _compact_worthwhile(k):
            out, n_real, ovf = _compact_spill(carry.spill, k=k)
            n_real, ovf = yield torch.stack([n_real, ovf.to(n_real.dtype)])
            if not ovf and n_real + need <= sp - sp // 4:
                carry.spill, carry.fill, compacted = out, n_real, True
        if not compacted:
            carry.state4, nb = _flush(carry.state4, carry.spill, mh_arg,
                                      k=k, seed=seed)
            carry.below = torch.maximum(carry.below, nb)
            carry.spill = torch.full_like(carry.spill, MAX)
            carry.fill = 0
    carry.spill[carry.fill:carry.fill + need] = cand
    carry.fill += need


def _leading_pages(rows):
    """How many leading pages hold a survivor; rows[p] is page p's first
    row (the JAX loop condition, read in one transfer)."""
    live = yield (rows != MAX).any(dim=1)
    n = 0
    while n < len(live) and live[n]:
        n += 1
    return n


def _stage2_pages(carry, flat_cands, *, k, seed, mh_arg, aggregate=False,
                  compact=False):
    """Re-compact candidates through a (STAGE2_H, w2) axis-0 sort and
    append row pages while the next page's leading row has survivors."""
    w2 = flat_cands.shape[0] // STAGE2_H
    r2 = 1
    while r2 * 2 <= min(STAGE2_H, PAGE // w2):
        r2 *= 2
    s2, _ = u64.sort(flat_cands.reshape(STAGE2_H, w2), dim=0)
    shift = _spill_weight_shift(k)
    if (aggregate and shift
            and 64 - shift >= max(1, (w2 - 1).bit_length())):
        s2 = _aggregate_runs(s2, shift)
    for p2 in range((yield from _leading_pages(s2[::r2]))):
        yield from _append_page(carry, s2[p2 * r2:(p2 + 1) * r2].reshape(-1),
                                mh_arg, k=k, seed=seed, compact=compact)


def _run_two_stage(carry, comp, b: int, *, k, seed, mh_arg, aggregate=False,
                   compact=False):
    s1, _ = u64.sort(comp.reshape(STAGE1_H, b // STAGE1_H), dim=0)
    for p1 in range((yield from _leading_pages(s1[::STAGE1_ROWS]))):
        block = s1[p1 * STAGE1_ROWS:(p1 + 1) * STAGE1_ROWS]
        yield from _stage2_pages(carry, block.reshape(-1), k=k, seed=seed,
                                 mh_arg=mh_arg, aggregate=aggregate,
                                 compact=compact)


def _run_small(carry, comp, b: int, *, k, seed, mh_arg):
    s1, _ = u64.sort(comp)
    page = min(b, PAGE)
    npages = (b + page - 1) // page
    if npages * page != b:
        s1 = torch.cat([s1, torch.full((npages * page - b,), MAX,
                                       dtype=torch.int64, device=s1.device)])
    for p in range((yield from _leading_pages(s1.view(npages, page)[:, :1]))):
        yield from _append_page(carry, s1[p * page:(p + 1) * page], mh_arg,
                                k=k, seed=seed)


def _tally(stats, name: str) -> None:
    if stats is not None:
        stats[name] = stats.get(name, 0) + 1


def _worth(a, k: int):
    """The adaptive-absorb criterion on spill-encoded weighted heads (a
    0-dim bool tensor): the absorbed copies (the weight fields' sum) are
    at least a quarter of all occurrences. u64 arithmetic, as in JAX."""
    real = a != MAX
    absorbed = torch.where(real, u64.shr(a, 2 * k + 2), 0).sum()
    occ = absorbed + real.sum()
    return (absorbed != 0) & u64.le(occ, absorbed * 4)


def _kernel_step(carry, vlo, vhi, valid, thresh, hint: int, b: int, *,
                 k, seed, absorb, dedup_tier, stats, kw):
    """The kernel path of sketch_step (JAX ``_sketch_step`` :581-804): one
    extract, the tier switch, the paging of the tier's candidates; returns
    the next hint (a device tensor, or None to keep the old one)."""
    w_ok = absorb and extract.supports_weighted(k)
    weighted = w_ok and hint != 0
    if weighted:
        _tally(stats, "extract_weighted")
    cand, slab, kh_lo, kh_hi, covf, aovf = extract.extract_candidates(
        vlo, vhi, thresh.reshape(1), k=k, seed=seed, weighted=weighted)
    covf, aovf = yield torch.stack([covf, aovf])
    dirty = bool(covf or aovf)
    use_dedup = dedup_tier and dedup.supports_dedup(k, b)
    have_d2 = use_dedup and dedup.supports_dedup_slab(k, b)
    cand_d2 = None
    tier = "A"
    if dirty and use_dedup and have_d2 and not covf:
        # a complete slab: D2 collapses its duplicates, or the step pages
        # the slab (B) — D would overflow too on the same multiset
        cand_d2, d2ovf = dedup.dedup_slab_candidates(slab, k=k)
        if (yield d2ovf):
            _tally(stats, "D2_overflow")
            tier = "B"
        else:
            tier = "D2"
    elif dirty and use_dedup:
        # the slab lost survivors (covf), or there is no D2 at this shape
        cand_d, dovf = dedup.dedup_candidates(vlo, vhi, kh_lo, kh_hi,
                                              thresh.reshape(1), k=k)
        if (yield dovf):
            _tally(stats, "D_overflow")
            tier = "C" if covf else "B"
        else:
            tier = "D"
    elif dirty:
        # tier C if a chunk column overflowed (the slab lost survivors),
        # else B if the accumulator dropped some
        tier = "C" if covf else "B"
    _tally(stats, f"tier_{tier}")
    if tier == "A":
        yield from _stage2_pages(carry, cand, **kw)
    elif tier == "D2":
        yield from _stage2_pages(carry, cand_d2, compact=True, **kw)
    elif tier == "D":
        yield from _stage2_pages(carry, cand_d, compact=True, **kw)
    elif tier == "B":
        yield from _stage2_pages(carry, slab, aggregate=True, compact=True,
                                 **kw)
    else:
        keep = valid & u64.le(u64.join(kh_lo, kh_hi), thresh)
        comp = torch.where(keep, u64.join(vlo, vhi) + 1, MAX)
        yield from _run_two_stage(carry, comp, b, compact=True, **kw)
    if not w_ok:
        return None
    # adaptive-absorb feedback (JAX :764-804): a weighted step keeps the
    # hint while its own heads show absorbed mass; an unweighted step
    # engages it when D2's collapse shows it
    if weighted:
        saw = _worth(cand, k)
    elif use_dedup and have_d2:
        saw = (_worth(cand_d2, k) if cand_d2 is not None
               else torch.zeros((), dtype=torch.bool, device=vlo.device))
    else:
        saw = torch.full((), dirty and not covf, device=vlo.device)
    return saw.to(torch.int32).reshape(1)


def sketch_step(state, comp_lo, comp_hi, nvalid: int, max_hash: int,
                *, k: int, seed: int, has_max_hash: bool,
                use_kernel: bool = False, absorb: bool = True,
                dedup_tier: bool = True, stats: dict | None = None):
    """Fold one batch of canonical k-mers into the sketch state.

    The counterpart of ``finch_tpu.ops.bottomk.sketch_step`` with
    composite=True and spill compaction on, in the JAX package's default
    configuration (absorb=True: the weighted extract when the hint says
    so; dedup_tier=True: tiers D2 and D). Inputs are the parser's
    ((packed << 1) | is_rc) planes as int32 (lo, hi); nvalid (int) leading
    lanes are real; max_hash is a u64 int. The input state is not
    modified. Returns (new_state, below), below a 0-dim int64 tensor (see
    the JAX docstring). `stats`, when given, counts the tier each step
    took (tier_A, tier_D2, tier_B, tier_D, tier_C, two_stage, small), the
    weighted extracts (extract_weighted), the dedup runs that overflowed
    (D2_overflow, D_overflow) and the host syncs: one a value the step
    reads, each read at once."""
    gen = sketch_step_gen(state, comp_lo, comp_hi, nvalid, max_hash, k=k,
                          seed=seed, has_max_hash=has_max_hash,
                          use_kernel=use_kernel, absorb=absorb,
                          dedup_tier=dedup_tier, stats=stats)
    try:
        x = next(gen)
        while True:
            x = gen.send(_read(x, stats))
    except StopIteration as stop:
        return stop.value


def sketch_step_gen(state, comp_lo, comp_hi, nvalid: int, max_hash: int,
                    *, k: int, seed: int, has_max_hash: bool,
                    use_kernel: bool = False, absorb: bool = True,
                    dedup_tier: bool = True, stats: dict | None = None):
    """sketch_step as a coroutine: it yields each device tensor (0-dim or
    1-D, bool or integer) whose values it needs on the host and expects
    them sent back as ``tensor.tolist()`` gives them (a bool may come
    back as an int); it returns (new_state, below). `stats` counts the
    tallies, not the reads. Between its yields the step only enqueues
    device work and never waits on a card, so a caller that answers
    several coroutines' yields after one wait runs them side by side."""
    sh, sc, se, spk, spill, fill, hint = state
    b = comp_lo.shape[0]
    if b > (1 << 25):
        raise FinchMessageError("sketch_step batches are limited to 32M "
                                "lanes; split the batch")
    dev = sh.device
    comp64 = u64.join(comp_lo, comp_hi)
    batch_packed = u64.shr(comp64, 1)

    valid = torch.arange(b, device=dev) < nvalid
    thresh = sh[-1]
    if has_max_hash:
        thresh = u64.maximum(thresh, torch.full((), u64.to_i64(max_hash),
                                                device=dev))
    mh_arg = max_hash if has_max_hash else 0

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fill_n, hint_n = yield torch.cat([fill, hint])
    carry = _Carry((sh, sc, se, spk), spill.clone(), fill_n, zero)
    kw = dict(k=k, seed=seed, mh_arg=mh_arg)

    two_stage = (b >= STAGE1_H * STAGE2_H * 16
                 and b % (4096 * STAGE1_ROWS) == 0)

    def plain_comp():
        h = hash_packed_kmers(batch_packed, k=k, seed=seed)
        return torch.where(valid & u64.le(h, thresh), comp64 + 1, MAX)

    if use_kernel and two_stage and extract.supports(k, b):
        vlo = torch.where(valid, comp_lo, -1)
        vhi = torch.where(valid, comp_hi, -1)
        new_hint = yield from _kernel_step(
            carry, vlo, vhi, valid, thresh, hint_n, b, k=k, seed=seed,
            absorb=absorb, dedup_tier=dedup_tier, stats=stats, kw=kw)
        if new_hint is not None:
            hint = new_hint
    elif two_stage:
        _tally(stats, "two_stage")
        yield from _run_two_stage(carry, plain_comp(), b, **kw)
    else:
        _tally(stats, "small")
        yield from _run_small(carry, plain_comp(), b, **kw)

    if has_max_hash:
        # conservative bound: distinct <= max_hash in the state plus real
        # spill entries (the spill is not flushed every step)
        nsh, nsc = carry.state4[0], carry.state4[1]
        below_state = (u64.le(nsh, mh_arg) & (nsc > 0)).sum()
        spill_real = (carry.spill != MAX).sum()
        below = torch.maximum(carry.below, below_state + spill_real)
    else:
        below = zero
    new_fill = torch.full((1,), carry.fill, dtype=torch.int32, device=dev)
    return (*carry.state4, carry.spill, new_fill, hint), below


def flush_state(state, max_hash: int, *, k: int, seed: int):
    """Merge any spilled candidates into the state (finalize barrier)."""
    sh, sc, se, spk, spill, fill, hint = state
    state4, below = _flush((sh, sc, se, spk), spill, max_hash, k=k,
                           seed=seed)
    return ((*state4, torch.full_like(spill, MAX), torch.zeros_like(fill),
             hint), below)


def grow_state(state, new_capacity: int):
    """Copy state into a larger capacity buffer (scaled scheme growth);
    the spill contents carry over into the (never smaller) new spill."""
    sh, sc, se, spk, spill, fill, hint = state
    nh, nc, ne, npk, nspill, _, _ = empty_state(new_capacity,
                                                device=sh.device)
    n = sh.shape[0]
    m = spill.shape[0]
    nh[:n] = sh
    nc[:n] = sc
    ne[:n] = se
    npk[:n] = spk
    nspill[:m] = spill
    return (nh, nc, ne, npk, nspill, fill.clone(), hint.clone())


def merge_states(states, *, k: int, seed: int):
    """Associative merge of per-shard sketch states (same capacity): each
    spill is flushed, then counts add on equal hashes."""
    flushed = [_flush(tuple(s[:4]), s[4], 0, k=k, seed=seed)[0]
               for s in states]
    h = torch.cat([s[0] for s in flushed])
    order = torch.argsort(u64.key(h), stable=True)
    c = torch.cat([s[1] for s in flushed])[order]
    e = torch.cat([s[2] for s in flushed])[order]
    pk = torch.cat([s[3] for s in flushed])[order]
    cap = states[0][0].shape[0]
    merged, _ = _dedup_truncate(h[order], c, e, pk, cap)
    return (*merged, torch.full_like(states[0][4], MAX),
            torch.zeros_like(states[0][5]), torch.zeros_like(states[0][6]))
