"""Query-vs-DB distance statistics on the card, in tiles of refs.

The counterpart of ``finch_tpu/parallel/sharded_dist.py`` on one card.
The reference computes distances in a serial double loop of two-pointer
merges (finch-rs/cli/src/main.rs:315-334, lib/src/distance.rs:66-126).
Here each (query, ref) pair's integer statistics (common, i, j) are
computed on the card and the f64 distance formula is applied on host
(cli.py) for exact JSON parity.

The JAX package merges each pair's two sorted hash lists with a bitonic
network over (2K, pairs) lanes, because per-pair searches are slow on a
TPU. On the card a batched `torch.searchsorted` is the natural form, and
an exact one: for a tile of refs, every ref hash is searched in every
query row (common = the hits), and the closed-form pointer end state
(core/distance.py) is two more searches, of m = min(max_q, max_r) into
the query rows and into the ref rows. All compares are in u64 order
(``u64.key``), so hashes >= 2^63 order correctly and the U64_MAX pads sort
last. A tile holds about 16M lanes (`_pick_tile`), which bounds memory.

The mesh form (`all_vs_all_arrays(mesh=)`, the JAX package's
`_sharded_pairs_stats`) shards the refs over the mesh: each shard runs
the tile loop over its slice on its device, the slices join in shard
order, and across processes by `all_gather`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from finch_tpu_torch import u64
from finch_tpu_torch.models.engine import resolve_device

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
PAD_KEY = u64.MAX ^ u64.SIGN    # the pad's key: the largest int64
ZERO_KEY = u64.SIGN             # key of 0, an empty sketch's maximum


def _tile_stats(qkeys, qmax, nq, rkeys, rmax, nr, tail_q, tail_r):
    """Integer stats for all (query, ref-in-tile) pairs.

    qkeys: (Q, Kp) ascending u64 keys (``u64.key``) with padding; rkeys:
    (Rt, Kp); qmax/rmax the keys of each sketch's largest hash; tail_q /
    tail_r each sketch's scaled-tail count, or None. Returns (common, i,
    j) of shape (Q, Rt), int64."""
    q, kp = qkeys.shape
    rt = rkeys.shape[0]
    # common: each ref hash searched in each query row
    vals = rkeys.reshape(1, rt * kp).expand(q, rt * kp).contiguous()
    pos = torch.searchsorted(qkeys, vals).clamp_(max=kp - 1)
    hit = (torch.gather(qkeys, 1, pos) == vals) & (vals != PAD_KEY)
    common = hit.view(q, rt, kp).sum(dim=2)

    # closed-form pointer end state: m = min(max(q), max(r));
    # i = #{q <= m}; j = #{r <= m}
    m = torch.minimum(qmax[:, None], rmax[None, :])          # (Q, Rt)
    i = torch.searchsorted(qkeys, m, right=True)
    j = torch.searchsorted(rkeys, m.T.contiguous(), right=True).T
    both = (nq > 0)[:, None] & (nr > 0)[None, :]
    i = torch.where(both, i, 0)
    j = torch.where(both, j, 0)
    if tail_q is not None:
        # scaled tail (distance.rs:99-115): advance past hashes < max_hash
        i = torch.maximum(i, tail_q[:, None])
        j = torch.maximum(j, tail_r[None, :])
    return common, i, j


def _pairs_stats_tiled(qpad, nq, rpad, nr, max_hash: int, *, tile: int):
    """(common, i, j) int64 tensors of shape (Q, R) on the hashes'
    device: a loop over ref tiles of `tile`."""
    q, kp = qpad.shape
    r = rpad.shape[0]
    dev = qpad.device
    out = torch.zeros((3, q, r), dtype=torch.int64, device=dev)
    if r == 0 or q == 0:
        return out[0], out[1], out[2]
    qkeys = u64.key(qpad)
    rkeys = u64.key(rpad)
    # a sketch's largest hash is its last real entry (0 when empty)
    qmax = torch.where(nq > 0, qkeys.gather(
        1, (nq - 1).clamp(min=0)[:, None])[:, 0], ZERO_KEY)
    rmax = torch.where(nr > 0, rkeys.gather(
        1, (nr - 1).clamp(min=0)[:, None])[:, 0], ZERO_KEY)
    tail_q = tail_r = None
    if max_hash > 0:
        mh = u64.to_i64(max_hash) ^ u64.SIGN
        tail_q = torch.searchsorted(
            qkeys, torch.full((q, 1), mh, device=dev))[:, 0]
        tail_r = torch.searchsorted(
            rkeys, torch.full((r, 1), mh, device=dev))[:, 0]
    for r0 in range(0, r, tile):
        r1 = min(r0 + tile, r)
        with record_function("dist.tile_stats"):
            stats = _tile_stats(
                qkeys, qmax, nq, rkeys[r0:r1], rmax[r0:r1], nr[r0:r1],
                tail_q, None if tail_r is None else tail_r[r0:r1])
            for o, s in zip(out, stats):
                o[:, r0:r1] = s
    return out[0], out[1], out[2]


def _pick_tile(q: int, kp: int) -> int:
    """Ref-tile width: keep the merge tile around <=16M lanes."""
    budget = max(1, (1 << 23) // max(1, 2 * kp * q))
    t = 1
    while t * 2 <= budget:
        t *= 2
    return t


def pad_hashes(sketch_hashes: List[np.ndarray],
               k_pad: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length sorted hash arrays into (N, K) with U64_MAX
    padding (power-of-two K, as the JAX package's merge network wants);
    returns (padded, lengths)."""
    n = len(sketch_hashes)
    k_pad = k_pad or max((len(h) for h in sketch_hashes), default=1)
    kp = 1
    while kp < max(k_pad, 1):
        kp *= 2
    out = np.full((n, kp), U64_MAX, dtype=np.uint64)
    lens = np.zeros(n, dtype=np.uint32)
    for i, h in enumerate(sketch_hashes):
        out[i, : len(h)] = h
        lens[i] = len(h)
    return out, lens


def _sharded_pairs_stats(q, nq, r, nr, max_hash: int, mesh):
    """(3, Q, R_pad) int64 on the mesh's first device: global shard g
    takes refs [g*per, (g+1)*per) with per = R_pad / mesh.size, on its
    device, in ref tiles of min(_pick_tile(Q, Kp), per)."""
    n_loc = len(mesh.devices)
    per = r.shape[0] // mesh.size
    tile = max(1, min(_pick_tile(q.shape[0], q.shape[1]), per))
    dev0 = mesh.devices[0]
    outs = []
    for i, dev in enumerate(mesh.devices):
        g = mesh.rank * n_loc + i
        rs = slice(g * per, (g + 1) * per)
        stats = _pairs_stats_tiled(
            u64.from_numpy(q, dev),
            torch.from_numpy(nq.astype(np.int64)).to(dev),
            u64.from_numpy(r[rs], dev),
            torch.from_numpy(nr[rs].astype(np.int64)).to(dev),
            max_hash, tile=tile)
        outs.append(torch.stack(stats).to(dev0))
    local = torch.cat(outs, dim=2)
    if mesh.group is None:
        return local
    import torch.distributed as tdist

    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    tdist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts, dim=2)


def all_vs_all_arrays(query_hashes: List[np.ndarray],
                      ref_hashes: List[np.ndarray],
                      scale: float = 0.0, device="cuda", mesh=None,
                      axis=None):
    """Integer distance stats for all (query, ref) pairs.

    Returns (common, i, j) uint64 arrays of shape (Q, R). Callers apply the
    f64 containment/jaccard/mash formula on host (core/distance.py).
    With `mesh` (parallel/mesh.py), the refs, padded to a multiple of
    mesh.size, are sharded over it and `device` is not read. `axis` is
    accepted for the JAX package's signature and not read: the mesh has
    one axis.

    Precondition: u64::MAX is reserved as the pad sentinel. A genuine hash
    equal to u64::MAX (probability ~n/2^64 per sketch) would be mistaken
    for padding, so such inputs are rejected here; route them through the
    exact serial engine (core/distance.py) instead — the CLI does this
    automatically via ``_uniform_dist_params``.
    """
    from finch_tpu_torch.core.distance import scale_recip_max_hash

    for h in (*query_hashes, *ref_hashes):
        if len(h) and np.uint64(h[-1]) == U64_MAX:
            raise ValueError(
                "sketch contains hash u64::MAX, which collides with the "
                "device pad sentinel; use the serial distance engine")

    kq = max((len(h) for h in query_hashes), default=1)
    kr = max((len(h) for h in ref_hashes), default=1)
    kpad = max(kq, kr, 1)
    q, nq = pad_hashes(query_hashes, kpad)
    r, nr = pad_hashes(ref_hashes, kpad)
    max_hash = scale_recip_max_hash(scale) if scale > 0.0 else 0
    if mesh is not None:
        n_r = r.shape[0]
        pad_r = (-n_r) % mesh.size
        r = np.concatenate(
            [r, np.full((pad_r, r.shape[1]), U64_MAX, dtype=np.uint64)])
        nr = np.concatenate([nr, np.zeros(pad_r, dtype=nr.dtype)])
        out = _sharded_pairs_stats(q, nq, r, nr, max_hash, mesh)
        return tuple(s.cpu().numpy()[:, :n_r].astype(np.uint64)
                     for s in out)
    dev = resolve_device(device)
    tile = _pick_tile(q.shape[0], q.shape[1])
    stats = _pairs_stats_tiled(
        u64.from_numpy(q, dev), torch.from_numpy(nq.astype(np.int64)).to(dev),
        u64.from_numpy(r, dev), torch.from_numpy(nr.astype(np.int64)).to(dev),
        max_hash, tile=tile)
    return tuple(s.cpu().numpy().astype(np.uint64) for s in stats)
