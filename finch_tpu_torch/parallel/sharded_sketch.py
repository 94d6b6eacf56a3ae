"""Data-parallel sketching over a device mesh.

The counterpart of ``finch_tpu/parallel/sharded_sketch.py``. One logical
k-mer stream is split across the mesh's shards; each shard folds its
slice into a local bottom-k state with ``ops/bottomk.sketch_step`` (the
extract, D2 and D kernels on a card); the states merge exactly at
finalize (``bottomk.merge_states``: each spill flushed, counts added on
equal hashes), which the batch-equivalence theorem makes bit-identical
to a single stream.

What differs from the JAX package: `shard_map` runs one XLA program over
all devices, with `psum` and `all_gather` over ICI. Here the step runs
the shards in lockstep: each shard's ``bottomk.sketch_step_gen``
coroutine enqueues its device work up to its next host read, and one
host wait a round answers every shard's read (``_read_together``), so
the cards run side by side between waits and the host waits once a
round, not once a shard's read. Each shard still takes its own tier,
pages and compactions from its own flags; one that needs fewer reads
drops out of the later rounds. A scaled step's `below` is summed over
the local shards on the first device and, across processes, by
`all_reduce(SUM)`; the finalize merges the local shards on the first
device and, across processes, `all_gather`s the merged state and merges
again. Collectives carry u64 bit patterns as int64 unchanged, and only
counts are ever summed.
"""

from __future__ import annotations

import numpy as np
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.engine import (_finalize, _finalize_arrays,
                                           composite_planes)
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.ops import bottomk
from finch_tpu_torch.parallel.mesh import Mesh


class ShardedSketchEngine:
    """Mesh-parallel analog of models.engine.TorchEngine (k <= 31).

    Bit-identical to the single-device engine: each shard's prefilter
    uses its local threshold (a superset of admissions), and the final
    merge recovers the exact global bottom-k with exact counts.

    A batch of `total` k-mers splits into contiguous slices of
    `per_shard = bucket_pow2(ceil(total / n_local))` lanes (the JAX
    package's split), shard i taking [i*per_shard, (i+1)*per_shard).
    sketch_step runs the kernels only on shards of >= 131072 lanes that
    are a multiple of 16384 (`ops/bottomk.py`); a narrower shard takes
    the plain path, with the same result. `batch_size_per_device` bounds
    a shard's width: update() steps over chunks of n_local times it.

    process_local=True: multi-process mode over `mesh.group` (see
    parallel/distributed.py). Every process calls update() with ITS OWN
    part of the stream and the same number of steps (pad the last
    batch): a shard is then always bucket_pow2(batch_size_per_device)
    lanes wide, scaled steps meet in an all_reduce of `below`, and the
    finalize meets in an all_gather. A process that steps more or fewer
    times than the others hangs the group: nothing detects it.
    Exactness is order-independent, so any split of the stream is
    exact. `stats` sums sketch_step's tallies over every shard;
    `stats["syncs"]` counts the host waits (one a lockstep round, one a
    scaled step's `below` sum, and each wait for an upload buffer's
    copies that had not finished, also in `stats["upload_waits"]`) and
    `stats["shard_reads"]` the values the shards asked for (what `syncs`
    would be if each shard waited alone).
    A shard's error propagates out of update() and leaves every shard's
    state as it was before the step. `axis` is accepted for the JAX
    package's signature and not read: the mesh has one axis."""

    def __init__(self, params: SketchParams, mesh: Mesh, axis: str = "data",
                 batch_size_per_device: int = 1 << 20,
                 process_local: bool = False):
        if params.k > 31:
            raise FinchMessageError(
                "the mesh backend supports k <= 31; wide k-mers run on the "
                "numpy/native/torch backends")
        if process_local and mesh.group is None:
            raise FinchMessageError("process_local=True needs a mesh with a "
                                    "process group (distributed.global_mesh)")
        self.params = params
        self.mesh = mesh
        self.n = mesh.size
        self.n_local = len(mesh.devices)
        self.process_local = process_local
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.bpd = batch_size_per_device
        if params.sketch_type == "mash":
            self.capacity = max(1, self.size)
        else:
            self.capacity = max(2 * self.size, 1 << 12)
        self.state = self._empty_state(self.capacity)
        self._mh = self.max_hash if self.max_hash is not None else 0
        self.wants_composite = True
        self.stats: dict = {}
        # the two upload buffers, used in turn, and the events behind the
        # copies out of each (one a card)
        self._bufs = [None, None]
        self._copied = [[], []]
        self._turn = 0

    def _empty_state(self, capacity: int):
        return [bottomk.empty_state(capacity, device=d)
                for d in self.mesh.devices]

    def update(self, packed: np.ndarray, rc: np.ndarray) -> None:
        total = len(packed)
        per_dev_cap = self.n_local * self.bpd
        for off in range(0, max(total, 1), per_dev_cap):
            chunk_pk = packed[off: off + per_dev_cap]
            chunk_rc = rc[off: off + per_dev_cap]
            self._step(chunk_pk, chunk_rc)
            if len(chunk_pk) < per_dev_cap:
                break

    def _shard_planes(self, lo: np.ndarray, hi: np.ndarray, per_shard: int):
        """Each local shard's (lo, hi, nvalid): its contiguous slice,
        zero-padded to per_shard lanes, on its device. Every shard's copy
        starts before any shard steps, from one of two persistent host
        buffers used in turn (pinned when the shards are cards), so no
        copy waits on a card and no step allocates pinned memory."""
        devices = self.mesh.devices
        j = self._turn
        self._turn ^= 1
        self._wait_copies(j)
        need = len(devices) * 2 * per_shard
        if self._bufs[j] is None or self._bufs[j].numel() < need:
            self._bufs[j] = torch.empty(
                need, dtype=torch.int32,
                pin_memory=any(d.type == "cuda" for d in devices))
        host = self._bufs[j][:need].view(len(devices), 2, per_shard)
        buf = host.numpy().view(np.uint32)
        out = []
        total = len(lo)
        for i, dev in enumerate(devices):
            a = min(i * per_shard, total)
            b = min((i + 1) * per_shard, total)
            buf[i, 0, :b - a] = lo[a:b]
            buf[i, 1, :b - a] = hi[a:b]
            buf[i, :, b - a:] = 0
            # a copy on the CPU too: the buffer is refilled two steps on
            planes = host[i].to(dev, non_blocking=True, copy=True)
            out.append((planes[0], planes[1], b - a))
        self._copied[j] = [torch.cuda.current_stream(d).record_event()
                           for d in dict.fromkeys(devices) if d.type == "cuda"]
        return out

    def _wait_copies(self, j: int) -> None:
        """Wait until the copies out of upload buffer j are done. They
        were issued two steps ago, and every shard's reads since waited
        behind them on its card, so this wait does not block the host; one
        that would is counted in `syncs` and `upload_waits`."""
        for ev in self._copied[j]:
            if not ev.query():
                for name in ("syncs", "upload_waits"):
                    self.stats[name] = self.stats.get(name, 0) + 1
                ev.synchronize()

    def _step(self, pk: np.ndarray, rc: np.ndarray) -> None:
        if pk.dtype != np.uint32:
            pk, rc = composite_planes(pk, rc)
        n = self.n_local
        # multi-process: every process's shards must keep one shape, so the
        # shard width is the fixed bpd, not data-derived
        per_shard = (bottomk.bucket_pow2(self.bpd) if self.process_local
                     else bottomk.bucket_pow2(-(-len(pk) // n)))
        shards = self._shard_planes(pk, rc, per_shard)
        is_scaled = self.params.sketch_type == "scaled"
        while True:
            new_states, belows = zip(*self._lockstep([
                bottomk.sketch_step_gen(
                    st, lo, hi, nvalid, self._mh, k=self.params.k,
                    seed=self.params.hash_seed, has_max_hash=is_scaled,
                    use_kernel=True, stats=self.stats)
                for st, (lo, hi, nvalid) in zip(self.state, shards)]))
            new_states = list(new_states)
            if not is_scaled:
                self.state = new_states
                return
            below_total = self._global_sum(belows)
            if below_total + self.size <= self.capacity:
                self.state = new_states
                return
            # every process reads the same global sum, so all grow alike
            # and the shards keep one capacity; redo from the old states
            new_cap = max(self.capacity * 2, below_total + self.size)
            self.state = [bottomk.grow_state(s, new_cap) for s in self.state]
            self.capacity = new_cap

    def _lockstep(self, gens):
        """The `shard_map` step: each round runs every unfinished shard's
        coroutine to its next read, then answers all the reads after one
        host wait. Returns each coroutine's (new_state, below)."""
        out = [None] * len(gens)
        answers = [None] * len(gens)
        live = range(len(gens))
        while True:
            asks, waiting = [], []
            for i in live:
                try:
                    asks.append(gens[i].send(answers[i]))
                except StopIteration as stop:
                    out[i] = stop.value
                else:
                    waiting.append(i)
            if not waiting:
                return out
            for i, v in zip(waiting, _read_together(asks)):
                answers[i] = v
            self.stats["syncs"] = self.stats.get("syncs", 0) + 1
            self.stats["shard_reads"] = (self.stats.get("shard_reads", 0)
                                         + len(asks))
            live = waiting

    def _global_sum(self, belows) -> int:
        """The JAX psum: the local shards' `below` summed on the first
        device, then over the process group; one host read."""
        dev0 = self.mesh.devices[0]
        total = torch.stack([b.to(dev0) for b in belows]).sum()
        if self.process_local:
            import torch.distributed as tdist

            tdist.all_reduce(total, op=tdist.ReduceOp.SUM,
                             group=self.mesh.group)
        self.stats["syncs"] = self.stats.get("syncs", 0) + 1
        return int(total)

    def _merged_state(self):
        """Every shard merged into one state on the first device; across
        processes, the all_gather of each process's merge, merged again
        (every rank gets the same state: the merge is associative)."""
        k, seed = self.params.k, self.params.hash_seed
        dev0 = self.mesh.devices[0]
        merged = bottomk.merge_states(
            [tuple(t.to(dev0) for t in s) for s in self.state],
            k=k, seed=seed)
        if self.process_local:
            import torch.distributed as tdist

            # a merged state's spill is empty, so its four arrays suffice
            mine = torch.stack(merged[:4])
            parts = [torch.empty_like(mine)
                     for _ in range(self.mesh.world_size)]
            tdist.all_gather(parts, mine, group=self.mesh.group)
            merged = bottomk.merge_states(
                [(*p.unbind(0), *merged[4:]) for p in parts], k=k, seed=seed)
        return merged

    def _merged_arrays(self):
        return tuple(u64.to_numpy(t) for t in self._merged_state()[:4])

    def finalize(self):
        return _finalize(self.params, *self._merged_arrays())

    def finalize_arrays(self):
        return _finalize_arrays(self.params, *self._merged_arrays())


def _read_together(tensors):
    """The host values of `tensors` (each 0-dim or 1-D, bool or integer,
    on any of the mesh's devices) after one wait, each as ``tolist()``
    gives it (a bool may come back as an int). One concatenation a device
    (torch.cat promotes bools and narrower integers); with several
    devices, each card's is copied into pinned host memory on its current
    stream and an event recorded behind the copy, and the events are
    waited on only once every copy has been enqueued."""
    by_dev = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    flat = {d: torch.cat([tensors[i].reshape(-1) for i in idx])
            for d, idx in by_dev.items()}
    if len(flat) == 1:
        values = {d: x.tolist() for d, x in flat.items()}
    else:
        hosts, events = {}, []
        for d, x in flat.items():
            if d.type == "cuda":
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                events.append(torch.cuda.current_stream(d).record_event())
                x = host
            hosts[d] = x
        for ev in events:
            ev.synchronize()
        values = {d: x.tolist() for d, x in hosts.items()}
    out = [None] * len(tensors)
    for d, idx in by_dev.items():
        pos = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = (values[d][pos] if tensors[i].dim() == 0
                      else values[d][pos:pos + n])
            pos += n
    return out


def sharded_state_from_numpy(arrays, mesh: Mesh):
    """Per-shard states, one on each of `mesh.devices`, from the JAX
    package's sharded state rows: its 7-tuple of (n, ...) arrays
    (``np.asarray(engine.state[i])``), row i for shard i."""
    n = len(mesh.devices)
    if any(np.asarray(a).shape[0] != n for a in arrays):
        raise FinchMessageError(f"sharded state rows must number {n}, the "
                                "mesh's local shards")
    return [bottomk.state_from_numpy([np.asarray(a)[i] for a in arrays], dev)
            for i, dev in enumerate(mesh.devices)]


def sharded_state_to_numpy(engine: ShardedSketchEngine):
    """Inverse of sharded_state_from_numpy: a ShardedSketchEngine's
    per-shard states as the JAX package's 7-tuple of (n, ...) rows."""
    rows = [bottomk.state_to_numpy(s) for s in engine.state]
    return tuple(np.stack(col) for col in zip(*rows))
