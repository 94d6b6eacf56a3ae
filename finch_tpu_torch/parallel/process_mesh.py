"""The mesh over several cards as one worker process a card, fed from one
parse.

The JAX package's mesh step is one `shard_map` program, and every chip
folds its shard at once. In one Python process the cards wait on the one
thread that issues every card's calls (``ShardedSketchEngine``'s
lockstep; PERF.md). Here each card has a process of its own, with its own
interpreter, and folds whole batches with the one-card ``TorchEngine``,
unchanged: the extract, D2 and D kernels at the full batch width. The
parent parses the file once, straight into the workers' shared-memory
slots, and deals batch i to worker ``i mod N``. At the end every worker
flushes its state and the parent merges them exactly (``merge_flushed``,
``bottomk.merge_states``' merge in NumPy): the batch-equivalence theorem
makes any split of the stream give the single stream's sketch.

The pool (``WorkerPool``):

* one ``spawn`` process an entry of a device list (``fork`` is unsafe once
  CUDA or threads run in the parent). Entries may repeat: repeated
  entries are logical cards that share one card or the CPU, as in
  ``Mesh``;
* each worker owns `SLOTS` slots of ``2 x batch_size`` u32 (the composite
  lo and hi planes) in one ``multiprocessing.shared_memory`` segment that
  the parent creates and unlinks. A CUDA worker pins its segment
  (``cudaHostRegister``), so a batch's upload is a DMA from pinned
  memory, and raises if it cannot;
* one pipe a worker carries ``("step", stream, slot, n)`` one way and
  ``("free", slot)`` back (sent once the batch is on the card, before the
  step runs), besides the stream's open and finalize;
* a worker keeps one ``TorchEngine`` an open stream, keyed by the
  stream's id, so several files (``sketch_files``' threads) share the
  pool;
* it starts once a process, at first use (``get_pool``), and every later
  engine of the same devices and batch size reuses it; it closes at exit
  and unlinks its shared memory. Its start-up (spawn, import, the card's
  context, the kernels' libraries) runs while the parent parses; the
  kernels are built by the parent first (one nvcc a source), so workers
  only load them.

No fallback: a worker that raises, or dies, makes the parent raise
``FinchMessageError`` (a ``FinchError``) with the worker's traceback at
its next hand-off or at finalize; every wait of the parent has a bound
and checks that its workers are alive; on any error the pool stops every
worker and unlinks its shared memory. Nothing goes on on fewer cards.
"""

from __future__ import annotations

import atexit
import itertools
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import threading
import time
import traceback
from multiprocessing.shared_memory import SharedMemory
from typing import NamedTuple

import numpy as np
import torch

from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.engine import (_finalize, _finalize_arrays,
                                           composite_planes, resolve_device)
from finch_tpu_torch.models.params import SketchParams

SLOTS = 3                 # shared-memory slots a worker
START_TIMEOUT_S = 600.0   # a worker's start-up: imports, context, kernels
WAIT_TIMEOUT_S = 300.0    # any other wait: a free slot, a flushed state
KERNELS = ("extract", "extract_weighted", "dedup", "dedup_slab")


class Slot(NamedTuple):
    """A worker's slot: the composite lo and hi planes a batch is parsed
    into, `batch_size` u32 each, in the worker's shared memory."""
    worker: int
    index: int
    lo: np.ndarray
    hi: np.ndarray


def read_launches() -> dict:
    """This process's kernel launch counters (the wrappers' own)."""
    from finch_tpu_torch.ops import dedup, extract

    return {"extract": extract.extract_candidates.launches,
            "extract_weighted": extract.extract_candidates.launches_weighted,
            "dedup": dedup.dedup_candidates.launches,
            "dedup_slab": dedup.dedup_slab_candidates.launches}


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

class _Stream:
    """A worker's share of one stream: its engine and tallies."""

    def __init__(self, engine, trace: bool):
        self.engine = engine
        self.launches = dict.fromkeys(KERNELS, 0)
        self.widths = {n: set() for n in KERNELS}
        self.steps = 0
        self.step_s = 0.0   # the worker's wall in steps, uploads included
        self.prof = None
        self.anchor_ns = 0
        if trace:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            # the profiler's clock against time.monotonic_ns, which every
            # process of the host shares
            self.anchor_ns = time.monotonic_ns()
            with torch.profiler.record_function("finch.anchor"):
                pass

    def device_intervals(self) -> list:
        """The device work this worker traced (kernels, copies, sets), as
        (start_ns, end_ns) on time.monotonic_ns; [] when not traced."""
        if self.prof is None:
            return []
        self.prof.__exit__(None, None, None)
        events = self.prof.events()
        anchor = next(e for e in events if e.name == "finch.anchor")
        offset = self.anchor_ns - int(anchor.time_range.start * 1000)
        return [(int(e.time_range.start * 1000) + offset,
                 int(e.time_range.end * 1000) + offset)
                for e in events
                if str(e.device_type).endswith("CUDA")
                and not e.is_user_annotation]


def _load_kernels() -> None:
    """Load the kernels' libraries (built by the parent) into this worker;
    raises if one cannot be loaded."""
    from finch_tpu_torch.ops import cuda_lib, dedup, extract

    cuda_lib.function("extract", "finch_extract", extract._declare)
    for fn in ("finch_dedup", "finch_dedup_slab"):
        cuda_lib.function("dedup", fn, dedup._declare)


def _worker_main(conn, index: int, device: str, shm_name: str, nslots: int,
                 batch_size: int, n_workers: int) -> None:
    """A worker's life: start up, then serve the parent's messages until
    it says "close" or goes away. Any error is sent to the parent as its
    traceback, and the worker exits."""
    shm = host = None
    pinned = False
    # start-up phases on time.monotonic: the interpreter and its imports
    # end where this function starts
    marks = {"imported": time.monotonic()}
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)  # the card's context
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_workers))
        marks["context"] = time.monotonic()
        shm = SharedMemory(name=shm_name)
        host = torch.from_numpy(np.ndarray(
            (nslots, 2, batch_size), dtype=np.int32, buffer=shm.buf))
        if dev.type == "cuda":
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostRegister(host.data_ptr(),
                                          host.numel() * 4, 0)
            if err != cudart.cudaError.success or not host.is_pinned():
                raise RuntimeError(f"cudaHostRegister of the slots failed: "
                                   f"{err}")
            pinned = True
            marks["pinned"] = time.monotonic()
            _load_kernels()
            marks["kernels"] = time.monotonic()
        conn.send(("ready", index, os.getpid(), marks))
        _serve(conn, index, dev, host, batch_size)
    except BaseException:
        try:
            conn.send(("error", index, traceback.format_exc()))
        except OSError:
            pass  # the parent is gone
    finally:
        if pinned:
            torch.cuda.cudart().cudaHostUnregister(host.data_ptr())
        host = None
        if shm is not None:
            try:
                shm.close()
            except BufferError:
                pass  # the mapping goes with the process


def _serve(conn, index: int, dev: torch.device, host: torch.Tensor,
           batch_size: int) -> None:
    from finch_tpu_torch.models.engine import TorchEngine
    from finch_tpu_torch.ops import bottomk

    streams = {}
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return  # the parent is gone
        op = msg[0]
        if op == "close":
            return
        if op == "open":
            _, sid, params, trace = msg
            streams[sid] = _Stream(
                TorchEngine(params, batch_size=batch_size, device=dev),
                trace)
        elif op == "step":
            _, sid, j, n = msg
            t = time.perf_counter()
            st = streams[sid]
            b = bottomk.bucket_pow2(n)
            planes = torch.empty((2, b), dtype=torch.int32, device=dev)
            for p in (0, 1):
                planes[p, :n].copy_(host[j, p, :n], non_blocking=True)
            planes[:, n:].zero_()
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            conn.send(("free", index, j))
            before = read_launches()
            st.engine.step_planes(planes[0], planes[1], n)
            after = read_launches()
            for name in KERNELS:
                if after[name] > before[name]:
                    st.launches[name] += after[name] - before[name]
                    st.widths[name].add(b)
            st.steps += 1
            st.step_s += time.perf_counter() - t
        elif op == "finalize":
            _, sid = msg
            t = time.perf_counter()
            st = streams.pop(sid)
            h, c, e, pk = st.engine._host_state()
            conn.send(("state", index, sid, {
                "arrays": (h, c, e, pk), "stats": st.engine.stats,
                "launches": st.launches,
                "widths": {n: sorted(w) for n, w in st.widths.items()},
                "steps": st.steps, "step_s": st.step_s,
                "flush_s": time.perf_counter() - t,
                "intervals": st.device_intervals()}))
        elif op == "drop":
            streams.pop(msg[1], None)
        else:
            raise RuntimeError(f"unknown message {op!r}")


# ---------------------------------------------------------------------------
# the pool (parent side)
# ---------------------------------------------------------------------------

class WorkerPool:
    """One worker process an entry of `devices`, each with SLOTS slots of
    2 x `batch_size` u32 in shared memory. See the module docstring.
    `startup_s` is the time from the pool's start to its last worker's
    "ready" (None until every worker has been waited for), and
    `startup_phases` each worker's own marks on that clock: `imported`
    (spawned, its interpreter up, torch and this module imported),
    `context` (the card's context made), `pinned` and `kernels` (the
    slots pinned, the kernels' libraries loaded; cards only);
    `worker_pids` the workers' process ids."""

    def __init__(self, devices, batch_size: int):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise FinchMessageError("a worker pool needs at least one device")
        self.batch_size = int(batch_size)
        self.nslots = SLOTS
        self.t_start = time.monotonic()
        self.startup_s = None
        self.closed = False
        self._lock = threading.RLock()
        self._ids = itertools.count()
        n = len(self.devices)
        self._shm, self._views, self._procs, self._conns = [], [], [], []
        self._free = [set(range(self.nslots)) for _ in range(n)]
        self._ready = [None] * n
        self.worker_pids = [None] * n
        self.startup_phases = [None] * n
        self._states = {}
        if any(d.type == "cuda" for d in self.devices):
            from finch_tpu_torch.ops import cuda_lib

            for name in cuda_lib.SOURCES:  # cached: a hash and a stat
                cuda_lib.build(name)
        ctx = mp.get_context("spawn")
        try:
            for i, dev in enumerate(self.devices):
                shm = SharedMemory(create=True,
                                   size=self.nslots * 2 * self.batch_size * 4)
                self._shm.append(shm)
                self._views.append(np.ndarray(
                    (self.nslots, 2, self.batch_size), dtype=np.uint32,
                    buffer=shm.buf))
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main, name=f"finch-mesh-{i}", daemon=True,
                    args=(child, i, str(dev), shm.name, self.nslots,
                          self.batch_size, n))
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
        except BaseException:
            self.close()
            raise

    @property
    def size(self) -> int:
        return len(self.devices)

    def shm_names(self) -> list:
        return [s.name for s in self._shm]

    # -- waiting ----------------------------------------------------------

    def _fail(self, message: str):
        self.close()
        raise FinchMessageError(message)

    def _drain(self) -> None:
        """Read every message already sent (under the lock)."""
        for w, conn in enumerate(self._conns):
            while True:
                try:
                    if not conn.poll(0):
                        break
                    msg = conn.recv()
                except (EOFError, OSError):
                    break  # a dead worker: _check reports it
                op = msg[0]
                if op == "free":
                    self._free[w].add(msg[2])
                elif op == "ready":
                    self._ready[w] = max(msg[3].values())
                    self.worker_pids[w] = msg[2]
                    self.startup_phases[w] = {
                        name: t - self.t_start for name, t in msg[3].items()}
                    if all(t is not None for t in self._ready):
                        self.startup_s = max(self._ready) - self.t_start
                elif op == "state":
                    self._states[(msg[2], w)] = msg[3]
                elif op == "error":
                    self._fail(f"mesh worker {w} on {self.devices[w]} "
                               f"failed:\n{msg[2]}")

    def _check(self) -> None:
        if self.closed:
            raise FinchMessageError("the mesh's worker pool is closed")
        for w, proc in enumerate(self._procs):
            if not proc.is_alive():
                self._fail(f"mesh worker {w} on {self.devices[w]} died "
                           f"(exit code {proc.exitcode})")

    def _wait(self, pred, what: str, timeout: float):
        """pred()'s first truthy value, read under the lock after draining
        the workers' messages; raises once `timeout` seconds pass, a worker
        dies or reports an error."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                self._check()
                self._drain()
                got = pred()
                if got:
                    return got
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"mesh worker pool: no {what} within "
                           f"{timeout:.0f} s")
            mpc.wait(self._conns + [p.sentinel for p in self._procs],
                     timeout=min(left, 0.5))

    def wait_ready(self) -> float:
        """Wait until every worker has started; returns `startup_s`."""
        self._wait(lambda: self.startup_s is not None, "start-up of every "
                   "worker", START_TIMEOUT_S)
        return self.startup_s

    def _send(self, w: int, msg) -> None:
        with self._lock:
            self._check()
            try:
                self._conns[w].send(msg)
            except OSError as err:
                # the worker's end closed: it is dying, if not yet reaped
                self._procs[w].join(timeout=5)
                self._check()
                self._fail(f"mesh worker {w} on {self.devices[w]} went "
                           f"away: {err!r}")

    # -- streams ----------------------------------------------------------

    def open(self, params: SketchParams, trace: bool = False) -> int:
        sid = next(self._ids)
        for w in range(self.size):
            self._send(w, ("open", sid, params, trace))
        return sid

    def take_slot(self, w: int) -> Slot:
        """A free slot of worker w, once it has started and freed one."""

        def free():
            if self._ready[w] is not None and self._free[w]:
                j = min(self._free[w])
                self._free[w].discard(j)
                return Slot(w, j, self._views[w][j, 0], self._views[w][j, 1])
            return None

        started = self._ready[w] is not None
        return self._wait(free, f"free slot of worker {w}",
                          WAIT_TIMEOUT_S if started else START_TIMEOUT_S)

    def give_back(self, slot: Slot) -> None:
        with self._lock:
            self._free[slot.worker].add(slot.index)

    def step(self, sid: int, slot: Slot, n: int) -> None:
        self._send(slot.worker, ("step", sid, slot.index, int(n)))

    def finalize(self, sid: int) -> list:
        """Every worker's flushed share of stream `sid`, in worker order."""
        for w in range(self.size):
            self._send(w, ("finalize", sid))

        def done():
            keys = [(sid, w) for w in range(self.size)]
            if all(k in self._states for k in keys):
                return [self._states.pop(k) for k in keys]
            return None

        return self._wait(done, "flushed state", WAIT_TIMEOUT_S)

    def drop(self, sid: int) -> None:
        for w in range(self.size):
            self._send(w, ("drop", sid))

    def close(self) -> None:
        """Stop every worker (asked, then terminated, then killed) and
        unlink the shared memory. Idempotent."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            for conn in self._conns:
                try:
                    conn.send(("close",))
                except OSError:
                    pass
            for proc in self._procs:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5)
            for conn in self._conns:
                conn.close()
            self._views = []
            for shm in self._shm:
                try:
                    shm.close()
                except BufferError:
                    pass  # a caller still holds a slot's view; unlink anyway
                shm.unlink()
            self._shm = []
        with _pools_lock:
            for key, pool in list(_pools.items()):
                if pool is self:
                    del _pools[key]


_pools: dict = {}
_pools_lock = threading.RLock()  # a pool that fails to start closes under it


def get_pool(devices, batch_size: int) -> WorkerPool:
    """The process's pool for these devices and batch size, started at
    first use and reused by every later engine; closed at exit."""
    key = (tuple(str(resolve_device(d)) for d in devices), int(batch_size))
    with _pools_lock:
        pool = _pools.get(key)
        if pool is None or pool.closed:
            pool = _pools[key] = WorkerPool(devices, batch_size)
        return pool


@atexit.register
def close_pools() -> None:
    """Close every pool this process started (also at exit)."""
    with _pools_lock:
        pools = list(_pools.values())
    for pool in pools:
        pool.close()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def merge_flushed(parts, capacity: int):
    """The exact merge of flushed states, `bottomk.merge_states`' on the
    host in NumPy: each part is (h, c, e, pk) u64 arrays, ascending by
    hash with empty slots (count 0) last, as a flushed state is. Counts
    and extras add on equal hashes, a run keeps its last payload, and the
    result is cut to `capacity` entries. Empty slots are dropped before
    the sort, so a real u64::MAX hash keeps its own payload. (The torch
    merge on the host's CPU took about a third of the isolate's wall on
    four cards: PERF.md §6.)"""
    h, c, e, pk = (np.concatenate([np.asarray(p[i], dtype=np.uint64)
                                   for p in parts]) for i in range(4))
    real = c > 0
    h, c, e, pk = h[real], c[real], e[real], pk[real]
    order = np.argsort(h, kind="stable")
    h, c, e, pk = h[order], c[order], e[order], pk[order]
    if len(h):
        new = np.empty(len(h), dtype=bool)
        new[0] = True
        np.not_equal(h[1:], h[:-1], out=new[1:])
        starts = np.flatnonzero(new)
        ends = np.append(starts[1:], len(h)) - 1
        h, pk = h[starts], pk[ends]
        c, e = np.add.reduceat(c, starts), np.add.reduceat(e, starts)
    return h[:capacity], c[:capacity], e[:capacity], pk[:capacity]


class ProcessMeshEngine:
    """The mesh engine that `sketch_stream` sees (k <= 31): batch i of the
    stream folds in worker i mod N, a full batch at a time, and the
    workers' flushed states merge exactly at finalize.

    `sketch_stream` parses straight into the workers' slots: it takes
    `next_slot()`, has the reader fill the slot's planes, and hands it
    back with `submit(slot, n)` (n == 0 returns the slot unused).
    `update(packed, rc)` copies a batch into slots for callers that hold
    arrays. `trace=True` has every worker record its device work under
    torch.profiler, on time.monotonic_ns (`stats["intervals"]`, one list
    a worker; it slows the host). After finalize `stats` sums the
    workers' TorchEngine tallies and adds `launches` (each kernel's
    launches, summed over the workers' own counters: this process's stay
    0), `widths` (the lane widths each kernel ran at), `worker_steps`,
    `capacities` (each worker's state after its own growth) and `times`
    (seconds: this process's waits for a free slot, each worker's wall in
    its steps and in its flush, the wait for every flushed state, the
    merge)."""

    def __init__(self, params: SketchParams, devices, batch_size: int = 1 << 21,
                 trace: bool = False):
        if params.k > 31:
            raise FinchMessageError(
                "the mesh backend supports k <= 31; wide k-mers run on the "
                "numpy/native/torch backends")
        self.params = params
        self.batch_size = int(batch_size)
        self.pool = get_pool(devices, self.batch_size)
        self.n = self.pool.size
        self.wants_composite = True
        self.takes_slots = True
        self.stats: dict = {}
        self._i = 0
        self._slot_wait_s = 0.0
        self._sid = self.pool.open(params, trace)
        self._open = True

    def next_slot(self) -> Slot:
        """The slot the stream's next batch goes into: one of worker
        (batch number mod N)'s, once it is free."""
        w = self._i % self.n
        self._i += 1
        t = time.perf_counter()
        slot = self.pool.take_slot(w)
        self._slot_wait_s += time.perf_counter() - t
        return slot

    def submit(self, slot: Slot, n: int) -> None:
        """Fold the slot's first n lanes in its worker (the slot returns to
        the pool once they are on the worker's card)."""
        if n:
            self.pool.step(self._sid, slot, n)
        else:
            self.pool.give_back(slot)

    def update(self, packed: np.ndarray, rc: np.ndarray) -> None:
        if packed.dtype != np.uint32:
            packed, rc = composite_planes(packed, rc)
        for off in range(0, len(packed), self.batch_size):
            lo = packed[off: off + self.batch_size]
            slot = self.next_slot()
            slot.lo[:len(lo)] = lo
            slot.hi[:len(lo)] = rc[off: off + self.batch_size]
            self.submit(slot, len(lo))

    def close(self) -> None:
        """Drop the stream's state in the workers (after an error; the
        finalize drops it otherwise)."""
        if self._open and not self.pool.closed:
            self._open = False
            self.pool.drop(self._sid)

    def _merged_arrays(self):
        t0 = time.perf_counter()
        parts = self.pool.finalize(self._sid)
        t1 = time.perf_counter()
        self._open = False
        caps = [len(p["arrays"][0]) for p in parts]
        merged = merge_flushed(
            [p["arrays"] for p in parts],
            # scaled workers grew apart: their union fits the summed slots
            sum(caps) if self.params.sketch_type == "scaled" else caps[0])
        stats = {}
        for p in parts:
            for name, v in p["stats"].items():
                stats[name] = stats.get(name, 0) + v
        stats["launches"] = {n: sum(p["launches"][n] for p in parts)
                             for n in KERNELS}
        stats["widths"] = {n: sorted({w for p in parts
                                      for w in p["widths"][n]})
                           for n in KERNELS}
        stats["worker_steps"] = [p["steps"] for p in parts]
        stats["capacities"] = caps
        stats["intervals"] = [p["intervals"] for p in parts]
        stats["times"] = {
            "slot_wait_s": self._slot_wait_s,
            "worker_step_s": [p["step_s"] for p in parts],
            "worker_flush_s": [p["flush_s"] for p in parts],
            "finalize_wait_s": t1 - t0,
            "merge_s": time.perf_counter() - t1}
        self.stats = stats
        return merged

    def finalize(self):
        return _finalize(self.params, *self._merged_arrays())

    def finalize_arrays(self):
        return _finalize_arrays(self.params, *self._merged_arrays())
