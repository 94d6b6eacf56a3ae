"""ctypes bindings to the C++ native host layer (parser / packer / murmur oracle).

The port's own copy of ``finch_tpu.native``. The shared library is built on
demand from ``src/finch_native.cpp`` into ``_build/`` (keyed by a content
hash; never shared with the JAX package's build), so a fresh checkout needs
only ``g++`` and zlib. See finch-rs's equivalent native layer: the needletail-based
record loop at finch-rs/lib/src/lib.rs:51-94 and the murmurhash3 crate
used at finch-rs/lib/src/sketch_schemes/hashing.rs:9-12.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from finch_tpu_torch.errors import FinchParseError

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "finch_native.cpp")
_BUILD = os.path.join(_HERE, "_build")

_lock = threading.Lock()
_lib = None


class NativeError(FinchParseError):
    """Native-layer failure (parse/IO), errors.rs Io/Needletail analog."""
    pass


_ERRORS = {
    1: "Could not detect file format (empty or not FASTA/FASTQ?)",
    2: "No such file or directory",
    3: "zlib init failed",
    4: "read/decompress error",
    5: "malformed FASTQ record",
    6: "k must be in 1..=63 for the packed paths (1..=31 narrow, "
       "32..=63 wide)",
    7: "out of memory",
}


def _build() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD, exist_ok=True)
    so_path = os.path.join(_BUILD, f"finch_native_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", _SRC, "-o", tmp, "-lz",
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                l = ctypes.CDLL(_build())
                u64 = ctypes.c_uint64
                u32 = ctypes.c_uint32
                p = ctypes.POINTER
                l.fn_murmur3_x64_128.argtypes = [ctypes.c_char_p, u64, u64, p(u64)]
                l.fn_murmur3_batch.argtypes = [
                    ctypes.c_void_p, u64, u32, u64, ctypes.c_void_p]
                l.fn_murmur3_packed.argtypes = [
                    ctypes.c_void_p, u64, u32, u64, ctypes.c_void_p]
                l.fn_unpack_kmers.argtypes = [
                    ctypes.c_void_p, u64, u32, ctypes.c_void_p]
                l.fn_open_path.restype = ctypes.c_void_p
                l.fn_open_path.argtypes = [ctypes.c_char_p, p(ctypes.c_int)]
                l.fn_open_bytes.restype = ctypes.c_void_p
                l.fn_open_bytes.argtypes = [
                    ctypes.c_char_p, u64, p(ctypes.c_int)]
                l.fn_open_fd.restype = ctypes.c_void_p
                l.fn_open_fd.argtypes = [ctypes.c_int, p(ctypes.c_int)]
                l.fn_close.argtypes = [ctypes.c_void_p]
                l.fn_next_batch.restype = ctypes.c_int
                l.fn_next_batch.argtypes = [
                    ctypes.c_void_p, u32, ctypes.c_int, u64,
                    ctypes.c_void_p, ctypes.c_void_p, p(u64), p(ctypes.c_int)]
                l.fn_totals.argtypes = [ctypes.c_void_p, p(u64), p(u64), p(u64)]
                l.fn_error.restype = ctypes.c_int
                l.fn_error.argtypes = [ctypes.c_void_p]
                l.fn_next_batch_c.restype = ctypes.c_int
                l.fn_next_batch_c.argtypes = [
                    ctypes.c_void_p, u32, ctypes.c_int, u64,
                    ctypes.c_void_p, ctypes.c_void_p, p(u64), p(ctypes.c_int)]
                l.fn_next_batch_w.restype = ctypes.c_int
                l.fn_next_batch_w.argtypes = [
                    ctypes.c_void_p, u32, ctypes.c_int, u64,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    p(u64), p(ctypes.c_int)]
                l.fn_next_batch_r.restype = ctypes.c_int
                l.fn_next_batch_r.argtypes = [
                    ctypes.c_void_p, u32, u64,
                    ctypes.c_void_p, ctypes.c_void_p, p(u64), p(ctypes.c_int)]
                l.fn_murmur3_packed_w.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, u64, u32, u64,
                    ctypes.c_void_p]
                l.fn_unpack_kmers_w.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, u64, u32,
                    ctypes.c_void_p]
                l.fn_popen_path.restype = ctypes.c_void_p
                l.fn_popen_path.argtypes = [
                    ctypes.c_char_p, u32, ctypes.c_int, u64, ctypes.c_int,
                    ctypes.c_int, p(ctypes.c_int)]
                l.fn_popen_bytes.restype = ctypes.c_void_p
                l.fn_popen_bytes.argtypes = [
                    ctypes.c_char_p, u64, u32, ctypes.c_int, u64,
                    ctypes.c_int, ctypes.c_int, p(ctypes.c_int)]
                l.fn_pnext.restype = ctypes.c_int
                l.fn_pnext.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    p(u64), p(ctypes.c_int)]
                l.fn_ptotals.argtypes = [
                    ctypes.c_void_p, p(u64), p(u64), p(u64)]
                l.fn_perror_code.restype = ctypes.c_int
                l.fn_perror_code.argtypes = [ctypes.c_void_p]
                l.fn_pclose.argtypes = [ctypes.c_void_p]
                l.fn_fold_new.restype = ctypes.c_void_p
                l.fn_fold_new.argtypes = [
                    ctypes.c_int, u32, u64, u64, u64]
                l.fn_fold_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, u64]
                l.fn_fold_used.restype = u64
                l.fn_fold_used.argtypes = [ctypes.c_void_p]
                l.fn_fold_result.restype = u64
                l.fn_fold_result.argtypes = [
                    ctypes.c_void_p, u64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
                l.fn_fold_free.argtypes = [ctypes.c_void_p]
                l.fn_sopen_path.restype = ctypes.c_void_p
                l.fn_sopen_path.argtypes = [
                    ctypes.c_char_p, u32, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, u64, u64, u64, p(ctypes.c_int)]
                l.fn_swait.restype = ctypes.c_int
                l.fn_swait.argtypes = [
                    ctypes.c_void_p, p(u64), p(u64), p(u64), p(u64),
                    p(ctypes.c_int)]
                l.fn_sresult.restype = u64
                l.fn_sresult.argtypes = [
                    ctypes.c_void_p, u64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
                l.fn_serror.restype = ctypes.c_int
                l.fn_serror.argtypes = [ctypes.c_void_p]
                l.fn_sclose.argtypes = [ctypes.c_void_p]
                i64 = ctypes.c_int64
                l.fn_sk_qu64.restype = i64
                l.fn_sk_qu64.argtypes = [
                    ctypes.c_char_p, u64, ctypes.c_void_p, u64]
                l.fn_sk_u32.restype = i64
                l.fn_sk_u32.argtypes = [
                    ctypes.c_char_p, u64, ctypes.c_void_p, u64]
                l.fn_sk_kseg.restype = i64
                l.fn_sk_kseg.argtypes = [ctypes.c_char_p, u64, p(i64)]
                l.fn_sk_fmt_qu64.restype = u64
                l.fn_sk_fmt_qu64.argtypes = [
                    ctypes.c_void_p, u64, ctypes.c_void_p]
                l.fn_sk_fmt_u32.restype = u64
                l.fn_sk_fmt_u32.argtypes = [
                    ctypes.c_void_p, u64, ctypes.c_void_p]
                _lib = l
    return _lib


def sk_parse_qu64(seg: bytes):
    """Parse a '"d","d",...' quoted-u64 segment in one native pass.

    Returns a uint64 array, None when the shape isn't compact serde_json
    (caller falls back to json.loads), or raises OverflowError for a
    value above u64::MAX (same outcome as the numpy decimal parse)."""
    cap = len(seg) // 3 + 1  # each element is at least '"d"'
    out = np.empty(cap, dtype=np.uint64)
    n = lib().fn_sk_qu64(seg, len(seg), out.ctypes.data, cap)
    if n == -2:
        raise OverflowError("hash above u64::MAX")
    if n < 0:
        return None
    return out[:n].copy()


def sk_parse_u32(seg: bytes):
    """Parse a bare 'd,d,...' u32 segment in one native pass.

    Returns a uint32 array, None on shape mismatch, or raises
    OverflowError for a value above u32::MAX (the reference's serde u32
    deserialization errors on overflow, json.rs:122)."""
    cap = len(seg) // 2 + 1
    out = np.empty(cap, dtype=np.uint32)
    n = lib().fn_sk_u32(seg, len(seg), out.ctypes.data, cap)
    if n == -2:
        raise OverflowError("count above u32::MAX")
    if n < 0:
        return None
    return out[:n].copy()


def sk_fmt_qu64(v: np.ndarray) -> bytes:
    """Format a u64 array as the '"d","d"' quoted-decimal JSON list body
    in one native pass (writer-side inverse of sk_parse_qu64)."""
    v = np.ascontiguousarray(v, dtype=np.uint64)
    out = np.empty(len(v) * 23, dtype=np.uint8)
    n = lib().fn_sk_fmt_qu64(v.ctypes.data, len(v), out.ctypes.data)
    return out[:n].tobytes()


def sk_fmt_u32(v: np.ndarray) -> bytes:
    """Format a u32 array as the bare 'd,d' JSON list body in one native
    pass (writer-side inverse of sk_parse_u32)."""
    v = np.ascontiguousarray(v, dtype=np.uint32)
    out = np.empty(len(v) * 11, dtype=np.uint8)
    n = lib().fn_sk_fmt_u32(v.ctypes.data, len(v), out.ctypes.data)
    return out[:n].tobytes()


def sk_scan_kseg(seg: bytes):
    """Validate a '"K","K",...' kmer segment in one native pass.

    Returns (count, fixed_len) where fixed_len is the common element
    length (or -1 when lengths differ), or None when the shape isn't the
    compact serde_json form."""
    fl = ctypes.c_int64()
    n = lib().fn_sk_kseg(seg, len(seg), ctypes.byref(fl))
    if n < 0:
        return None
    return n, fl.value


def murmur3_x64_128(key: bytes, seed: int = 0) -> tuple[int, int]:
    """Scalar oracle: MurmurHash3_x64_128(key, seed) -> (h1, h2)."""
    out = (ctypes.c_uint64 * 2)()
    lib().fn_murmur3_x64_128(key, len(key), seed, out)
    return out[0], out[1]


def murmur3_packed(packed: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Hash 2-bit packed k-mer codes on the host (reference path)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    out = np.empty(packed.shape[0], dtype=np.uint64)
    lib().fn_murmur3_packed(
        packed.ctypes.data, packed.shape[0], k, seed, out.ctypes.data)
    return out


def unpack_kmers(packed: np.ndarray, k: int) -> np.ndarray:
    """Decode packed codes to an (n, k) uint8 array of ASCII bases."""
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    out = np.empty((packed.shape[0], k), dtype=np.uint8)
    lib().fn_unpack_kmers(packed.ctypes.data, packed.shape[0], k, out.ctypes.data)
    return out


def murmur3_packed_w(plo: np.ndarray, phi: np.ndarray, k: int,
                     seed: int = 0) -> np.ndarray:
    """Hash wide (32 <= k <= 63) two-word packed k-mer codes on the host."""
    plo = np.ascontiguousarray(plo, dtype=np.uint64)
    phi = np.ascontiguousarray(phi, dtype=np.uint64)
    out = np.empty(plo.shape[0], dtype=np.uint64)
    lib().fn_murmur3_packed_w(
        plo.ctypes.data, phi.ctypes.data, plo.shape[0], k, seed,
        out.ctypes.data)
    return out


def unpack_kmers_w(plo: np.ndarray, phi: np.ndarray, k: int) -> np.ndarray:
    """Decode wide two-word packed codes to (n, k) ASCII bases."""
    plo = np.ascontiguousarray(plo, dtype=np.uint64)
    phi = np.ascontiguousarray(phi, dtype=np.uint64)
    out = np.empty((plo.shape[0], k), dtype=np.uint8)
    lib().fn_unpack_kmers_w(plo.ctypes.data, phi.ctypes.data, plo.shape[0],
                            k, out.ctypes.data)
    return out


def murmur3_batch(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """MurmurHash3_x64_128 low words for a (n, keylen) u8 key matrix —
    the reference's hash over raw canonical k-mer bytes for arbitrary k
    (hashing.rs:10-12)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n, keylen = keys.shape
    out = np.empty(n, dtype=np.uint64)
    lib().fn_murmur3_batch(keys.ctypes.data, n, keylen, seed,
                           out.ctypes.data)
    return out


FORMAT_UNKNOWN, FORMAT_FASTA, FORMAT_FASTQ = 0, 1, 2


def _open_source(path_or_bytes, err):
    """Open a serial parser handle for any source form.

    bytes-like -> in-memory; '-' or an int fd -> O(1)-memory fd streaming
    (the reference streams stdin through the same record loop as a file,
    lib.rs:38-43); anything else -> filesystem path. Returns
    (handle, keepalive)."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
        return lib().fn_open_bytes(data, len(data), ctypes.byref(err)), data
    if path_or_bytes == "-":
        import sys

        return lib().fn_open_fd(sys.stdin.buffer.fileno(),
                                ctypes.byref(err)), None
    if isinstance(path_or_bytes, int):
        return lib().fn_open_fd(path_or_bytes, ctypes.byref(err)), None
    return lib().fn_open_path(str(path_or_bytes).encode(),
                              ctypes.byref(err)), None


class KmerReader:
    """Streaming canonical k-mer batches from a FASTA/FASTQ(.gz) source.

    Yields (packed_codes: uint64[n], is_rc: uint8[n]) batches; after
    exhaustion, ``totals`` carries (seq_length, num_valid_kmers, n_records)
    matching finch's accounting (mash.rs:72, mash.rs:35).
    """

    def __init__(self, path_or_bytes, k: int, canonical: bool = True,
                 batch_size: int = 1 << 22, composite: bool = False):
        self.k = int(k)
        self.canonical = bool(canonical)
        self.batch_size = int(batch_size)
        self.composite = bool(composite)
        self._err = ctypes.c_int(0)
        self._lib = lib()
        self._h, self._keepalive = _open_source(path_or_bytes, self._err)
        if not self._h:
            raise NativeError(_ERRORS.get(self._err.value, "open failed"))
        self.format = FORMAT_UNKNOWN
        self._done = False

    def __iter__(self):
        n = ctypes.c_uint64(0)
        fmt = ctypes.c_int(0)
        while not self._done:
            if self.k > 31:
                # wide path (32 <= k <= 63): packed codes as (lo, hi) u64
                # word pairs; downstream engines accept the tuple form
                a = np.empty(self.batch_size, dtype=np.uint64)
                a2 = np.empty(self.batch_size, dtype=np.uint64)
                b = np.empty(self.batch_size, dtype=np.uint8)
                r = lib().fn_next_batch_w(
                    self._h, self.k, 1 if self.canonical else 0,
                    self.batch_size, a.ctypes.data, a2.ctypes.data,
                    b.ctypes.data, ctypes.byref(n), ctypes.byref(fmt))
                if r < 0:
                    code = lib().fn_error(self._h)
                    raise NativeError(
                        _ERRORS.get(code, f"parse error {code}"))
                self.format = fmt.value
                if r == 0:
                    self._done = True
                if n.value:
                    yield (a[: n.value], a2[: n.value]), b[: n.value]
                if r == 0:
                    break
                continue
            if self.composite:
                a = np.empty(self.batch_size, dtype=np.uint32)
                b = np.empty(self.batch_size, dtype=np.uint32)
                got = self.fill(a, b)
                if got:
                    yield a[:got], b[:got]
                continue
            a = np.empty(self.batch_size, dtype=np.uint64)
            b = np.empty(self.batch_size, dtype=np.uint8)
            r = lib().fn_next_batch(
                self._h, self.k, 1 if self.canonical else 0,
                self.batch_size, a.ctypes.data, b.ctypes.data,
                ctypes.byref(n), ctypes.byref(fmt))
            if r < 0:
                code = lib().fn_error(self._h)
                raise NativeError(_ERRORS.get(code, f"parse error {code}"))
            self.format = fmt.value
            if r == 0:
                self._done = True
            if n.value:
                yield a[: n.value], b[: n.value]
            if r == 0:
                break

    def fill(self, lo: np.ndarray, hi: np.ndarray) -> int:
        """Parse the next composite batch ((packed << 1) | is_rc u32
        planes, the fused device kernel's operand layout) into the
        caller's arrays, each of at least `batch_size` u32; returns its
        length, 0 once the stream is done. Batch for batch the k-mers
        that plain iteration yields, and the same `totals`. The reader
        must have been opened with composite=True (and k <= 31)."""
        if not self.composite or self.k > 31:
            raise NativeError("fill needs a composite reader of k <= 31")
        _check_planes(lo, hi, self.batch_size)
        n = ctypes.c_uint64(0)
        fmt = ctypes.c_int(0)
        while not self._done:
            r = lib().fn_next_batch_c(
                self._h, self.k, 1 if self.canonical else 0,
                self.batch_size, lo.ctypes.data, hi.ctypes.data,
                ctypes.byref(n), ctypes.byref(fmt))
            if r < 0:
                code = lib().fn_error(self._h)
                raise NativeError(_ERRORS.get(code, f"parse error {code}"))
            self.format = fmt.value
            if r == 0:
                self._done = True
            if n.value:
                return n.value
        return 0

    @property
    def totals(self):
        bases = ctypes.c_uint64(0)
        kmers = ctypes.c_uint64(0)
        recs = ctypes.c_uint64(0)
        lib().fn_totals(self._h, ctypes.byref(bases), ctypes.byref(kmers),
                        ctypes.byref(recs))
        return bases.value, kmers.value, recs.value

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fn_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _check_planes(lo: np.ndarray, hi: np.ndarray, batch_size: int) -> None:
    """A reader writes up to batch_size lanes through the arrays' pointers:
    refuse any that could not hold them."""
    for a in (lo, hi):
        if (not isinstance(a, np.ndarray) or a.dtype != np.uint32
                or a.ndim != 1 or not a.flags.c_contiguous
                or not a.flags.writeable or a.shape[0] < batch_size):
            raise NativeError(f"fill needs two writable contiguous uint32 "
                              f"arrays of at least {batch_size} lanes")


class XWideReader:
    """Canonical k-mer batches for arbitrary k >= 64 (the reference hashes
    byte windows of any k: mash.rs:73-79, hashing.rs:9-12 — needletail's
    canonical_kmers has no k bound).

    The native parser runs in run-mode (fn_next_batch_r): forward 31-mer
    codes with a run-start flag, from which every maximal valid-base run
    is reconstructed exactly — the first window of a run decodes to 31
    base codes, each later window appends its low 2 bits. Arbitrary-k
    windows then slide over the run with a k-1 carry across batches
    (memory stays O(batch + k), not O(record)), canonicalization is a
    vectorized lexicographic compare against the reverse complement
    (ties take the rc branch, needletail semantics), and hashing runs
    over the canonical ASCII bytes in native code (fn_murmur3_batch).

    Yields ((n, k) uint8 ASCII canonical windows, is_rc uint8[n]);
    ``totals`` carries (seq_length, num_valid_kmers@k, n_records).
    """

    K1 = 31  # substrate word size (codes per emitted u64)

    _ASCII = np.array([65, 67, 71, 84], dtype=np.uint8)  # ACGT

    def __init__(self, path_or_bytes, k: int, canonical: bool = True,
                 batch_size: int = 1 << 22):
        if k < 64:
            raise NativeError("XWideReader handles k >= 64; narrower k "
                              "uses the packed readers")
        if not canonical:
            raise NativeError(
                "forward-strand (AllCounts) extraction is 2-bit-table "
                "bound (k <= 31), matching the reference's bit_kmers")
        self.k = int(k)
        # parser-batch cap sized so the (windows, k) byte matrix stays
        # modest regardless of k; an explicitly small batch_size is
        # honored (tests use tiny caps to force cross-batch stitching)
        self._cap = max(64, min(int(batch_size), (8 << 20) // self.k))
        self._err = ctypes.c_int(0)
        self._lib = lib()
        self._h, self._keepalive = _open_source(path_or_bytes, self._err)
        if not self._h:
            raise NativeError(_ERRORS.get(self._err.value, "open failed"))
        self.format = FORMAT_UNKNOWN
        self._done = False
        self._kmer_total = 0

    def _decode31(self, code: int) -> np.ndarray:
        shifts = np.arange(self.K1 - 1, -1, -1, dtype=np.uint64) * 2
        return ((np.uint64(code) >> shifts) & np.uint64(3)).astype(np.uint8)

    def _windows(self, blocks):
        """Canonicalize a list of (m_i, k) code-window blocks and yield
        one (ASCII windows, is_rc) batch."""
        win = np.vstack(blocks)
        rcw = (np.uint8(3) - win)[:, ::-1]
        diff = win != rcw
        has = diff.any(axis=1)
        fd = diff.argmax(axis=1)
        rows = np.arange(len(win))
        fwd_lt = np.zeros(len(win), dtype=bool)
        fwd_lt[has] = win[rows[has], fd[has]] < rcw[rows[has], fd[has]]
        is_rc = ~fwd_lt  # ties -> rc branch (needletail canonical_kmers)
        canon = np.where(is_rc[:, None], rcw, win)
        self._kmer_total += len(win)
        return self._ASCII[canon], is_rc.astype(np.uint8)

    def __iter__(self):
        n = ctypes.c_uint64(0)
        fmt = ctypes.c_int(0)
        k = self.k
        carry = np.empty(0, dtype=np.uint8)  # last <= k-1 codes of the run
        from numpy.lib.stride_tricks import sliding_window_view

        while not self._done:
            codes = np.empty(self._cap, dtype=np.uint64)
            flags = np.empty(self._cap, dtype=np.uint8)
            r = lib().fn_next_batch_r(
                self._h, self.K1, self._cap, codes.ctypes.data,
                flags.ctypes.data, ctypes.byref(n), ctypes.byref(fmt))
            if r < 0:
                code = lib().fn_error(self._h)
                raise NativeError(_ERRORS.get(code, f"parse error {code}"))
            self.format = fmt.value
            if r == 0:
                self._done = True
            m = n.value
            if m:
                codes = codes[:m]
                flags = flags[:m]
                starts = np.flatnonzero(flags)
                bounds = [0, *starts.tolist(), m]
                blocks = []
                for b in range(len(bounds) - 1):
                    s, e = bounds[b], bounds[b + 1]
                    if s == e:
                        continue  # batch begins exactly at a run start
                    if flags[s]:
                        # new run: 31 bases from the first window, one per
                        # later window
                        buf = np.concatenate(
                            [self._decode31(int(codes[s])),
                             (codes[s + 1:e] & np.uint64(3))
                             .astype(np.uint8)])
                    else:
                        # continuation of the previous batch's run
                        buf = np.concatenate(
                            [carry,
                             (codes[s:e] & np.uint64(3)).astype(np.uint8)])
                    if len(buf) >= k:
                        # every window of buf ends at a new base (carry is
                        # capped at k-1), so none was emitted before
                        blocks.append(sliding_window_view(buf, k))
                    carry = buf[-(k - 1):] if len(buf) >= k else buf
                if blocks:
                    yield self._windows(blocks)
            if r == 0:
                break

    @property
    def totals(self):
        bases = ctypes.c_uint64(0)
        kmers = ctypes.c_uint64(0)
        recs = ctypes.c_uint64(0)
        lib().fn_totals(self._h, ctypes.byref(bases), ctypes.byref(kmers),
                        ctypes.byref(recs))
        # the parser counted 31-mer substrate windows; valid k-mers at
        # this k were counted during reconstruction
        return bases.value, self._kmer_total, recs.value

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fn_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class StreamingParallelReader:
    """Within-file parallel k-mer extraction with O(1) memory in file size.

    Drives the native pipeline (finch_native.cpp "Streaming parallel parse
    pipeline"): a reader/aligner thread streams the input in blocks and
    splits it at exact record boundaries, a native thread pool parses the
    record-aligned chunks concurrently, and batches come back in strict
    file order — so the emitted k-mer stream and totals are byte-identical
    to the serial KmerReader's. BGZF (bgzip) inputs also decompress in
    parallel; plain gzip decompresses serially overlapped with parsing.

    Memory is bounded by ~(threads + 2) chunks regardless of file
    size (the reference's own yardstick, a 4.8 GB FASTQ, streams through).
    """

    def __init__(self, path_or_bytes, k: int, canonical: bool = True,
                 batch_size: int = 1 << 22, threads: int | None = None,
                 composite: bool = False):
        if threads is None:
            threads = int(os.environ.get("FINCH_TPU_PARSER_THREADS", "0")) \
                or (os.cpu_count() or 1)
        self.k = int(k)
        self.canonical = bool(canonical)
        self.batch_size = int(batch_size)
        self.composite = bool(composite)
        self._err = ctypes.c_int(0)
        self._keepalive = None
        self._lib = lib()
        comp = 1 if composite else 0
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            data = bytes(path_or_bytes)
            self._keepalive = data
            self._h = lib().fn_popen_bytes(
                data, len(data), self.k, 1 if self.canonical else 0,
                self.batch_size, int(threads), comp,
                ctypes.byref(self._err))
        else:
            self._h = lib().fn_popen_path(
                str(path_or_bytes).encode(), self.k,
                1 if self.canonical else 0, self.batch_size, int(threads),
                comp, ctypes.byref(self._err))
        if not self._h:
            raise NativeError(_ERRORS.get(self._err.value, "open failed"))
        self.format = FORMAT_UNKNOWN
        self._done = False

    def __iter__(self):
        while not self._done:
            if self.composite:
                a = np.empty(self.batch_size, dtype=np.uint32)
                b = np.empty(self.batch_size, dtype=np.uint32)
            else:
                a = np.empty(self.batch_size, dtype=np.uint64)
                b = np.empty(self.batch_size, dtype=np.uint8)
            got = self._next(a, b)
            if got:
                yield a[:got], b[:got]

    def _next(self, a: np.ndarray, b: np.ndarray) -> int:
        """The next non-empty batch into a and b (batch_size lanes each);
        its length, 0 once the stream is done."""
        n = ctypes.c_uint64(0)
        fmt = ctypes.c_int(0)
        while not self._done:
            r = lib().fn_pnext(
                self._h, a.ctypes.data, b.ctypes.data,
                ctypes.byref(n), ctypes.byref(fmt))
            self.format = fmt.value or self.format
            if r < 0:
                code = lib().fn_perror_code(self._h)
                raise NativeError(_ERRORS.get(code, f"parse error {code}"))
            if r == 0:
                self._done = True
            elif n.value:
                return n.value
        return 0

    def fill(self, lo: np.ndarray, hi: np.ndarray) -> int:
        """Parse the next composite batch into the caller's u32 arrays,
        each of at least `batch_size` lanes; returns its length, 0 once
        the stream is done. As KmerReader.fill; the reader must have been
        opened with composite=True."""
        if not self.composite:
            raise NativeError("fill needs a reader opened with "
                              "composite=True")
        _check_planes(lo, hi, self.batch_size)
        return self._next(lo, hi)

    @property
    def totals(self):
        bases = ctypes.c_uint64(0)
        kmers = ctypes.c_uint64(0)
        recs = ctypes.c_uint64(0)
        lib().fn_ptotals(self._h, ctypes.byref(bases), ctypes.byref(kmers),
                         ctypes.byref(recs))
        return bases.value, kmers.value, recs.value

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fn_pclose(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeFold:
    """Host sketch-fold state (C++ identity-hash table + adaptive
    threshold); the CPU analog of the device bottom-k. See the fold
    section of finch_native.cpp for the retention-rule contract."""

    def __init__(self, scheme: int, k: int, seed: int, size: int,
                 max_hash: int = 0):
        self._lib = lib()
        self._h = self._lib.fn_fold_new(int(scheme), int(k), int(seed),
                                        int(size), int(max_hash))

    def fold(self, packed: np.ndarray, rc: np.ndarray) -> None:
        packed = np.ascontiguousarray(packed, dtype=np.uint64)
        rc = np.ascontiguousarray(rc, dtype=np.uint8)
        lib().fn_fold_batch(self._h, packed.ctypes.data, rc.ctypes.data,
                            len(packed))

    def result(self):
        """(hashes, counts, extras, packed) ascending by hash — the raw
        table contents (a superset of the final sketch; retention is
        applied by the engine's finalize)."""
        n = lib().fn_fold_used(self._h)
        h = np.empty(n, dtype=np.uint64)
        c = np.empty(n, dtype=np.uint64)
        e = np.empty(n, dtype=np.uint64)
        pk = np.empty(n, dtype=np.uint64)
        got = lib().fn_fold_result(self._h, n, h.ctypes.data, c.ctypes.data,
                                   e.ctypes.data, pk.ctypes.data)
        assert got == n
        return h, c, e, pk

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fn_fold_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def sketch_pipeline(path, k: int, scheme: int, seed: int, size: int,
                    max_hash: int = 0, canonical: bool = True,
                    threads: int | None = None):
    """Fused parse+fold over the native pipeline: parse workers fold
    their record-aligned chunks into worker-local tables under a shared
    adaptive admission threshold; exact merge at EOF (see the sketch-mode
    section of finch_native.cpp for the proof sketch).

    Returns ((h, c, e, pk) candidate arrays ascending by hash — a
    retention-rule superset — plus (bases, kmers, records) totals and the
    detected format).
    """
    if threads is None:
        threads = int(os.environ.get("FINCH_TPU_PARSER_THREADS", "0")) \
            or (os.cpu_count() or 1)
    l = lib()
    err = ctypes.c_int(0)
    h = l.fn_sopen_path(str(path).encode(), int(k),
                        1 if canonical else 0, int(threads), int(scheme),
                        int(seed), int(size), int(max_hash),
                        ctypes.byref(err))
    if not h:
        raise NativeError(_ERRORS.get(err.value, "open failed"))
    try:
        n = ctypes.c_uint64(0)
        bases = ctypes.c_uint64(0)
        kmers = ctypes.c_uint64(0)
        recs = ctypes.c_uint64(0)
        fmt = ctypes.c_int(0)
        r = l.fn_swait(h, ctypes.byref(n), ctypes.byref(bases),
                       ctypes.byref(kmers), ctypes.byref(recs),
                       ctypes.byref(fmt))
        if r != 0:
            code = l.fn_serror(h)
            raise NativeError(_ERRORS.get(code, f"parse error {code}"))
        hh = np.empty(n.value, dtype=np.uint64)
        cc = np.empty(n.value, dtype=np.uint64)
        ee = np.empty(n.value, dtype=np.uint64)
        pk = np.empty(n.value, dtype=np.uint64)
        got = l.fn_sresult(h, n.value, hh.ctypes.data, cc.ctypes.data,
                           ee.ctypes.data, pk.ctypes.data)
        assert got == n.value
        return ((hh, cc, ee, pk),
                (bases.value, kmers.value, recs.value), fmt.value)
    finally:
        l.fn_sclose(h)
