""".sk / .json codec — the Mash JSON schema interchange format.

Byte-compatible with serde_json's compact output of the reference's
`MultiSketch`/`JsonSketch` (finch-rs/lib/src/serialization/json.rs):

  * field order: kmer, alphabet, preserveCase, canonical, sketchSize,
    hashType, hashBits, hashSeed, scale, sketches (json.rs:141-158)
  * per-sketch order: name, seqLength, numValidKmers, comment, filters,
    hashes, kmers, counts (json.rs:78-87)
  * hashes serialized as decimal strings of u64 (json.rs:73)
  * on read: missing counts -> 1, extra_count = count / 2 (json.rs:118-129)

Note: the reference serializes `filters` from a Rust HashMap whose iteration
order is randomized per process, so byte-stability across runs only exists
when the filter map is empty (e.g. unfiltered FASTA sketches). We emit the
map in the reference's to_serialized() insertion order
(strandFilter, errFilter, minCopies, maxCopies; filtering.rs:89-108).
"""

from __future__ import annotations

import json
import math
from typing import List

from finch_tpu_torch.core.sketch import (KmerCount, LazyKmerCounts,
                                   Sketch)
from finch_tpu_torch.errors import FinchSchemaError
from finch_tpu_torch.models.params import FilterParams, SketchParams


def format_f64(x: float) -> str:
    """serde_json / ryu-style shortest-roundtrip float formatting.

    Python's repr is also shortest-roundtrip, so the digits agree; only the
    fixed/scientific switch differs in one band. ryu's pretty printer
    (ryu/src/pretty/mod.rs) uses fixed notation for -5 < kk <= 16 where
    kk-1 is the decimal exponent; Python goes scientific from 1e-5 down.
    So values in [1e-5, 1e-4) — e.g. the mash distance of near-identical
    genomes — must be re-expanded to "0.0000ddd". Exponents are printed
    without '+' or zero padding.
    """
    if math.isnan(x) or math.isinf(x):
        return "null"
    r = repr(float(x))
    if "e" in r:
        m, e = r.split("e")
        exp = int(e)
        if exp == -5:  # ryu fixed-notation band that Python prints as e-05
            neg = m.startswith("-")
            digits = m.lstrip("-").replace(".", "")
            return ("-" if neg else "") + "0.0000" + digits
        return f"{m}e{exp}"
    return r


def _jstr(s) -> str:
    return json.dumps(s, ensure_ascii=False, separators=(",", ":"))


# bytes that serialize into a JSON string verbatim (no escapes): printable
# ASCII minus '"' (0x22) and '\' (0x5C). Genomic kmers are pure ACGT, so
# the whole concatenation passes one C-speed scan.
import re

_JSON_VERBATIM = re.compile(rb'\A[ !#-\[\]-~]*\Z')


def _bulk_array_parts(sketch: Sketch):
    """Vectorized hashes/kmers/counts JSON segments for unforced
    lazily-loaded sketches, or None for the general per-element path.

    The per-element path json.dumps's every kmer and forces the lazy
    container into ~n KmerCount objects — at DB scale (10k x 1000) that
    is most of the write time. Byte-identity with the general path is
    pinned by tests."""
    soa = getattr(sketch.hashes, "_soa", None)
    if soa is None:
        return None
    import numpy as np

    h, ks, c, _e = soa
    if callable(ks):
        ks, labels = ks()
        if labels is not None and any(lb is not None for lb in labels):
            # labels don't serialize to .sk, but keep the general path as
            # the single source of truth for exotic inputs
            return None
    n = len(h)
    if n == 0:
        return '"hashes":[]', '"kmers":[]', '"counts":[]'
    if isinstance(ks, np.ndarray) and ks.dtype.kind == "S":
        # fixed-width store (native .sk scanner): emit the '","'-joined
        # blob by writing separator columns into an (n, L+3) byte plane —
        # no per-element Python objects
        L = ks.dtype.itemsize
        plane = ks.view(np.uint8).reshape(n, L)
        if (plane == 0).any():
            ks = ks.tolist()  # short (NUL-padded) element: general join
        else:
            if not _JSON_VERBATIM.match(plane.tobytes()):
                return None
            m = np.empty((n, L + 3), np.uint8)
            m[:, :L] = plane
            m[:, L] = 0x22    # '"'
            m[:, L + 1] = 0x2C  # ','
            m[:, L + 2] = 0x22
            joined_kmers = m.tobytes()[:-3]
            from finch_tpu_torch import native
            hashes = ('"hashes":[' + native.sk_fmt_qu64(h).decode("ascii")
                      + ']')
            kmers = '"kmers":["' + joined_kmers.decode("ascii") + '"]'
            counts = ('"counts":['
                      + native.sk_fmt_u32(c.astype(np.uint32))
                      .decode("ascii") + "]")
            return hashes, kmers, counts
    if not _JSON_VERBATIM.match(b"".join(ks)):
        return None  # needs real JSON escaping somewhere
    joined_kmers = b'","'.join(ks)
    from finch_tpu_torch import native
    hashes = '"hashes":[' + native.sk_fmt_qu64(h).decode("ascii") + ']'
    kmers = '"kmers":["' + joined_kmers.decode("ascii") + '"]'
    counts = ('"counts":['
              + native.sk_fmt_u32(c.astype(np.uint32)).decode("ascii")
              + "]")
    return hashes, kmers, counts


def sketch_to_json_obj(sketch: Sketch) -> str:
    """Compact JSON text of one JsonSketch (exact field order)."""
    parts = []
    parts.append('"name":' + _jstr(sketch.name))
    parts.append('"seqLength":' + str(sketch.seq_length))
    parts.append('"numValidKmers":' + str(sketch.num_valid_kmers))
    parts.append('"comment":' + _jstr(sketch.comment))
    filters = sketch.filter_params.to_serialized()
    parts.append('"filters":' + _jstr(filters))
    bulk = _bulk_array_parts(sketch)
    if bulk is not None:
        parts.extend(bulk)
    else:
        parts.append('"hashes":[' + ",".join(
            '"%d"' % kc.hash for kc in sketch.hashes) + "]")
        parts.append('"kmers":[' + ",".join(
            _jstr(kc.kmer.decode("utf-8")) for kc in sketch.hashes) + "]")
        parts.append('"counts":[' + ",".join(
            str(kc.count) for kc in sketch.hashes) + "]")
    return "{" + ",".join(parts) + "}"


def multisketch_to_json_bytes(sketches: List[Sketch]) -> bytes:
    """Compact JSON of the reference's MultiSketch::from_sketches
    (json.rs:199-218)."""
    params = SketchParams.from_sketches(sketches)
    hash_type, hash_bits, hash_seed, scale = params.hash_info()
    parts = []
    parts.append('"kmer":' + str(params.k))
    parts.append('"alphabet":"ACGT"')
    parts.append('"preserveCase":false')
    parts.append('"canonical":true')
    # reference truncates with `expected_size() as u32` (json.rs:211)
    parts.append('"sketchSize":' + str(params.expected_size() & 0xFFFFFFFF))
    parts.append('"hashType":' + _jstr(hash_type))
    parts.append('"hashBits":' + str(hash_bits))
    parts.append('"hashSeed":' + str(hash_seed))
    parts.append('"scale":' + ("null" if scale is None else format_f64(scale)))
    parts.append('"sketches":[' + ",".join(
        sketch_to_json_obj(s) for s in sketches) + "]")
    return ("{" + ",".join(parts) + "}").encode("utf-8")


def multisketch_params_from_json(doc: dict) -> SketchParams:
    """MultiSketch::get_params (json.rs:160-197)."""
    hash_type = doc.get("hashType")
    scale = doc.get("scale")
    kmer = int(doc["kmer"])
    sketch_size = int(doc["sketchSize"])
    hash_seed = int(doc.get("hashSeed", 0))
    if hash_type == "MurmurHash3_x64_128" and scale is None:
        if int(doc.get("hashBits", 64)) != 64:
            raise FinchSchemaError(
                f"Multisketch has incompatible hash size "
                f"({doc.get('hashBits')} != 64)")
        return SketchParams.mash(
            kmers_to_sketch=sketch_size, final_size=sketch_size,
            no_strict=True, kmer_length=kmer, hash_seed=hash_seed)
    if hash_type == "MurmurHash3_x64_128":
        if int(doc.get("hashBits", 64)) != 64:
            raise FinchSchemaError(
                f"Multisketch has incompatible hash size "
                f"({doc.get('hashBits')} != 64)")
        return SketchParams.scaled(
            kmers_to_sketch=sketch_size, kmer_length=kmer,
            scale=float(scale), hash_seed=hash_seed)
    if hash_type == "None":
        return SketchParams.all_counts(kmer_length=kmer)
    raise FinchSchemaError(f"{hash_type} sketch type is not supported")


_SEG_KEYS = [b'"hashes":[', b'"kmers":[', b'"counts":[']
_PH_PREFIX = "__finch_seg:"


class _FastMismatch(Exception):
    """A cut segment wasn't compact serde_json output after all — not an
    error; the caller re-reads the document through json.loads."""


def _extract_segments(data: bytes):
    """Cut the three bulk arrays out of the document (replacing each with
    a unique placeholder) so json.loads never tokenizes them.

    Sound because an unescaped '"' cannot occur inside any JSON string:
    every find() hit is a real key. Segment shapes are validated by the
    native single-pass parsers at use time (`_FastMismatch` aborts to the
    general path); a cut landing mid-string (a ']' inside a kmer) leaves
    either an invalid residual (json.loads fails -> fallback) or a
    malformed segment (native parse fails -> fallback).
    Returns (residual bytes, {key: [segment bytes]}).
    """
    segs = {b"hashes": [], b"kmers": [], b"counts": []}
    res = bytearray()
    pos = 0
    # per-key cached next occurrence: each key's find() resumes from its
    # previous hit instead of rescanning from pos every iteration
    nxt_at = {kb: -2 for kb in _SEG_KEYS}  # -2 = unknown, -1 = exhausted
    while True:
        nxt, which = -1, None
        for kb in _SEG_KEYS:
            i = nxt_at[kb]
            if i != -1 and i < pos:
                i = nxt_at[kb] = data.find(kb, pos)
            if i != -1 and (nxt == -1 or i < nxt):
                nxt, which = i, kb
        if nxt == -1:
            res += data[pos:]
            break
        end = data.find(b"]", nxt + len(which))
        if end == -1:
            return None
        name = which[1:-3]
        seg = data[nxt + len(which): end]
        ph = f'["{_PH_PREFIX}{name.decode()}:{len(segs[name])}"]'
        segs[name].append(seg)
        res += data[pos:nxt] + which[:-1] + ph.encode()
        pos = end + 1
    return bytes(res), segs


def _segment_for(value, key: str, segs):
    """The extracted segment a placeholder value points at, or None when
    the field held a genuine (non-placeholder) value.

    A placeholder-shaped value the scanner did NOT insert (a document
    whose field literally holds '__finch_seg:...' text, written in a
    non-compact form the scanner skipped) must not be trusted: indices
    are consumed strictly in document order, so any forged or duplicate
    reference misses the expected next index and aborts to the general
    json.loads path, which preserves the literal value."""
    if (isinstance(value, list) and len(value) == 1
            and isinstance(value[0], str)
            and value[0].startswith(_PH_PREFIX + key + ":")):
        kb = key.encode()
        tail = value[0].rsplit(":", 1)[1]
        expect = segs.setdefault("consumed", {}).get(kb, 0)
        if (not tail.isdigit() or int(tail) != expect
                or expect >= len(segs[kb])):
            raise _FastMismatch
        segs["consumed"][kb] = expect + 1
        return segs[kb][expect]
    return None


def _build_sketches(doc: dict, segs, path: str) -> List[Sketch]:
    """Sketch objects from a parsed document; when `segs` holds raw byte
    segments cut out by the fast scanner, they parse through the native
    single-pass scanners (finch_native.cpp fn_sk_*) instead of a
    bytes.split + numpy decimal parse — one C pass, no per-element
    Python objects. Raises _FastMismatch when a segment turns out not to
    be compact serde_json output."""
    import numpy as np

    from finch_tpu_torch import native

    sketch_params = multisketch_params_from_json(doc)
    sketches = []
    for js in doc.get("sketches", []):
        hashes = js.get("hashes", [])
        kmers = js.get("kmers")
        counts = js.get("counts")
        # bulk-parse the decimal strings and defer the KmerCount objects
        # entirely: the distance/device paths only read the SoA views,
        # so a DB load costs array parses, not ~10^7 object
        # constructions (LazyKmerCounts materializes on demand with
        # identical missing-count / extra_count=count//2 semantics).
        try:
            seg = segs and _segment_for(hashes, "hashes", segs)
            if seg is not None:
                h_arr = (native.sk_parse_qu64(seg) if seg
                         else np.empty(0, dtype=np.uint64))
                if h_arr is None:
                    raise _FastMismatch
            else:
                h_arr = (np.array(hashes, dtype=np.uint64) if hashes
                         else np.empty(0, dtype=np.uint64))
            cseg = segs and _segment_for(counts, "counts", segs)
            if cseg is not None:
                # native validates the u32 range in-pass (the reference's
                # serde u32 deserialization errors on overflow,
                # json.rs:122-129)
                try:
                    c_arr = (native.sk_parse_u32(cseg) if cseg
                             else np.empty(0, dtype=np.uint32))
                except OverflowError:
                    raise FinchSchemaError(
                        f"Error parsing {path!r}: count out of u32 range")
                if c_arr is None:
                    raise _FastMismatch
                e_arr = c_arr // 2
            elif counts is not None:
                c_arr = np.array(counts, dtype=np.int64)
                if len(c_arr) and (c_arr.min() < 0
                                   or c_arr.max() > 0xFFFFFFFF):
                    raise FinchSchemaError(
                        f"Error parsing {path!r}: count out of u32 range")
                e_arr = c_arr // 2
            else:
                c_arr = np.ones(len(h_arr), dtype=np.int64)
                e_arr = np.zeros(len(h_arr), dtype=np.int64)
        except (ValueError, OverflowError):
            raise FinchSchemaError(f"Error parsing {path!r}")
        kseg = segs and _segment_for(kmers, "kmers", segs)
        if kseg is not None:
            if kseg:
                scan = native.sk_scan_kseg(kseg)
                if scan is None:
                    raise _FastMismatch
                n_k, fixed = scan
                if fixed >= 1:
                    # uniform element length (the universal case: every
                    # kmer is k bases): one memcpy into an (n, L) plane
                    # viewed as fixed-width bytes — zero per-element
                    # Python objects until something materializes them
                    buf = np.frombuffer(kseg + b"\x00", dtype=np.uint8)
                    k_list = (buf.reshape(n_k, fixed + 3)[:, 1:fixed + 1]
                              .copy().view(f"S{fixed}")[:, 0])
                else:
                    k_list = kseg[1:-1].split(b'","')
            else:
                k_list = []
        else:
            k_list = ([k.encode("utf-8") for k in kmers]
                      if kmers is not None else [b""] * len(h_arr))
        kmercounts = LazyKmerCounts(h_arr, k_list, c_arr, e_arr)
        filters = js.get("filters") or {}
        filter_params = FilterParams.from_serialized(filters)
        sketches.append(Sketch(
            name=js.get("name", ""),
            seq_length=int(js.get("seqLength") or 0),
            num_valid_kmers=int(js.get("numValidKmers") or 0),
            comment=js.get("comment") or "",
            hashes=kmercounts,
            filter_params=filter_params,
            sketch_params=sketch_params,
        ))
    return sketches


def read_sk_file(data: bytes, path: str = "<bytes>") -> List[Sketch]:
    """Parse a MultiSketch JSON document into Sketch objects
    (json.rs:91-139, 220-238)."""
    fast = _extract_segments(data)
    if fast is not None:
        residual, segs = fast
        try:
            doc = json.loads(residual)
        except json.JSONDecodeError:
            fast = None
        if fast is not None:
            try:
                return _build_sketches(doc, segs, path)
            except _FastMismatch:
                pass  # not compact serde output — general path below
    try:
        doc = json.loads(data)
    except json.JSONDecodeError:
        raise FinchSchemaError(f"Error parsing {path!r}")
    return _build_sketches(doc, None, path)
