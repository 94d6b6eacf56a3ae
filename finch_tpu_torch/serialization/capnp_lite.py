"""Minimal Cap'n Proto (standard serialization) runtime.

Just enough of the wire format to read/write the two fixed schemas the
reference uses (finch.capnp / mash.capnp): segment framing, struct & list
pointers (incl. composite struct lists), Text/Data, bool bitfields, default
masks, and far pointers on the read path (capnp builders emit multi-segment
messages for large sketch collections).

Wire format reference: capnproto.org/encoding.html. The field offsets used by
the codecs were pinned against the reference's capnpc-generated accessors
(finch-rs/lib/src/serialization/finch_capnp.rs,
 finch-rs/lib/src/serialization/mash_capnp.rs).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from finch_tpu_torch.errors import FinchSchemaError

WORD = 8


class CapnpError(FinchSchemaError):
    pass


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class MessageReader:
    def __init__(self, data: bytes, traversal_limit_words: int = 1 << 30):
        if len(data) < 8:
            raise CapnpError("truncated capnp message")
        n_minus_1 = struct.unpack_from("<I", data, 0)[0]
        nseg = n_minus_1 + 1
        header_words = (nseg // 2) + 1
        if len(data) < 4 + 4 * nseg:
            raise CapnpError("truncated capnp segment table")
        sizes = struct.unpack_from(f"<{nseg}I", data, 4)
        self.segments: List[memoryview] = []
        off = header_words * WORD
        for s in sizes:
            end = off + s * WORD
            if end > len(data):
                raise CapnpError("capnp segment extends past buffer")
            self.segments.append(memoryview(data)[off:end])
            off = end
        total = sum(sizes)
        if total > traversal_limit_words:
            raise CapnpError("capnp traversal limit exceeded")

    def root(self) -> "StructReader":
        obj = read_pointer(self.segments, 0, 0)
        if obj is None:
            return StructReader(self.segments, 0, 0, 0, 0, 0)
        if not isinstance(obj, StructReader):
            raise CapnpError("root is not a struct")
        return obj


def _word(seg: memoryview, word_ofs: int) -> int:
    if word_ofs < 0 or (word_ofs + 1) * WORD > len(seg):
        raise CapnpError("capnp pointer outside segment bounds")
    return struct.unpack_from("<Q", seg, word_ofs * WORD)[0]


def read_pointer(segments, seg_id: int, word_ofs: int, _depth: int = 0):
    """Decode the pointer at (seg_id, word_ofs). Returns StructReader,
    ListReader, or None for null."""
    ptr = _word(segments[seg_id], word_ofs)
    if ptr == 0:
        return None
    kind = ptr & 3
    if kind == 2:  # far pointer
        # a single far pointer's landing pad must be an ordinary object
        # pointer: a second far hop (incl. a crafted self-referential
        # pointer) is malformed per the spec and rejected outright
        if _depth >= 1:
            raise CapnpError("far pointer landing pad is itself far")
        double = (ptr >> 2) & 1
        pad_ofs = (ptr >> 3) & ((1 << 29) - 1)
        target_seg = ptr >> 32
        if target_seg >= len(segments):
            raise CapnpError("far pointer to missing segment")
        if not double:
            return read_pointer(segments, target_seg, pad_ofs, _depth + 1)
        # double-far: landing pad is [far ptr to content start, tag word]
        pad = _word(segments[target_seg], pad_ofs)
        if pad & 3 != 2:
            raise CapnpError("bad double-far landing pad")
        content_seg = pad >> 32
        if content_seg >= len(segments):
            raise CapnpError("double-far pointer to missing segment")
        content_ofs = (pad >> 3) & ((1 << 29) - 1)
        tag = _word(segments[target_seg], pad_ofs + 1)
        return _decode_tagged(segments, content_seg, content_ofs, tag)
    # intra-segment struct/list pointer: target is relative to the word
    # after the pointer
    offset = _sign30((ptr >> 2) & ((1 << 30) - 1))
    target = word_ofs + 1 + offset
    return _decode_tagged(segments, seg_id, target, ptr)


def _sign30(v: int) -> int:
    return v - (1 << 30) if v & (1 << 29) else v


def _decode_tagged(segments, seg_id, target, tag):
    # bounds are validated here (and in ListReader for element extents):
    # these files are parsed from untrusted input, so a malformed offset
    # must raise a clean schema error, never index past a segment
    seg_words = len(segments[seg_id]) // WORD
    kind = tag & 3
    if kind == 0:  # struct
        data_words = (tag >> 32) & 0xFFFF
        ptr_words = (tag >> 48) & 0xFFFF
        if target < 0 or target + data_words + ptr_words > seg_words:
            raise CapnpError("capnp struct outside segment bounds")
        return StructReader(segments, seg_id, target, data_words, ptr_words,
                            0)
    if kind == 1:  # list
        elem_size = (tag >> 32) & 7
        count = (tag >> 35) & ((1 << 29) - 1)
        if target < 0:
            raise CapnpError("capnp list outside segment bounds")
        return ListReader(segments, seg_id, target, elem_size, count)
    raise CapnpError(f"unsupported pointer kind {kind}")


class StructReader:
    __slots__ = ("segments", "seg_id", "word_ofs", "data_words", "ptr_words",
                 "_unused")

    def __init__(self, segments, seg_id, word_ofs, data_words, ptr_words,
                 _unused):
        self.segments = segments
        self.seg_id = seg_id
        self.word_ofs = word_ofs
        self.data_words = data_words
        self.ptr_words = ptr_words

    def _data(self) -> memoryview:
        seg = self.segments[self.seg_id]
        start = self.word_ofs * WORD
        return seg[start : start + self.data_words * WORD]

    def _get(self, fmt: str, size: int, index: int, default: int = 0):
        off = index * size
        data = self._data()
        if off + size > len(data):
            return default if fmt in "QIHB" else 0.0
        return struct.unpack_from("<" + fmt, data, off)[0]

    def get_u64(self, i, mask=0):
        return self._get("Q", 8, i) ^ mask

    def get_u32(self, i, mask=0):
        return self._get("I", 4, i) ^ mask

    def get_u16(self, i, mask=0):
        return self._get("H", 2, i) ^ mask

    def get_u8(self, i, mask=0):
        return self._get("B", 1, i) ^ mask

    def get_f64(self, i):
        return self._get("d", 8, i)

    def get_f32(self, i):
        return self._get("f", 4, i)

    def get_bool(self, bit: int, default: bool = False) -> bool:
        byte = bit // 8
        data = self._data()
        if byte >= len(data):
            return default
        return bool((data[byte] >> (bit % 8)) & 1) ^ default

    def get_ptr(self, i: int):
        if i >= self.ptr_words:
            return None
        return read_pointer(self.segments, self.seg_id,
                            self.word_ofs + self.data_words + i)

    def get_text(self, i: int) -> Optional[str]:
        obj = self.get_ptr(i)
        if obj is None:
            return None
        if not isinstance(obj, ListReader):
            raise CapnpError("expected text pointer")
        try:
            return obj.as_bytes()[:-1].decode("utf-8")  # strip NUL
        except UnicodeDecodeError:
            raise CapnpError("capnp text is not valid UTF-8")

    def get_data(self, i: int) -> Optional[bytes]:
        obj = self.get_ptr(i)
        if obj is None:
            return None
        if not isinstance(obj, ListReader):
            raise CapnpError("expected data pointer")
        return obj.as_bytes()

    # duck-type guards: corrupted pointers can hand a struct to code
    # expecting a list; fail as a schema error, not an AttributeError
    def _not_a_list(self, *a, **k):
        raise CapnpError("expected list, found struct")

    structs = composite_layout = primitives_array = _not_a_list
    data_words_matrix = as_bytes = get_struct = _not_a_list

    @property
    def count(self):
        raise CapnpError("expected list, found struct")


ELEM_BITS = {0: 0, 1: 1, 2: 8, 3: 16, 4: 32, 5: 64, 6: 64}


class ListReader:
    __slots__ = ("segments", "seg_id", "word_ofs", "elem_size", "count",
                 "tag")

    def __init__(self, segments, seg_id, word_ofs, elem_size, count):
        self.segments = segments
        self.seg_id = seg_id
        self.elem_size = elem_size
        seg_words = len(segments[seg_id]) // WORD
        if elem_size == 7:  # composite: count word holds total words
            tag = _word(segments[seg_id], word_ofs)
            self.tag = tag
            self.count = (tag >> 2) & ((1 << 30) - 1)  # element count in tag
            self.word_ofs = word_ofs + 1
            dw = (tag >> 32) & 0xFFFF
            pw = (tag >> 48) & 0xFFFF
            if self.word_ofs + (dw + pw) * self.count > seg_words:
                raise CapnpError("capnp composite list outside segment")
            if dw + pw == 0 and self.count > seg_words:
                # zero-size-struct amplification: a 0-word element layout
                # lets a tag claim 2^29 elements inside any segment; the
                # reference's traversal limit rejects the equivalent read
                raise CapnpError("capnp zero-size list amplification")
        else:
            self.tag = 0
            self.count = count
            self.word_ofs = word_ofs
            words = (count * ELEM_BITS[elem_size] + 63) // 64
            if word_ofs + words > seg_words:
                raise CapnpError("capnp list outside segment bounds")

    def __len__(self):
        return self.count

    def as_bytes(self) -> bytes:
        if self.elem_size != 2:
            raise CapnpError("not a byte list")
        seg = self.segments[self.seg_id]
        start = self.word_ofs * WORD
        return bytes(seg[start : start + self.count])

    def get_primitive(self, fmt: str, index: int):
        size = {"I": 4, "Q": 8, "H": 2, "B": 1, "f": 4, "d": 8}[fmt]
        seg = self.segments[self.seg_id]
        return struct.unpack_from(
            "<" + fmt, seg, self.word_ofs * WORD + index * size)[0]

    def primitives_array(self, dtype):
        """Zero-copy numpy view of a primitive list.

        The wire-declared element size must match the requested dtype: a
        malformed pointer declaring a narrower element class would
        otherwise pass __init__'s (smaller) bounds check and surface as
        a raw numpy buffer error here instead of a clean CapnpError."""
        import numpy as np

        dt = np.dtype(dtype)
        if self.elem_size > 5 or ELEM_BITS[self.elem_size] != dt.itemsize * 8:
            raise CapnpError("capnp primitive list element size mismatch")
        seg = self.segments[self.seg_id]
        return np.frombuffer(seg, dtype=dt, count=self.count,
                             offset=self.word_ofs * WORD)

    def get_struct(self, index: int) -> StructReader:
        if self.elem_size == 7:
            data_words = (self.tag >> 32) & 0xFFFF
            ptr_words = (self.tag >> 48) & 0xFFFF
            stride = data_words + ptr_words
            return StructReader(self.segments, self.seg_id,
                                self.word_ofs + index * stride, data_words,
                                ptr_words, 0)
        if self.elem_size == 6:  # list of pointers
            obj = read_pointer(self.segments, self.seg_id,
                               self.word_ofs + index)
            if not isinstance(obj, StructReader):
                raise CapnpError("expected struct element")
            return obj
        raise CapnpError("not a struct list")

    def structs(self):
        return [self.get_struct(i) for i in range(self.count)]

    # duck-type guards (see StructReader): code expecting a struct must get
    # a schema error when a corrupted pointer resolves to a list
    def _not_a_struct(self, *a, **k):
        raise CapnpError("expected struct, found list")

    get_ptr = get_text = get_data = _not_a_struct
    get_u64 = get_u32 = get_u16 = get_u8 = _not_a_struct
    get_f64 = get_f32 = get_bool = _not_a_struct

    def composite_layout(self):
        """(data_words, ptr_words) of a composite list's elements, or
        None for pointer lists."""
        if self.elem_size != 7:
            return None
        return ((self.tag >> 32) & 0xFFFF, (self.tag >> 48) & 0xFFFF)

    def data_words_matrix(self):
        """(count, data_words) uint64 matrix of every element's data
        section — a zero-copy strided view for bulk field extraction."""
        import numpy as np

        layout = self.composite_layout()
        if layout is None:
            raise CapnpError("not a composite struct list")
        dw, pw = layout
        stride = dw + pw
        seg = self.segments[self.seg_id]
        start = self.word_ofs * WORD
        full = np.frombuffer(
            seg, dtype=np.uint64, count=self.count * stride,
            offset=start).reshape(self.count, stride)
        return full[:, :dw]


# ---------------------------------------------------------------------------
# Writer (single segment)
# ---------------------------------------------------------------------------

class MessageBuilder:
    def __init__(self):
        self.buf = bytearray(WORD)  # word 0 = root pointer

    def nwords(self) -> int:
        return len(self.buf) // WORD

    def alloc(self, nwords: int) -> int:
        ofs = self.nwords()
        self.buf.extend(b"\x00" * (nwords * WORD))
        return ofs

    def _put_word(self, word_ofs: int, value: int) -> None:
        struct.pack_into("<Q", self.buf, word_ofs * WORD, value)

    @staticmethod
    def _check_offset(offset: int) -> None:
        # single-segment writer: a pointer offset is a signed 30-bit word
        # count; fail loudly instead of silently wrapping past ~4 GiB
        if not -(1 << 29) <= offset < (1 << 29):
            raise CapnpError("message exceeds single-segment pointer range")

    def write_struct_ptr(self, ptr_ofs: int, target_ofs: int,
                         data_words: int, ptr_words: int) -> None:
        offset = target_ofs - (ptr_ofs + 1)
        self._check_offset(offset)
        self._put_word(ptr_ofs, (offset & ((1 << 30) - 1)) << 2
                       | (data_words << 32) | (ptr_words << 48))

    def write_list_ptr(self, ptr_ofs: int, target_ofs: int, elem_size: int,
                       count: int) -> None:
        offset = target_ofs - (ptr_ofs + 1)
        self._check_offset(offset)
        self._put_word(ptr_ofs, 1 | ((offset & ((1 << 30) - 1)) << 2)
                       | (elem_size << 32) | (count << 35))

    def new_struct(self, ptr_ofs: int, data_words: int,
                   ptr_words: int) -> "StructBuilder":
        target = self.alloc(data_words + ptr_words)
        self.write_struct_ptr(ptr_ofs, target, data_words, ptr_words)
        return StructBuilder(self, target, data_words, ptr_words)

    def root_struct(self, data_words: int, ptr_words: int) -> "StructBuilder":
        return self.new_struct(0, data_words, ptr_words)

    def new_composite_list(self, ptr_ofs: int, count: int, data_words: int,
                           ptr_words: int) -> List["StructBuilder"]:
        stride = data_words + ptr_words
        elem0 = self.init_composite_region(ptr_ofs, count, data_words,
                                           ptr_words)
        return [StructBuilder(self, elem0 + i * stride, data_words,
                              ptr_words) for i in range(count)]

    def init_composite_region(self, ptr_ofs: int, count: int,
                              data_words: int, ptr_words: int) -> int:
        """Allocate a composite list and return the word offset of its
        first element (past the tag word); new_composite_list wraps the
        elements in StructBuilders, bulk numpy fills use the offset
        directly."""
        stride = data_words + ptr_words
        total = count * stride
        target = self.alloc(1 + total)
        # list pointer: element size 7, "count" = total words
        self.write_list_ptr(ptr_ofs, target, 7, total)
        # tag word: struct-ptr-shaped with element count in offset slot
        self._put_word(target, ((count & ((1 << 30) - 1)) << 2)
                       | (data_words << 32) | (ptr_words << 48))
        return target + 1

    def write_bytes_list(self, ptr_ofs: int, data: bytes,
                         nul_terminate: bool) -> None:
        n = len(data) + (1 if nul_terminate else 0)
        nwords = (n + WORD - 1) // WORD
        target = self.alloc(nwords)
        self.write_list_ptr(ptr_ofs, target, 2, n)
        self.buf[target * WORD : target * WORD + len(data)] = data

    def write_primitive_list(self, ptr_ofs: int, fmt: str, values) -> None:
        size = {"I": 4, "Q": 8, "H": 2, "B": 1, "f": 4, "d": 8}[fmt]
        elem_code = {1: 2, 2: 3, 4: 4, 8: 5}[size]
        n = len(values)
        nwords = (n * size + WORD - 1) // WORD
        target = self.alloc(nwords)
        self.write_list_ptr(ptr_ofs, target, elem_code, n)
        if type(values).__module__ == "numpy":  # bulk path, no arg tuple
            dt = {"I": "<u4", "Q": "<u8", "H": "<u2", "B": "u1",
                  "f": "<f4", "d": "<f8"}[fmt]
            raw = values.astype(dt, copy=False).tobytes()
            self.buf[target * WORD: target * WORD + len(raw)] = raw
        else:
            struct.pack_into(f"<{n}{fmt}", self.buf, target * WORD, *values)

    def to_bytes(self) -> bytes:
        # single segment: header = [0 (count-1), size], already 8-byte aligned
        header = struct.pack("<II", 0, self.nwords())
        return header + bytes(self.buf)


class StructBuilder:
    __slots__ = ("msg", "word_ofs", "data_words", "ptr_words")

    def __init__(self, msg: MessageBuilder, word_ofs: int, data_words: int,
                 ptr_words: int):
        self.msg = msg
        self.word_ofs = word_ofs
        self.data_words = data_words
        self.ptr_words = ptr_words

    def _data_byte(self, byte_ofs: int) -> int:
        return self.word_ofs * WORD + byte_ofs

    def set(self, fmt: str, index: int, value, mask: int = 0) -> None:
        size = {"I": 4, "Q": 8, "H": 2, "B": 1, "f": 4, "d": 8}[fmt]
        if fmt in ("f", "d"):
            struct.pack_into("<" + fmt, self.msg.buf,
                             self._data_byte(index * size), value)
        else:
            struct.pack_into("<" + fmt, self.msg.buf,
                             self._data_byte(index * size), value ^ mask)

    def set_bool(self, bit: int, value: bool) -> None:
        byte = self._data_byte(bit // 8)
        if value:
            self.msg.buf[byte] |= 1 << (bit % 8)
        else:
            self.msg.buf[byte] &= ~(1 << (bit % 8))

    def ptr_ofs(self, i: int) -> int:
        return self.word_ofs + self.data_words + i

    def set_text(self, i: int, s: str) -> None:
        self.msg.write_bytes_list(self.ptr_ofs(i), s.encode("utf-8"), True)

    def set_data(self, i: int, b: bytes) -> None:
        self.msg.write_bytes_list(self.ptr_ofs(i), b, False)

    def init_struct(self, i: int, data_words: int,
                    ptr_words: int) -> "StructBuilder":
        return self.msg.new_struct(self.ptr_ofs(i), data_words, ptr_words)

    def init_composite_list(self, i: int, count: int, data_words: int,
                            ptr_words: int):
        return self.msg.new_composite_list(self.ptr_ofs(i), count, data_words,
                                           ptr_words)

    def set_primitive_list(self, i: int, fmt: str, values) -> None:
        self.msg.write_primitive_list(self.ptr_ofs(i), fmt, values)
