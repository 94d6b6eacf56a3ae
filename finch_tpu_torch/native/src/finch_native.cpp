// finch_tpu_torch native host layer.
//
// Re-design of the host-side duties that the reference implements
// in Rust (finch-rs): FASTA/FASTQ(.gz) parsing + base normalization +
// canonical k-mer enumeration (behavioral contract of needletail 0.5.0 as
// used by finch-rs/lib/src/sketch_schemes/mash.rs:67-80), plus a
// scalar MurmurHash3_x64_128 oracle (contract of the murmurhash3 crate used
// at finch-rs/lib/src/sketch_schemes/hashing.rs:9-12).
//
// Design: this layer turns ragged genomic records into dense, fixed-width
// arrays of 2-bit-packed canonical k-mer codes — the ideal input layout for
// the GPU hash + bottom-k pipeline. All per-byte branchy work happens here;
// all wide data-parallel work (hashing, sorting, top-k, set intersection)
// happens on the device.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <type_traits>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

// ---------------------------------------------------------------------------
// MurmurHash3_x64_128 (public-domain algorithm by Austin Appleby), scalar.
// Matches the murmurhash3 Rust crate's x64_128 with a u64 seed:
// h1 = h2 = seed. finch keeps only h1 (hashing.rs:10-12).
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

static inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);  // little-endian hosts only (x86/ARM LE)
  return v;
}

extern "C" void fn_murmur3_x64_128(const uint8_t* key, uint64_t len,
                                   uint64_t seed, uint64_t* out2) {
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t nblocks = len / 16;
  for (uint64_t i = 0; i < nblocks; i++) {
    uint64_t k1 = load_le64(key + 16 * i);
    uint64_t k2 = load_le64(key + 16 * i + 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ULL;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ULL;
  }
  const uint8_t* tail = key + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= uint64_t(tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= uint64_t(tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= uint64_t(tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= uint64_t(tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= uint64_t(tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= uint64_t(tail[9]) << 8; [[fallthrough]];
    case 9:  k2 ^= uint64_t(tail[8]);
             k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
             [[fallthrough]];
    case 8:  k1 ^= uint64_t(tail[7]) << 56; [[fallthrough]];
    case 7:  k1 ^= uint64_t(tail[6]) << 48; [[fallthrough]];
    case 6:  k1 ^= uint64_t(tail[5]) << 40; [[fallthrough]];
    case 5:  k1 ^= uint64_t(tail[4]) << 32; [[fallthrough]];
    case 4:  k1 ^= uint64_t(tail[3]) << 24; [[fallthrough]];
    case 3:  k1 ^= uint64_t(tail[2]) << 16; [[fallthrough]];
    case 2:  k1 ^= uint64_t(tail[1]) << 8; [[fallthrough]];
    case 1:  k1 ^= uint64_t(tail[0]);
             k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= len; h2 ^= len;
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2; h2 += h1;
  out2[0] = h1;
  out2[1] = h2;
}

// Hash a batch of equal-length byte keys laid out contiguously.
extern "C" void fn_murmur3_batch(const uint8_t* keys, uint64_t n,
                                 uint32_t keylen, uint64_t seed,
                                 uint64_t* out_h1) {
  uint64_t out2[2];
  for (uint64_t i = 0; i < n; i++) {
    fn_murmur3_x64_128(keys + uint64_t(i) * keylen, keylen, seed, out2);
    out_h1[i] = out2[0];
  }
}

// Decode a 2-bit-packed k-mer code (base 0 in the most-significant position)
// into ASCII bytes. Mapping A=0, C=1, G=2, T=3 (needletail bitkmer order).
static const uint8_t BASE_ASCII[4] = {'A', 'C', 'G', 'T'};

extern "C" void fn_unpack_kmers(const uint64_t* packed, uint64_t n, uint32_t k,
                                uint8_t* out /* n*k bytes */) {
  for (uint64_t i = 0; i < n; i++) {
    uint64_t v = packed[i];
    for (uint32_t j = 0; j < k; j++) {
      out[i * k + (k - 1 - j)] = BASE_ASCII[v & 3];
      v >>= 2;
    }
  }
}

// Hash packed k-mers directly (decode + murmur). CPU reference / fallback
// path; the production path does this on the GPU.
extern "C" void fn_murmur3_packed(const uint64_t* packed, uint64_t n,
                                  uint32_t k, uint64_t seed, uint64_t* out) {
  uint8_t buf[64];
  uint64_t out2[2];
  if (k > 32) return;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t v = packed[i];
    for (uint32_t j = 0; j < k; j++) {
      buf[k - 1 - j] = BASE_ASCII[v & 3];
      v >>= 2;
    }
    fn_murmur3_x64_128(buf, k, seed, out2);
    out[i] = out2[0];
  }
}

// Wide variants (32 <= k <= 63): packed codes span two u64 words — `lo`
// holds bits [0, 64), `hi` bits [64, 2k) — with base 0 still in the most-
// significant position so integer comparison == lexicographic byte
// comparison. The reference hashes the ASCII bytes of any-k canonical
// k-mers (hashing.rs:9-12, mash.rs:73-79: needletail works on byte slices
// with no k bound); these paths extend the packed pipeline to the long-kmer
// range metagenomics uses (k up to 63).

extern "C" void fn_unpack_kmers_w(const uint64_t* plo, const uint64_t* phi,
                                  uint64_t n, uint32_t k,
                                  uint8_t* out /* n*k bytes */) {
  for (uint64_t i = 0; i < n; i++) {
    unsigned __int128 v = ((unsigned __int128)phi[i] << 64) | plo[i];
    for (uint32_t j = 0; j < k; j++) {
      out[i * k + (k - 1 - j)] = BASE_ASCII[(uint32_t)(v & 3)];
      v >>= 2;
    }
  }
}

extern "C" void fn_murmur3_packed_w(const uint64_t* plo, const uint64_t* phi,
                                    uint64_t n, uint32_t k, uint64_t seed,
                                    uint64_t* out) {
  uint8_t buf[64];
  uint64_t out2[2];
  if (k > 63) return;
  for (uint64_t i = 0; i < n; i++) {
    unsigned __int128 v = ((unsigned __int128)phi[i] << 64) | plo[i];
    for (uint32_t j = 0; j < k; j++) {
      buf[k - 1 - j] = BASE_ASCII[(uint32_t)(v & 3)];
      v >>= 2;
    }
    fn_murmur3_x64_128(buf, k, seed, out2);
    out[i] = out2[0];
  }
}

// ---------------------------------------------------------------------------
// FASTA/FASTQ(.gz) streaming parser + canonical k-mer extractor.
//
// Behavioral contract (needletail 0.5.0 as consumed by finch):
//  * Format autodetected from the first byte: '>' FASTA, '@' FASTQ
//    (lib.rs:60-75 uses needletail's parse_fastx_reader).
//  * `seq.sequence()` is the raw sequence region: for FASTA it includes
//    internal newlines (multi-line records), for FASTQ it is the sequence
//    line. finch accumulates seq_length from it (mash.rs:72).
//  * normalize(false): a/c/g->upper, t/u/U->'T', whitespace removed,
//    './~'->'-', everything else -> 'N' (needletail sequence normalization).
//  * canonical_kmers(k, rc): windows over the normalized buffer; windows
//    containing non-ACGT are skipped; canonical = lexicographic
//    min(fwd, revcomp); is_rc = (revcomp <= fwd)  (ties -> rc branch).
//
// Emission: 2-bit packed codes (A=0,C=1,G=2,T=3), base 0 in the MSBs so that
// integer comparison == lexicographic byte comparison. k <= 31 on this path.
// ---------------------------------------------------------------------------

enum SrcKind {
  SRC_GZFILE = 0,
  SRC_MEM = 1,
  SRC_MEMGZ = 2,
  SRC_PLAIN = 3,
  SRC_FD = 4,    // non-seekable fd (stdin/pipes), plain bytes
  SRC_FDGZ = 5,  // non-seekable fd, streaming gzip inflate
};

struct Source {
  SrcKind kind;
  gzFile gzf;
  FILE* pf;  // PLAIN: direct stdio reads (no zlib buffer round-trip)
  // MEM / MEMGZ
  const uint8_t* data;
  uint64_t len;
  uint64_t pos;
  z_stream zs;
  bool z_end;
  // FD / FDGZ: O(1)-memory pipe streaming (lib.rs:38-43 reads stdin
  // through the same record loop as any file)
  int fd;
  uint8_t hdr[2];        // sniffed magic bytes, replayed before fd reads
  uint32_t hdr_len, hdr_pos;
  uint8_t* zin;          // FDGZ: compressed staging buffer
  uint64_t zin_cap;
};

// read(2) with EINTR retry; returns bytes read (0 = EOF), -1 on error
static int64_t fd_read(int fd, uint8_t* dst, uint64_t want) {
  for (;;) {
    ssize_t r = read(fd, dst, (size_t)want);
    if (r >= 0) return (int64_t)r;
    if (errno != EINTR) return -1;
  }
}

static int64_t src_read(Source* s, uint8_t* dst, uint64_t want) {
  switch (s->kind) {
    case SRC_GZFILE: {
      int r = gzread(s->gzf, dst, (unsigned)want);
      return (int64_t)r;  // <0 on error
    }
    case SRC_PLAIN: {
      size_t r = fread(dst, 1, (size_t)want, s->pf);
      if (r == 0 && ferror(s->pf)) return -1;
      return (int64_t)r;
    }
    case SRC_MEM: {
      uint64_t n = s->len - s->pos;
      if (n > want) n = want;
      memcpy(dst, s->data + s->pos, n);
      s->pos += n;
      return (int64_t)n;
    }
    case SRC_MEMGZ: {
      if (s->z_end) return 0;
      s->zs.next_out = dst;
      s->zs.avail_out = (uInt)want;
      s->zs.next_in = const_cast<Bytef*>(s->data + s->pos);
      s->zs.avail_in = (uInt)(s->len - s->pos);
      int ret = inflate(&s->zs, Z_NO_FLUSH);
      s->pos = s->len - s->zs.avail_in;
      if (ret == Z_STREAM_END) s->z_end = true;
      else if (ret != Z_OK && ret != Z_BUF_ERROR) return -1;
      return (int64_t)(want - s->zs.avail_out);
    }
    case SRC_FD: {
      if (s->hdr_pos < s->hdr_len) {
        uint64_t h = s->hdr_len - s->hdr_pos;
        if (h > want) h = want;
        memcpy(dst, s->hdr + s->hdr_pos, h);
        s->hdr_pos += (uint32_t)h;
        return (int64_t)h;
      }
      return fd_read(s->fd, dst, want);
    }
    case SRC_FDGZ: {
      if (s->z_end) return 0;
      s->zs.next_out = dst;
      s->zs.avail_out = (uInt)want;
      while (s->zs.avail_out > 0 && !s->z_end) {
        if (s->zs.avail_in == 0) {
          int64_t got;
          if (s->hdr_pos < s->hdr_len) {
            memcpy(s->zin, s->hdr + s->hdr_pos, s->hdr_len - s->hdr_pos);
            got = (int64_t)(s->hdr_len - s->hdr_pos);
            s->hdr_pos = s->hdr_len;
          } else {
            got = fd_read(s->fd, s->zin, s->zin_cap);
            if (got < 0) return -1;
            if (got == 0) {
              // truncated stream: EOF before Z_STREAM_END
              return (s->zs.avail_out == (uInt)want) ? -1 : (int64_t)(
                  want - s->zs.avail_out);
            }
          }
          s->zs.next_in = s->zin;
          s->zs.avail_in = (uInt)got;
        }
        int ret = inflate(&s->zs, Z_NO_FLUSH);
        if (ret == Z_STREAM_END) {
          // concatenated gzip members (bgzip/pigz output): keep going
          // while compressed input remains
          if (s->zs.avail_in > 0) {
            if (inflateReset(&s->zs) != Z_OK) return -1;
          } else {
            // EOF-or-more ambiguity resolves at the next call: peek one
            // read; empty -> done
            int64_t got = fd_read(s->fd, s->zin, s->zin_cap);
            if (got < 0) return -1;
            if (got == 0) { s->z_end = true; break; }
            if (inflateReset(&s->zs) != Z_OK) return -1;
            s->zs.next_in = s->zin;
            s->zs.avail_in = (uInt)got;
          }
        } else if (ret != Z_OK && ret != Z_BUF_ERROR) {
          return -1;
        }
      }
      return (int64_t)(want - s->zs.avail_out);
    }
  }
  return -1;
}

// Byte classes for normalization + k-mer validity.
//   0..3 : base code (A,C,G,T; lowercase + u/U folded in)
//   4    : skip (whitespace/newlines — removed by normalize)
//   5    : invalid (N, IUPAC, gaps, everything else — breaks k-mer windows)
static uint8_t BYTE_CLASS[256];
static bool byte_class_init_done = false;
static void byte_class_init() {
  if (byte_class_init_done) return;
  for (int i = 0; i < 256; i++) BYTE_CLASS[i] = 5;
  BYTE_CLASS['A'] = BYTE_CLASS['a'] = 0;
  BYTE_CLASS['C'] = BYTE_CLASS['c'] = 1;
  BYTE_CLASS['G'] = BYTE_CLASS['g'] = 2;
  BYTE_CLASS['T'] = BYTE_CLASS['t'] = 3;
  BYTE_CLASS['U'] = BYTE_CLASS['u'] = 3;  // uridine -> thymine
  BYTE_CLASS['\n'] = BYTE_CLASS['\r'] = BYTE_CLASS[' '] = BYTE_CLASS['\t'] = 4;
  byte_class_init_done = true;
}

enum PState {
  P_START = 0,      // before first record: detect format
  P_HEADER,         // inside a header line (after > or @), skip to \n
  P_FASTA_SEQ,      // FASTA sequence region (line starts matter)
  P_FASTQ_SEQ,      // FASTQ sequence line
  P_FASTQ_PLUS,     // '+' separator line
  P_FASTQ_QUAL,     // quality line (consume seq_len bases, ignoring \n rule)
  P_DONE,
};

struct Parser {
  Source src;
  // input buffer
  uint8_t* buf;
  uint64_t cap;
  uint64_t fill;   // valid bytes in buf
  uint64_t cur;    // consume cursor
  bool eof;

  PState state;
  int format;            // 0 unknown, 1 fasta, 2 fastq
  bool at_line_start;    // for FASTA '>' detection

  // rolling k-mer state (within current record); the _hi words carry
  // bits [64, 2k) on the wide (k > 31) path and stay 0 otherwise
  uint64_t fwd, rev;
  uint64_t fwd_hi, rev_hi;
  uint32_t vlen;         // current run of valid bases
  // per-record counters
  uint64_t rec_raw;      // raw sequence-region bytes (incl. internal \n)
  uint64_t rec_trail_ws; // trailing whitespace run (to subtract at rec end)
  uint64_t fq_seq_len;   // FASTQ: bases in seq line
  uint64_t fq_qual_seen; // FASTQ: qual bytes consumed

  // totals (monotonic; snapshot with fn_totals)
  uint64_t total_bases;
  uint64_t total_kmers;
  uint64_t total_records;
  int err;

  // SIMD pack scratch: a pure-base run's 2-bit codes as MSB-first
  // bitstreams — fbuf forward, rbuf complemented-and-reversed — so k-mer
  // windows extract as unaligned big-endian loads (see pack_run/win_be)
  uint8_t* fbuf;
  uint8_t* rbuf;
  uint64_t packcap;

  // within-record chunk continuation (parallel pipeline, giant FASTA
  // records): `prime` raw bytes at the start of the stream re-seed the
  // rolling window of a record cut mid-sequence — they update fwd/rev/
  // vlen but are not counted or emitted (the previous chunk owned every
  // window ending inside them). `ends_mid` marks a chunk whose end is a
  // mid-record cut: its EOF adds rec_raw WITHOUT the trailing-whitespace
  // subtraction (the cut's tail whitespace is internal to the record)
  // and does not complete a record.
  uint64_t prime;
  int ends_mid;
};

static Parser* parser_new() {
  Parser* p = (Parser*)calloc(1, sizeof(Parser));
  p->cap = 1 << 20;
  p->buf = (uint8_t*)malloc(p->cap);
  p->state = P_START;
  p->at_line_start = true;
  byte_class_init();
  return p;
}

extern "C" void* fn_open_fd(int fd, int* err);

extern "C" void* fn_open_path(const char* path, int* err) {
  *err = 0;
  // plain files bypass zlib entirely (gzread on uncompressed input still
  // round-trips every byte through zlib's window buffer)
  FILE* pf = fopen(path, "rb");
  if (!pf) { *err = 2; return nullptr; }  // no such file
  struct stat st;
  if (fstat(fileno(pf), &st) != 0 || !S_ISREG(st.st_mode)) {
    // a FIFO, a process substitution or a device cannot rewind after the
    // magic sniff: stream its fd, which replays the sniffed bytes (nothing
    // was read through the FILE, so its buffer holds none of them)
    Parser* p = (Parser*)fn_open_fd(fileno(pf), err);
    if (!p) { fclose(pf); return nullptr; }
    p->src.pf = pf;  // owned: fn_close closes it
    return p;
  }
  uint8_t magic[2];
  size_t got = fread(magic, 1, 2, pf);
  if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
    fclose(pf);
    gzFile f = gzopen(path, "rb");
    if (!f) { *err = 2; return nullptr; }
    Parser* p = parser_new();
    p->src.kind = SRC_GZFILE;
    p->src.gzf = f;
    return p;
  }
  rewind(pf);
  Parser* p = parser_new();
  p->src.kind = SRC_PLAIN;
  p->src.pf = pf;
  return p;
}

extern "C" void* fn_open_bytes(const uint8_t* data, uint64_t len, int* err) {
  *err = 0;
  Parser* p = parser_new();
  if (len >= 2 && data[0] == 0x1f && data[1] == 0x8b) {
    p->src.kind = SRC_MEMGZ;
    p->src.data = data;
    p->src.len = len;
    memset(&p->src.zs, 0, sizeof(z_stream));
    if (inflateInit2(&p->src.zs, 15 + 32) != Z_OK) { *err = 3; free(p->buf); free(p); return nullptr; }
  } else {
    p->src.kind = SRC_MEM;
    p->src.data = data;
    p->src.len = len;
  }
  return p;
}

// Stream a non-seekable fd (stdin = 0) with O(1) memory, gzip or plain,
// matching the reference's stdin path (lib.rs:38-43). The fd is NOT
// closed by fn_close (the caller owns it — closing stdin would be rude).
extern "C" void* fn_open_fd(int fd, int* err) {
  *err = 0;
  Parser* p = parser_new();
  Source* s = &p->src;
  s->fd = fd;
  int64_t got = 0;
  while (got < 2) {
    int64_t r = fd_read(fd, s->hdr + got, 2 - (uint64_t)got);
    if (r < 0) { *err = 4; free(p->buf); free(p); return nullptr; }
    if (r == 0) break;
    got += r;
  }
  s->hdr_len = (uint32_t)got;
  s->hdr_pos = 0;
  if (got == 2 && s->hdr[0] == 0x1f && s->hdr[1] == 0x8b) {
    s->kind = SRC_FDGZ;
    memset(&s->zs, 0, sizeof(z_stream));
    if (inflateInit2(&s->zs, 15 + 32) != Z_OK) {
      *err = 3;
      free(p->buf);
      free(p);
      return nullptr;
    }
    s->zin_cap = 1 << 18;
    s->zin = (uint8_t*)malloc(s->zin_cap);
    if (!s->zin) {
      *err = 7;
      inflateEnd(&s->zs);
      free(p->buf);
      free(p);
      return nullptr;
    }
  } else {
    s->kind = SRC_FD;
  }
  return p;
}

extern "C" void fn_close(void* h) {
  Parser* p = (Parser*)h;
  if (!p) return;
  if (p->src.kind == SRC_GZFILE && p->src.gzf) gzclose(p->src.gzf);
  if (p->src.pf) fclose(p->src.pf);  // PLAIN, or an FD source it opened
  if (p->src.kind == SRC_MEMGZ || p->src.kind == SRC_FDGZ)
    inflateEnd(&p->src.zs);
  free(p->src.zin);
  free(p->fbuf);
  free(p->rbuf);
  free(p->buf);
  free(p);
}

static bool refill(Parser* p) {
  if (p->eof) return false;
  // compact
  if (p->cur > 0) {
    memmove(p->buf, p->buf + p->cur, p->fill - p->cur);
    p->fill -= p->cur;
    p->cur = 0;
  }
  if (p->fill == p->cap) {  // buffer full without newline — grow
    p->cap *= 2;
    p->buf = (uint8_t*)realloc(p->buf, p->cap);
  }
  int64_t n = src_read(&p->src, p->buf + p->fill, p->cap - p->fill);
  if (n < 0) { p->err = 4; p->eof = true; return false; }
  if (n == 0) { p->eof = true; return false; }
  p->fill += (uint64_t)n;
  return true;
}

// Finish the current record (FASTA at '>' or EOF; FASTQ after qual).
static void end_record(Parser* p) {
  p->total_bases += p->rec_raw - p->rec_trail_ws;
  p->total_records += 1;
  p->rec_raw = 0;
  p->rec_trail_ws = 0;
  p->fwd = p->rev = 0;
  p->fwd_hi = p->rev_hi = 0;
  p->vlen = 0;
}

// ---------------------------------------------------------------------------
// SIMD fast path for pure-ACGT runs (the overwhelmingly common sequence
// content): classify + 2-bit-pack the whole run into two MSB-first
// bitstreams (forward codes; complemented codes in reversed base order),
// then extract every canonical k-mer window as two unaligned big-endian
// 64-bit loads + shifts. This removes the scalar loop's 2-cycle
// loop-carried rolling-window dependency: window extractions are fully
// independent across positions, so the CPU pipelines them. AVX2 when the
// build host has it (-march=native), scalar pack fallback otherwise —
// results are bit-identical either way.
// ---------------------------------------------------------------------------

// Length of the leading pure-base prefix (A/C/G/T/U, either case): the
// bytes a packed run may contain. Stops at whitespace, N, or any other
// byte (BYTE_CLASS >= 4).
static inline uint64_t pure_base_prefix(const uint8_t* s, uint64_t len) {
  uint64_t i = 0;
#if defined(__AVX2__)
  const __m256i df = _mm256_set1_epi8((char)0xDF);
  const __m256i vA = _mm256_set1_epi8('A'), vC = _mm256_set1_epi8('C');
  const __m256i vG = _mm256_set1_epi8('G'), vT = _mm256_set1_epi8('T');
  const __m256i vU = _mm256_set1_epi8('U');
  for (; i + 32 <= len; i += 32) {
    __m256i b = _mm256_loadu_si256((const __m256i*)(s + i));
    __m256i up = _mm256_and_si256(b, df);
    __m256i v = _mm256_or_si256(
        _mm256_or_si256(_mm256_cmpeq_epi8(up, vA), _mm256_cmpeq_epi8(up, vC)),
        _mm256_or_si256(
            _mm256_cmpeq_epi8(up, vG),
            _mm256_or_si256(_mm256_cmpeq_epi8(up, vT),
                            _mm256_cmpeq_epi8(up, vU))));
    uint32_t m = (uint32_t)_mm256_movemask_epi8(v);
    if (m != 0xFFFFFFFFu) return i + (uint64_t)__builtin_ctz(~m);
  }
#endif
  for (; i < len; i++)
    if (BYTE_CLASS[s[i]] >= 4) break;
  return i;
}

#if defined(__AVX2__)
// 2-bit codes of 32 base bytes via a low-nibble LUT. Valid for verified
// base bytes only: low nibbles are A/a=1, C/c=3, G/g=7, T/t=4, U/u=5.
static inline __m256i base_codes32(__m256i b) {
  const __m256i lut = _mm256_setr_epi8(
      0, 0, 0, 1, 3, 3, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0,
      0, 0, 0, 1, 3, 3, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0);
  // ASCII bytes have the high bit clear, so shuffle_epi8 never zeroes
  return _mm256_shuffle_epi8(lut, b);
}

// Pack 32 codes (one per byte, memory order = base order) into 8 packed
// bytes, earliest base in each byte's MSBs: out_byte = c0<<6|c1<<4|c2<<2|c3.
static inline uint64_t pack_codes32(__m256i codes) {
  // (c0,c1) byte pairs -> 16-bit c0*4+c1; (t0,t1) pairs -> 32-bit t0*16+t1
  __m256i t = _mm256_maddubs_epi16(codes, _mm256_set1_epi16(0x0104));
  __m256i u = _mm256_madd_epi16(t, _mm256_set1_epi32(0x00010010));
  __m256i sh = _mm256_shuffle_epi8(u, _mm256_setr_epi8(
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1));
  __m256i g = _mm256_permutevar8x32_epi32(
      sh, _mm256_setr_epi32(0, 4, 0, 0, 0, 0, 0, 0));
  return (uint64_t)_mm256_extract_epi64(g, 0);
}

// Reverse the byte order of a whole 256-bit vector.
static inline __m256i byte_reverse32(__m256i b) {
  const __m256i rev = _mm256_setr_epi8(
      15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0,
      15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
  b = _mm256_shuffle_epi8(b, rev);
  return _mm256_permute2x128_si256(b, b, 0x01);
}
#endif

// false (and p->err = 7) when the scratch cannot be allocated
static bool ensure_packcap(Parser* p, uint64_t bases) {
  uint64_t need = bases / 4 + 16;  // +slack: win_be reads 8 bytes past use
  if (p->packcap < need) {
    uint64_t cap = p->packcap ? p->packcap : (1 << 12);
    while (cap < need) cap *= 2;
    free(p->fbuf);
    free(p->rbuf);
    p->fbuf = (uint8_t*)malloc(cap);
    p->rbuf = (uint8_t*)malloc(cap);
    if (!p->fbuf || !p->rbuf) {
      free(p->fbuf);
      free(p->rbuf);
      p->fbuf = p->rbuf = nullptr;
      p->packcap = 0;
      p->err = 7;
      return false;
    }
    p->packcap = cap;
  }
  return true;
}

// Pack a verified pure-base run s[0..L) into fbuf (forward codes) and rbuf
// (complemented codes in reversed base order), both MSB-first: base t's
// two bits sit at bitstream position 2t counted from byte 0's MSB.
static void pack_run(const uint8_t* s, uint64_t L, uint8_t* fbuf,
                     uint8_t* rbuf) {
  uint64_t m = 0;
#if defined(__AVX2__)
  for (; m + 32 <= L; m += 32) {
    __m256i b = _mm256_loadu_si256((const __m256i*)(s + m));
    uint64_t w = pack_codes32(base_codes32(b));
    memcpy(fbuf + (m >> 2), &w, 8);
  }
#endif
  for (; m < L; m += 4) {
    uint8_t v = 0;
    for (uint64_t t = 0; t < 4 && m + t < L; t++)
      v |= (uint8_t)((BYTE_CLASS[s[m + t]] & 3) << (6 - 2 * t));
    fbuf[m >> 2] = v;
  }
  m = 0;
#if defined(__AVX2__)
  const __m256i three = _mm256_set1_epi8(3);
  for (; m + 32 <= L; m += 32) {
    __m256i b = _mm256_loadu_si256((const __m256i*)(s + (L - m - 32)));
    __m256i codes = _mm256_xor_si256(base_codes32(byte_reverse32(b)), three);
    uint64_t w = pack_codes32(codes);
    memcpy(rbuf + (m >> 2), &w, 8);
  }
#endif
  for (; m < L; m += 4) {
    uint8_t v = 0;
    for (uint64_t t = 0; t < 4 && m + t < L; t++)
      v |= (uint8_t)(((BYTE_CLASS[s[L - 1 - (m + t)]] & 3) ^ 3)
                     << (6 - 2 * t));
    rbuf[m >> 2] = v;
  }
  // zero the slack so loads past the last packed byte read defined data
  uint64_t nb = (L + 3) >> 2;
  memset(fbuf + nb, 0, 8);
  memset(rbuf + nb, 0, 8);
}

// Extract the 2k-bit window starting at base index `start` of an MSB-first
// bitstream. Requires 2k + 7 <= 64 (k <= 28): the window plus the
// within-byte offset must fit one 64-bit load.
static inline uint64_t win_be(const uint8_t* buf, uint64_t start,
                              uint32_t k2) {
  const uint64_t bitpos = 2 * start;
  uint64_t v;
  memcpy(&v, buf + (bitpos >> 3), 8);
  v = __builtin_bswap64(v);
  return (v << (bitpos & 7)) >> (64 - k2);
}

// The extraction core. Returns:
//   1  produced >=1 k-mer and output is full (call again)
//   0  EOF reached, all input consumed
//  -1  error (p->err set): 1=empty/unknown format, 4=read error, 5=bad fastq,
//      7=out of memory
//
// canonical != 0: emit canonical codes + is_rc flags (Mash/Scaled schemes).
// canonical == 0: emit forward-strand codes only (AllCounts scheme,
//                 needletail bit_kmers semantics, counts.rs:30).
// EMIT=0: (packed u64, is_rc u8) pairs — the classic layout.
// EMIT=1: composite u32 planes — lo/hi halves of ((packed << 1) | is_rc),
//         exactly the operand layout of the fused device kernel
//         (ops/extract.py), so no device-side prep pass is needed.
// EMIT=2: wide layout for 32 <= k <= 63 — (packed_lo u64, packed_hi u64,
//         is_rc u8) triples; rolling state is a 2k-bit __int128 window.
template <int EMIT>
static int parse_batch_impl(void* h, uint32_t k, int canonical, uint64_t cap,
                            uint64_t* out_kmers, uint8_t* out_rc,
                            uint32_t* out_lo, uint32_t* out_hi,
                            uint64_t* out_phi,
                            uint64_t* n_out, int* format_out) {
  using KT = typename std::conditional<EMIT == 2, unsigned __int128,
                                       uint64_t>::type;
  Parser* p = (Parser*)h;
  *n_out = 0;
  if (p->err) { return -1; }
  if (EMIT == 2) {
    if (k < 32 || k > 63) { p->err = 6; return -1; }
  } else {
    if (k < 1 || k > 31) { p->err = 6; return -1; }
  }
  const KT mask = ((KT)1 << (2 * k)) - 1;
  const uint32_t rshift = 2 * (k - 1);
  uint64_t n = 0;

  while (true) {
    if (p->cur >= p->fill) {
      if (!refill(p)) break;  // EOF or error
    }
    // Fast path: bulk-process sequence bytes, span by span. memchr (glibc
    // SIMD) finds the next newline; within a line the inner loop is
    // branch-free (conditional moves + unconditional stores with a
    // predicated index bump). Intra-line whitespace — which normalize
    // REMOVES (the k-mer window spans it) — is rare, so the branchless
    // pass just detects it and redoes the span with exact semantics.
    if (p->state == P_FASTA_SEQ && p->prime > 0) {
      // continuation priming: replay the k-1-overlap bytes into the
      // rolling window without counting or emitting
      KT pfwd = (KT)p->fwd, prev = (KT)p->rev;
      if (EMIT == 2) {
        pfwd |= (KT)p->fwd_hi << 63 << 1;
        prev |= (KT)p->rev_hi << 63 << 1;
      }
      uint32_t pvlen = p->vlen;
      uint64_t i = p->cur;
      const uint64_t end = p->fill;
      uint8_t lastb = 0;
      while (i < end && p->prime > 0) {
        const uint8_t b = p->buf[i];
        const uint8_t cls = BYTE_CLASS[b];
        if (cls < 4) {
          pfwd = ((pfwd << 2) | (KT)cls) & mask;
          prev = (prev >> 2) | ((KT)(3 - cls) << rshift);
          pvlen++;
        } else if (cls == 5) {
          pvlen = 0;
        }
        lastb = b;
        i++;
        p->prime--;
      }
      p->fwd = (uint64_t)pfwd; p->rev = (uint64_t)prev;
      if (EMIT == 2) {
        p->fwd_hi = (uint64_t)(pfwd >> 63 >> 1);
        p->rev_hi = (uint64_t)(prev >> 63 >> 1);
      }
      p->vlen = pvlen;
      p->cur = i;
      if (i > 0) p->at_line_start = (lastb == '\n');
      if (p->cur >= p->fill) goto outer_continue;
    }
    if (p->state == P_FASTA_SEQ || p->state == P_FASTQ_SEQ) {
      uint64_t i = p->cur;
      const uint64_t end = p->fill;
      KT fwd = (KT)p->fwd, rev = (KT)p->rev;
      if (EMIT == 2) {
        fwd |= (KT)p->fwd_hi << 63 << 1;  // <<64 in two steps: KT may be u64
        rev |= (KT)p->rev_hi << 63 << 1;
      }
      uint32_t vlen = p->vlen;
      uint64_t rec_raw = p->rec_raw, trail = p->rec_trail_ws;
      uint64_t kmers = p->total_kmers;
      bool line_start = p->at_line_start;
      const bool is_fasta = (p->state == P_FASTA_SEQ);

      while (i < end && n < cap) {
        if (is_fasta && line_start && p->buf[i] == '>') {
          // record boundary
          p->fwd = (uint64_t)fwd; p->rev = (uint64_t)rev;
          if (EMIT == 2) {
            p->fwd_hi = (uint64_t)(fwd >> 63 >> 1);
            p->rev_hi = (uint64_t)(rev >> 63 >> 1);
          }
          p->vlen = vlen;
          p->rec_raw = rec_raw; p->rec_trail_ws = trail;
          p->total_kmers = kmers;
          end_record(p);
          p->state = P_HEADER;
          p->cur = i + 1;
          p->at_line_start = false;
          goto outer_continue;
        }

        const uint8_t* nlp =
            (const uint8_t*)memchr(p->buf + i, '\n', end - i);
        const uint64_t span_end = nlp ? (uint64_t)(nlp - p->buf) : end;
        const uint64_t budget = cap - n;
        const uint64_t lim =
            (span_end - i > budget) ? i + budget : span_end;

        // SIMD fast path (canonical emission, k <= 28): pack the leading
        // pure-base run into 2-bit bitstreams and extract windows with
        // independent unaligned loads (see pack_run/win_be above). The
        // first k-1 bases go through the rolling update (their windows
        // depend on carry-in state from the previous line/run); windows
        // ending at j >= k-1 lie entirely inside the verified run.
        if ((EMIT == 0 || EMIT == 1) && canonical && k <= 28 && lim > i) {
          const uint64_t r = pure_base_prefix(p->buf + i, lim - i);
          if (r >= 2 * (uint64_t)k) {
            const uint64_t hd = (uint64_t)k - 1;
            if (vlen == 0) {
              // fresh record/run (every FASTQ read lands here): no window
              // ending in the first k-1 bases can emit, and the rolling
              // state is recomputed from the bitstreams below — the
              // scalar priming loop is pure overhead
              vlen = (uint32_t)hd;
            } else
            for (uint64_t t = 0; t < hd; t++) {
              const uint64_t code = BYTE_CLASS[p->buf[i + t]];
              fwd = ((fwd << 2) | (KT)code) & mask;
              rev = (rev >> 2) | ((KT)(3 - code) << rshift);
              vlen++;
              // branchless emit: unconditional store + predicated index
              // bump (stores at a non-emitting n are overwritten later;
              // n stays < cap because head emissions are <= hd < budget)
              const uint64_t fw = (uint64_t)fwd, rv = (uint64_t)rev;
              const uint64_t rcv = (uint64_t)(fw >= rv);
              const uint64_t kv = rv ^ ((fw ^ rv) & (rcv - 1));
              if (EMIT == 0) {
                out_kmers[n] = kv;
                out_rc[n] = (uint8_t)rcv;
              } else {
                const uint64_t comp = (kv << 1) | rcv;
                out_lo[n] = (uint32_t)comp;
                out_hi[n] = (uint32_t)(comp >> 32);
              }
              const uint64_t emit = (vlen >= k);
              n += emit;
              kmers += emit;
            }
            if (!ensure_packcap(p, r)) return -1;
            pack_run(p->buf + i, r, p->fbuf, p->rbuf);
            const uint32_t k2 = 2 * k;
            const uint8_t* fb = p->fbuf;
            const uint8_t* rb = p->rbuf;
            uint64_t j = hd;
#if defined(__AVX2__)
            // 4 windows per iteration: they span one byte of bitstream,
            // so ONE 64-bit BE load per stream feeds all four lanes via
            // per-lane shifts. Headroom: (bitpos&7) + 6 + 2k <= 64
            // requires k <= 26; 27/28 take the scalar loop below.
            if (k <= 26) {
              const __m256i lane_f = _mm256_setr_epi64x(0, 2, 4, 6);
              const __m256i lane_r = _mm256_setr_epi64x(6, 4, 2, 0);
              const __m256i sign =
                  _mm256_set1_epi64x((long long)0x8000000000000000ULL);
              const __m256i sr = _mm256_set1_epi64x(64 - (int)k2);
              const uint64_t r1 = r - 1;
              for (; j + 4 <= r; j += 4) {
                const uint64_t bf = 2 * (j - hd);
                uint64_t vf;
                memcpy(&vf, fb + (bf >> 3), 8);
                vf = __builtin_bswap64(vf);
                const uint64_t br = 2 * (r1 - j - 3);
                uint64_t vr;
                memcpy(&vr, rb + (br >> 3), 8);
                vr = __builtin_bswap64(vr);
                __m256i F = _mm256_set1_epi64x((long long)vf);
                __m256i R = _mm256_set1_epi64x((long long)vr);
                __m256i shf = _mm256_add_epi64(
                    _mm256_set1_epi64x((long long)(bf & 7)), lane_f);
                __m256i shr_ = _mm256_add_epi64(
                    _mm256_set1_epi64x((long long)(br & 7)), lane_r);
                F = _mm256_srlv_epi64(_mm256_sllv_epi64(F, shf), sr);
                R = _mm256_srlv_epi64(_mm256_sllv_epi64(R, shr_), sr);
                // unsigned 64-bit fw >= rv via sign-biased signed compare
                __m256i ge = _mm256_or_si256(
                    _mm256_cmpgt_epi64(_mm256_xor_si256(F, sign),
                                       _mm256_xor_si256(R, sign)),
                    _mm256_cmpeq_epi64(F, R));
                __m256i kv = _mm256_blendv_epi8(F, R, ge);
                if (EMIT == 0) {
                  _mm256_storeu_si256((__m256i*)(out_kmers + n), kv);
                  const int mk =
                      _mm256_movemask_pd(_mm256_castsi256_pd(ge));
                  out_rc[n] = (uint8_t)(mk & 1);
                  out_rc[n + 1] = (uint8_t)((mk >> 1) & 1);
                  out_rc[n + 2] = (uint8_t)((mk >> 2) & 1);
                  out_rc[n + 3] = (uint8_t)((mk >> 3) & 1);
                } else {
                  __m256i comp = _mm256_or_si256(
                      _mm256_slli_epi64(kv, 1), _mm256_srli_epi64(ge, 63));
                  __m256i perm = _mm256_permutevar8x32_epi32(
                      comp, _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7));
                  _mm_storeu_si128((__m128i*)(out_lo + n),
                                   _mm256_castsi256_si128(perm));
                  _mm_storeu_si128((__m128i*)(out_hi + n),
                                   _mm256_extracti128_si256(perm, 1));
                }
                n += 4;
              }
            }
#endif
            for (; j < r; j++) {
              const uint64_t fw = win_be(fb, j - hd, k2);
              const uint64_t rv = win_be(rb, r - 1 - j, k2);
              // branchless canonical select: fw-vs-rv is a coin flip on
              // real sequence, so a conditional branch here mispredicts
              // ~50% and dominates the loop (measured 203 -> 550+ MB/s)
              const uint64_t rcv = (uint64_t)(fw >= rv);
              const uint64_t kv = rv ^ ((fw ^ rv) & (rcv - 1));
              if (EMIT == 0) {
                out_kmers[n] = kv;
                out_rc[n] = (uint8_t)rcv;
              } else {
                const uint64_t comp = (kv << 1) | rcv;
                out_lo[n] = (uint32_t)comp;
                out_hi[n] = (uint32_t)(comp >> 32);
              }
              n++;
            }
            kmers += r - hd;
            // rolling state = the run's last window (packed forms match
            // the rolling representation bit-for-bit)
            fwd = (KT)win_be(fb, r - k, k2);
            rev = (KT)win_be(rb, 0, k2);
            vlen += (uint32_t)(r - hd);
            rec_raw += r;
            trail = 0;
            i += r;
            line_start = false;
            continue;
          }
          if (r == 0 && BYTE_CLASS[p->buf[i]] == 5) {
            // bulk-consume an invalid-byte run (N homopolymers etc.):
            // raw bytes count, the k-mer window resets, nothing emits
            uint64_t j = i + 1;
            while (j < lim && BYTE_CLASS[p->buf[j]] == 5) j++;
            rec_raw += j - i;
            trail = 0;
            vlen = 0;
            i = j;
            line_start = false;
            continue;
          }
        }

        if (lim > i) {
          const KT save_fwd = fwd, save_rev = rev;
          const uint32_t save_vlen = vlen;
          const uint64_t save_n = n, save_kmers = kmers;
          uint32_t saw_ws = 0;
          for (uint64_t j = i; j < lim; j++) {
            const uint8_t cls = BYTE_CLASS[p->buf[j]];
            saw_ws |= (cls == 4);
            const uint64_t code = cls & 3;
            fwd = ((fwd << 2) | (KT)code) & mask;
            rev = (rev >> 2) | ((KT)(3 - code) << rshift);
            vlen = (cls < 4) ? vlen + 1 : 0;
            const KT canon = fwd < rev ? fwd : rev;
            if (EMIT == 4) {
              // run-mode: forward codes + run-start flag (vlen == k means
              // this is the first window of a valid-base run / record) —
              // the host-side xwide (k >= 64) path reconstructs the
              // normalized base runs from this stream
              out_kmers[n] = (uint64_t)fwd;
              out_rc[n] = (uint8_t)(vlen == k);
            } else if (EMIT == 0) {
              out_kmers[n] = (uint64_t)(canonical ? canon : fwd);
              out_rc[n] = canonical ? (uint8_t)(fwd >= rev) : 0;
            } else if (EMIT == 2) {
              const KT kv = canonical ? canon : fwd;
              out_kmers[n] = (uint64_t)kv;
              out_phi[n] = (uint64_t)(kv >> 63 >> 1);
              out_rc[n] = canonical ? (uint8_t)(fwd >= rev) : 0;
            } else {
              const uint64_t comp = canonical
                  ? (((uint64_t)canon << 1) | (uint64_t)(fwd >= rev))
                  : ((uint64_t)fwd << 1);
              out_lo[n] = (uint32_t)comp;
              out_hi[n] = (uint32_t)(comp >> 32);
            }
            const uint64_t emit = (vlen >= k);
            n += emit;
            kmers += emit;
          }
          if (saw_ws) {
            // exact redo: whitespace is removed by normalization, so the
            // window continues across it and raw/trailing counters differ
            fwd = save_fwd; rev = save_rev; vlen = save_vlen;
            n = save_n; kmers = save_kmers;
            for (uint64_t j = i; j < lim; j++) {
              const uint8_t cls = BYTE_CLASS[p->buf[j]];
              if (cls < 4) {
                rec_raw++; trail = 0;
                fwd = ((fwd << 2) | (KT)cls) & mask;
                rev = (rev >> 2) | ((KT)(3 - cls) << rshift);
                if (++vlen >= k) {
                  KT kv;
                  uint64_t rcv;
                  if (canonical && fwd >= rev) { kv = rev; rcv = 1; }
                  else                         { kv = fwd; rcv = 0; }
                  if (EMIT == 4) {
                    out_kmers[n] = (uint64_t)fwd;
                    out_rc[n] = (uint8_t)(vlen == k);
                  } else if (EMIT == 0) {
                    out_kmers[n] = (uint64_t)kv;
                    out_rc[n] = (uint8_t)rcv;
                  } else if (EMIT == 2) {
                    out_kmers[n] = (uint64_t)kv;
                    out_phi[n] = (uint64_t)(kv >> 63 >> 1);
                    out_rc[n] = (uint8_t)rcv;
                  } else {
                    const uint64_t comp = ((uint64_t)kv << 1) | rcv;
                    out_lo[n] = (uint32_t)comp;
                    out_hi[n] = (uint32_t)(comp >> 32);
                  }
                  n++; kmers++;
                }
              } else if (cls == 4) {
                rec_raw++; trail++;
              } else {
                rec_raw++; trail = 0;
                vlen = 0;
              }
            }
          } else {
            rec_raw += lim - i;
            trail = 0;
          }
          i = lim;
          line_start = false;
        }

        if (i < span_end) {
          // output budget exhausted mid-line
          break;
        }
        if (nlp != nullptr && i == span_end) {
          if (!is_fasta) {
            // FASTQ sequence line ends
            p->fwd = (uint64_t)fwd; p->rev = (uint64_t)rev;
          if (EMIT == 2) {
            p->fwd_hi = (uint64_t)(fwd >> 63 >> 1);
            p->rev_hi = (uint64_t)(rev >> 63 >> 1);
          }
          p->vlen = vlen;
            p->rec_raw = rec_raw; p->rec_trail_ws = trail;
            p->total_kmers = kmers;
            p->fq_seq_len = rec_raw;  // seq line counts no internal ws raw
            p->state = P_FASTQ_PLUS;
            p->cur = i + 1;
            p->at_line_start = true;
            goto outer_continue;
          }
          // FASTA: the newline is whitespace in the raw sequence region
          rec_raw++; trail++;
          i++;
          line_start = true;
        }
      }
      p->fwd = (uint64_t)fwd; p->rev = (uint64_t)rev;
      if (EMIT == 2) {
        p->fwd_hi = (uint64_t)(fwd >> 63 >> 1);
        p->rev_hi = (uint64_t)(rev >> 63 >> 1);
      }
      p->vlen = vlen;
      p->rec_raw = rec_raw; p->rec_trail_ws = trail;
      p->total_kmers = kmers;
      p->at_line_start = line_start;
      p->cur = i;
      if (n >= cap) { *n_out = n; *format_out = p->format; return 1; }
      goto outer_continue;
    }

    // Line-structured control states: bulk-skip with memchr instead of
    // the per-byte switch (qual lines are ~half of a FASTQ's bytes).
    if (p->state == P_HEADER || p->state == P_FASTQ_PLUS) {
      const uint8_t* nl = (const uint8_t*)memchr(p->buf + p->cur, '\n',
                                                 p->fill - p->cur);
      if (!nl) { p->cur = p->fill; goto outer_continue; }
      p->cur = (uint64_t)(nl - p->buf) + 1;
      if (p->state == P_HEADER) {
        p->state = (p->format == 1) ? P_FASTA_SEQ : P_FASTQ_SEQ;
        p->at_line_start = true;
        p->rec_raw = 0;
        p->rec_trail_ws = 0;
        p->fwd = p->rev = 0;
        p->fwd_hi = p->rev_hi = 0;
        p->vlen = 0;
      } else {
        p->state = P_FASTQ_QUAL;
        p->fq_qual_seen = 0;
      }
      goto outer_continue;
    }
    if (p->state == P_FASTQ_QUAL) {
      const uint64_t avail = p->fill - p->cur;
      const uint8_t* nl = (const uint8_t*)memchr(p->buf + p->cur, '\n',
                                                 avail);
      if (!nl) {
        p->fq_qual_seen += avail;
        p->cur = p->fill;
        goto outer_continue;
      }
      p->fq_qual_seen += (uint64_t)(nl - p->buf) - p->cur;
      p->cur = (uint64_t)(nl - p->buf) + 1;
      if (p->fq_qual_seen != p->fq_seq_len) { p->err = 5; return -1; }
      end_record(p);
      p->state = P_START;  // expect '@' of the next record
      goto outer_continue;
    }

    // Slow path: format detection, byte at a time.
    {
      uint8_t b = p->buf[p->cur++];
      switch (p->state) {
        case P_START:
          if (b == '>' && (p->format == 0 || p->format == 1)) {
            p->format = 1; p->state = P_HEADER;
          } else if (b == '@' && (p->format == 0 || p->format == 2)) {
            p->format = 2; p->state = P_HEADER;
          } else if (b == '\n' || b == '\r' || b == ' ' || b == '\t') {
            /* skip leading/inter-record whitespace */
          } else {
            p->err = 1; return -1;
          }
          p->at_line_start = false;
          break;
        case P_HEADER:
          if (b == '\n') {
            p->state = (p->format == 1) ? P_FASTA_SEQ : P_FASTQ_SEQ;
            p->at_line_start = true;
            p->rec_raw = 0; p->rec_trail_ws = 0;
            p->fwd = p->rev = 0;
            p->fwd_hi = p->rev_hi = 0;
            p->vlen = 0;
          }
          break;
        case P_FASTQ_PLUS:
          if (b == '\n') { p->state = P_FASTQ_QUAL; p->fq_qual_seen = 0; }
          break;
        case P_FASTQ_QUAL:
          if (b == '\n') {
            if (p->fq_qual_seen != p->fq_seq_len) { p->err = 5; return -1; }
            end_record(p);
            p->state = P_START;   // expect '@' of the next record
          } else {
            p->fq_qual_seen++;
          }
          break;
        default:
          break;
      }
    }
  outer_continue:;
    if (n >= cap) { *n_out = n; *format_out = p->format; return 1; }
  }

  if (p->err) { return -1; }
  // EOF: close out a trailing record
  if (p->state == P_FASTA_SEQ && p->ends_mid) {
    // mid-record cut: tail whitespace is internal (the aligner cuts only
    // where sequence continues), so count it raw and complete no record
    p->total_bases += p->rec_raw;
    p->rec_raw = 0;
    p->rec_trail_ws = 0;
    p->state = P_DONE;
  } else if (p->state == P_FASTA_SEQ) {
    end_record(p);
    p->state = P_DONE;
  } else if (p->state == P_FASTQ_QUAL && p->fq_qual_seen == p->fq_seq_len &&
             p->fq_seq_len > 0) {
    // qual line without trailing newline at EOF
    end_record(p);
    p->state = P_DONE;
  } else if (p->state == P_START && p->format == 0) {
    if (p->total_records == 0) { p->err = 1; return -1; }  // empty input
    p->state = P_DONE;
  } else if (p->state == P_START || p->state == P_DONE) {
    p->state = P_DONE;
  } else if (p->state == P_FASTQ_SEQ || p->state == P_FASTQ_PLUS ||
             p->state == P_FASTQ_QUAL) {
    p->err = 5;  // truncated fastq record
    return -1;
  } else if (p->state == P_HEADER) {
    p->err = 5;  // header without sequence at EOF
    return -1;
  }
  *n_out = n;
  *format_out = p->format;
  return (n > 0) ? 1 : 0;
}

extern "C" int fn_next_batch(void* h, uint32_t k, int canonical, uint64_t cap,
                             uint64_t* out_kmers, uint8_t* out_rc,
                             uint64_t* n_out, int* format_out) {
  return parse_batch_impl<0>(h, k, canonical, cap, out_kmers, out_rc,
                             nullptr, nullptr, nullptr, n_out, format_out);
}

// Composite-plane variant: out_lo/out_hi are u32[cap].
extern "C" int fn_next_batch_c(void* h, uint32_t k, int canonical,
                               uint64_t cap, uint32_t* out_lo,
                               uint32_t* out_hi, uint64_t* n_out,
                               int* format_out) {
  return parse_batch_impl<1>(h, k, canonical, cap, nullptr, nullptr,
                             out_lo, out_hi, nullptr, n_out, format_out);
}

// Wide variant for 32 <= k <= 63: (packed_lo u64, packed_hi u64, is_rc u8).
extern "C" int fn_next_batch_w(void* h, uint32_t k, int canonical,
                               uint64_t cap, uint64_t* out_lo64,
                               uint64_t* out_hi64, uint8_t* out_rc,
                               uint64_t* n_out, int* format_out) {
  return parse_batch_impl<2>(h, k, canonical, cap, out_lo64, out_rc,
                             nullptr, nullptr, out_hi64, n_out, format_out);
}

// Run-mode variant (the xwide k >= 64 substrate): forward-strand k'-mer
// codes (k' <= 31, the caller passes 31) with a run-start flag in place of
// is_rc. From this stream the host reconstructs every maximal valid-base
// run exactly — first window decodes to k' bases, each later window
// appends its low 2 bits — and slides arbitrary-k byte windows over it
// (the reference hashes canonical byte windows of any k, mash.rs:73-79).
extern "C" int fn_next_batch_r(void* h, uint32_t k, uint64_t cap,
                               uint64_t* out_codes, uint8_t* out_start,
                               uint64_t* n_out, int* format_out) {
  return parse_batch_impl<4>(h, k, /*canonical=*/0, cap, out_codes,
                             out_start, nullptr, nullptr, nullptr, n_out,
                             format_out);
}

extern "C" void fn_totals(void* h, uint64_t* bases, uint64_t* kmers,
                          uint64_t* records) {
  Parser* p = (Parser*)h;
  *bases = p->total_bases;
  *kmers = p->total_kmers;
  *records = p->total_records;
}

extern "C" int fn_error(void* h) { return ((Parser*)h)->err; }

// ===========================================================================
// Streaming parallel parse pipeline.
//
// The reference's only parallelism is rayon::par_iter over FILES
// (finch-rs/lib/src/lib.rs:34-47); everything inside a file is a
// serial streaming loop. Here one file streams through a native pipeline so
// a single multi-GB FASTQ can saturate both the host cores and the GPU:
//
//   [reader]  -> fixed blocks (plain read / serial zlib inflate / BGZF
//                block groups handed to an inflate pool, reassembled
//                in order)
//   [aligner] -> record-aligned chunks: FASTA splits at "\n>", FASTQ walks
//                lines with the 4-line state machine (incl. the serial
//                parser's blank-line-between-records tolerance)
//   [parse pool] -> each chunk runs the streaming Parser above over its
//                own memory span, emitting packed k-mer batches
//   [consumer] -> fn_pnext pops batches in exact file order, so the
//                emitted k-mer stream is byte-identical to the serial
//                reader's and totals sum exactly
//
// Memory is bounded by max_live chunks regardless of file size (no
// whole-file residency). BGZF (bgzip) inputs decompress in parallel;
// plain gzip decompresses serially but overlaps with parsing.
// ===========================================================================

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace ppipe {

struct PBatch {
  // uninitialized buffers: a zeroing resize would add three extra memory
  // passes per batch, which dominates the whole pipeline at 1 thread.
  // classic layout: kmers/rc. composite layout: lo/hi u32 planes.
  std::unique_ptr<uint64_t[]> kmers;
  std::unique_ptr<uint8_t[]> rc;
  std::unique_ptr<uint32_t[]> lo;
  std::unique_ptr<uint32_t[]> hi;
  uint64_t n = 0;
};

struct PChunk {
  uint64_t id = 0;
  std::string text;  // record-aligned span of the input
  std::deque<PBatch> ready;   // parsed batches not yet consumed
  uint64_t bases = 0, kmers = 0, records = 0;
  int fmt = 0;
  int err = 0;
  bool parsed = false;  // worker finished this chunk
  // within-record splitting (giant FASTA records): this chunk continues a
  // record cut mid-sequence (`cont`, with `prime` overlap bytes prepended
  // to re-seed the k-mer window) and/or ends at a mid-record cut
  // (`ends_mid`)
  int cont = 0;
  uint64_t prime = 0;
  int ends_mid = 0;
};

using ChunkPtr = std::shared_ptr<PChunk>;

// A group of BGZF members to inflate as one task.
struct GzGroup {
  uint64_t id = 0;
  std::string comp;    // concatenated complete gzip members
  std::string text;    // inflated output
  bool done = false;
  int err = 0;
};
using GroupPtr = std::shared_ptr<GzGroup>;

struct Pipeline {
  // --- config -----------------------------------------------------------
  uint32_t k = 21;
  int canonical = 1;
  int composite = 0;  // emit ((packed<<1)|rc) u32 planes instead
  uint64_t batch_cap = 1 << 22;
  int nthreads = 1;
  uint64_t chunk_target = 4 << 20;
  int max_live = 0;  // chunks in flight

  // --- input source -----------------------------------------------------
  FILE* file = nullptr;          // plain / bgzf path source
  gzFile gzf = nullptr;          // serial-gz path source
  const uint8_t* mem = nullptr;  // byte source
  uint64_t mem_len = 0, mem_pos = 0;
  z_stream zs;                   // serial-gz over bytes
  bool zs_live = false;
  enum Mode { PLAIN, SERIAL_GZ, BGZF } mode = PLAIN;

  // --- chunk queues -----------------------------------------------------
  std::mutex mu;
  std::condition_variable cv_work;     // parse workers wait here
  std::condition_variable cv_ready;    // consumer waits here
  std::condition_variable cv_space;    // aligner waits here
  std::deque<ChunkPtr> work_q;         // unparsed chunks
  std::deque<ChunkPtr> order_q;        // all live chunks, file order
  bool aligner_done = false;
  int err = 0;
  bool closing = false;
  int fmt = 0;

  // --- bgzf inflate stage ----------------------------------------------
  std::condition_variable cv_gz_work;   // inflators wait
  std::condition_variable cv_gz_ready;  // aligner waits for ordered text
  std::condition_variable cv_gz_space;  // reader waits
  std::deque<GroupPtr> gz_work_q;
  std::deque<GroupPtr> gz_order_q;
  bool reader_done = false;

  // --- totals (consumed chunks only) ------------------------------------
  uint64_t total_bases = 0, total_kmers = 0, total_records = 0;

  std::vector<std::thread> threads;

  ~Pipeline() {
    {
      std::unique_lock<std::mutex> lk(mu);
      closing = true;
    }
    cv_work.notify_all();
    cv_ready.notify_all();
    cv_space.notify_all();
    cv_gz_work.notify_all();
    cv_gz_ready.notify_all();
    cv_gz_space.notify_all();
    for (auto& t : threads) t.join();
    if (file) fclose(file);
    if (gzf) gzclose(gzf);
    if (zs_live) inflateEnd(&zs);
  }
};

// --------------------------------------------------------------------------
// stage 1: raw block production (into the aligner's buffer)
// --------------------------------------------------------------------------

static int64_t p_read_raw(Pipeline* p, uint8_t* dst, uint64_t want) {
  switch (p->mode) {
    case Pipeline::PLAIN:
      if (p->file) return (int64_t)fread(dst, 1, want, p->file);
      {
        uint64_t n = p->mem_len - p->mem_pos;
        if (n > want) n = want;
        memcpy(dst, p->mem + p->mem_pos, n);
        p->mem_pos += n;
        return (int64_t)n;
      }
    case Pipeline::SERIAL_GZ:
      if (p->gzf) {
        int r = gzread(p->gzf, dst, (unsigned)want);
        return (int64_t)r;
      }
      {
        if (!p->zs_live) return 0;
        p->zs.next_out = dst;
        p->zs.avail_out = (uInt)want;
        p->zs.next_in = const_cast<Bytef*>(p->mem + p->mem_pos);
        p->zs.avail_in = (uInt)(p->mem_len - p->mem_pos);
        int ret = inflate(&p->zs, Z_NO_FLUSH);
        p->mem_pos = p->mem_len - p->zs.avail_in;
        if (ret == Z_STREAM_END) {
          // multi-member gzip: reset and continue if more input
          if (p->mem_pos < p->mem_len) inflateReset2(&p->zs, 15 + 32);
          else { inflateEnd(&p->zs); p->zs_live = false; }
        } else if (ret != Z_OK && ret != Z_BUF_ERROR) {
          return -1;
        }
        return (int64_t)(want - p->zs.avail_out);
      }
    case Pipeline::BGZF:
      return -1;  // handled by the reader/inflate threads
  }
  return -1;
}

// --------------------------------------------------------------------------
// BGZF: header parsing + reader + inflators
// --------------------------------------------------------------------------

// Returns the total member size (BSIZE+1) if `h` starts a BGZF member
// header, else 0. Needs at least 18 bytes.
static uint64_t bgzf_member_size(const uint8_t* h, uint64_t avail) {
  if (avail < 18) return 0;
  if (h[0] != 0x1f || h[1] != 0x8b || h[2] != 8) return 0;
  if (!(h[3] & 4)) return 0;  // FEXTRA
  uint16_t xlen = (uint16_t)h[10] | ((uint16_t)h[11] << 8);
  if (avail < 12u + xlen) return 0;
  uint64_t off = 12;
  uint64_t end = 12u + xlen;
  while (off + 4 <= end) {
    uint8_t si1 = h[off], si2 = h[off + 1];
    uint16_t slen = (uint16_t)h[off + 2] | ((uint16_t)h[off + 3] << 8);
    if (si1 == 66 && si2 == 67 && slen == 2 && off + 6 <= end) {
      uint16_t bsize = (uint16_t)h[off + 4] | ((uint16_t)h[off + 5] << 8);
      return (uint64_t)bsize + 1;
    }
    off += 4 + slen;
  }
  return 0;
}

static void bgzf_reader_main(Pipeline* p) {
  // Reads complete BGZF members, packs ~chunk_target of compressed bytes
  // per group, enqueues for the inflate pool.
  std::string buf;
  uint64_t gid = 0;
  std::string group;
  const uint64_t group_target = 1 << 20;  // ~1MB compressed ≈ 3-4MB raw
  bool fail = false;
  while (!fail) {
    // ensure a full header worth of data
    if (buf.size() < 18) {
      size_t old = buf.size();
      buf.resize(old + (64 << 10));
      int64_t n = 0;
      if (p->file) n = (int64_t)fread(&buf[old], 1, 64 << 10, p->file);
      else {
        uint64_t want = 64 << 10, have = p->mem_len - p->mem_pos;
        if (want > have) want = have;
        memcpy(&buf[old], p->mem + p->mem_pos, want);
        p->mem_pos += want;
        n = (int64_t)want;
      }
      buf.resize(old + (n > 0 ? (size_t)n : 0));
      if (n <= 0) {
        if (!buf.empty()) fail = true;  // trailing garbage
        break;
      }
      continue;
    }
    uint64_t msize = bgzf_member_size((const uint8_t*)buf.data(), buf.size());
    if (msize == 0) { fail = true; break; }
    while (buf.size() < msize) {
      size_t old = buf.size();
      size_t want = msize - old;
      if (want < (64 << 10)) want = 64 << 10;
      buf.resize(old + want);
      int64_t n = 0;
      if (p->file) n = (int64_t)fread(&buf[old], 1, want, p->file);
      else {
        uint64_t avail = p->mem_len - p->mem_pos;
        if ((uint64_t)want > avail) want = avail;
        memcpy(&buf[old], p->mem + p->mem_pos, want);
        p->mem_pos += want;
        n = (int64_t)want;
      }
      buf.resize(old + (n > 0 ? (size_t)n : 0));
      if (n <= 0) break;
    }
    if (buf.size() < msize) { fail = true; break; }  // truncated member
    group.append(buf.data(), msize);
    buf.erase(0, msize);
    if (group.size() >= group_target) {
      auto g = std::make_shared<GzGroup>();
      g->id = gid++;
      g->comp.swap(group);
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_gz_space.wait(lk, [&] {
        return p->closing || p->gz_order_q.size() < (size_t)(p->nthreads + 4);
      });
      if (p->closing) return;
      p->gz_work_q.push_back(g);
      p->gz_order_q.push_back(g);
      lk.unlock();
      p->cv_gz_work.notify_one();
    }
  }
  // final group + done marker
  std::unique_lock<std::mutex> lk(p->mu);
  if (!group.empty()) {
    auto g = std::make_shared<GzGroup>();
    g->id = gid++;
    g->comp.swap(group);
    p->gz_work_q.push_back(g);
    p->gz_order_q.push_back(g);
    p->cv_gz_work.notify_one();
  }
  if (fail && !p->err) p->err = 4;
  p->reader_done = true;
  lk.unlock();
  p->cv_gz_ready.notify_all();
  p->cv_gz_work.notify_all();
}

static void bgzf_inflate_main(Pipeline* p) {
  for (;;) {
    GroupPtr g;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_gz_work.wait(lk, [&] {
        return p->closing || !p->gz_work_q.empty() ||
               (p->reader_done && p->gz_work_q.empty());
      });
      if (p->closing) return;
      if (p->gz_work_q.empty()) return;  // reader done, queue drained
      g = p->gz_work_q.front();
      p->gz_work_q.pop_front();
    }
    // inflate the concatenated members
    z_stream z;
    memset(&z, 0, sizeof(z));
    int err = 0;
    std::string out;
    if (inflateInit2(&z, 15 + 32) != Z_OK) {
      err = 3;
    } else {
      out.reserve(g->comp.size() * 4);
      z.next_in = (Bytef*)g->comp.data();
      z.avail_in = (uInt)g->comp.size();
      char tmp[1 << 16];
      while (true) {
        z.next_out = (Bytef*)tmp;
        z.avail_out = sizeof(tmp);
        int r = inflate(&z, Z_NO_FLUSH);
        out.append(tmp, sizeof(tmp) - z.avail_out);
        if (r == Z_STREAM_END) {
          if (z.avail_in == 0) break;
          if (inflateReset2(&z, 15 + 32) != Z_OK) { err = 4; break; }
        } else if (r != Z_OK && r != Z_BUF_ERROR) {
          err = 4;
          break;
        } else if (z.avail_in == 0 && z.avail_out == sizeof(tmp)) {
          break;  // no progress
        }
      }
      inflateEnd(&z);
    }
    {
      std::unique_lock<std::mutex> lk(p->mu);
      g->text.swap(out);
      g->comp.clear();
      g->comp.shrink_to_fit();
      g->err = err;
      g->done = true;
    }
    p->cv_gz_ready.notify_all();
  }
}

// Pulls the next in-order inflated text block (BGZF mode). Returns -1 on
// error, 0 at EOF, else byte count appended to `dst`.
static int64_t bgzf_next_text(Pipeline* p, std::string& dst) {
  std::unique_lock<std::mutex> lk(p->mu);
  for (;;) {
    if (p->closing) return 0;
    if (!p->gz_order_q.empty()) {
      GroupPtr g = p->gz_order_q.front();
      if (g->done) {
        p->gz_order_q.pop_front();
        lk.unlock();
        p->cv_gz_space.notify_one();
        if (g->err) return -1;
        dst.append(g->text);
        return (int64_t)g->text.size();
      }
      p->cv_gz_ready.wait(lk);
      continue;
    }
    if (p->reader_done) return p->err ? -1 : 0;
    p->cv_gz_ready.wait(lk);
  }
}

// --------------------------------------------------------------------------
// stage 2: the aligner — record-aligned chunking
// --------------------------------------------------------------------------

static bool is_ws_byte(uint8_t b) {
  return b == '\n' || b == '\r' || b == ' ' || b == '\t';
}

struct AlignState {
  int fmt = 0;           // 0 unknown, 1 fasta, 2 fastq
  size_t scan_pos = 0;   // next unwalked byte (fastq line walk)
  int line_state = 0;    // 0 expect record start / blank, 1..3 inside record
  size_t last_boundary = 0;  // most recent record start (> 0 means usable)
};

// Walk newly appended bytes of `buf`, updating the FASTQ line state and the
// last record boundary.
static void fastq_walk(AlignState& st, const std::string& buf) {
  const char* base = buf.data();
  size_t len = buf.size();
  while (st.scan_pos < len) {
    const char* nl = (const char*)memchr(base + st.scan_pos, '\n',
                                         len - st.scan_pos);
    if (!nl) break;  // partial line stays for next round
    size_t line_start = st.scan_pos;
    size_t line_len = (size_t)(nl - base) - line_start;
    if (st.line_state == 0) {
      bool blank = true;
      for (size_t j = line_start; j < line_start + line_len; j++) {
        if (!is_ws_byte((uint8_t)base[j])) { blank = false; break; }
      }
      if (!blank) {
        if (line_start > 0) st.last_boundary = line_start;
        st.line_state = 1;
      }
    } else {
      st.line_state = (st.line_state + 1) & 3;
    }
    st.scan_pos = (size_t)(nl - base) + 1;
  }
}

// Find the last "\n>" boundary in buf (FASTA). Returns 0 if none usable.
static size_t fasta_boundary(const std::string& buf) {
  size_t pos = buf.size();
  while (pos > 1) {
    const void* gt = memrchr(buf.data(), '>', pos);
    if (!gt) return 0;
    size_t at = (size_t)((const char*)gt - buf.data());
    if (at > 0 && buf[at - 1] == '\n') return at;
    if (at == 0) return 0;
    pos = at;
  }
  return 0;
}

static void p_emit_chunk(Pipeline* p, std::string&& text, uint64_t& cid,
                         int cont = 0, uint64_t prime = 0,
                         int ends_mid = 0) {
  auto c = std::make_shared<PChunk>();
  c->id = cid++;
  c->text = std::move(text);
  c->cont = cont;
  c->prime = prime;
  c->ends_mid = ends_mid;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_space.wait(lk, [&] {
    return p->closing || (int)p->order_q.size() < p->max_live;
  });
  if (p->closing) return;
  p->work_q.push_back(c);
  p->order_q.push_back(c);
  lk.unlock();
  p->cv_work.notify_one();
}

// Find a mid-record cut in a boundary-free FASTA buffer: a '\n' at or
// after `from` whose next byte is sequence (non-ws, not '>'), so
// whitespace runs and headers never straddle a cut. Returns the position
// AFTER the newline, or 0 if none.
static size_t fasta_midcut(const std::string& buf, size_t from) {
  size_t pos = from;
  while (pos < buf.size()) {
    const char* nl = (const char*)memchr(buf.data() + pos, '\n',
                                         buf.size() - pos);
    if (!nl) return 0;
    size_t at = (size_t)(nl - buf.data()) + 1;
    if (at >= buf.size()) return 0;
    uint8_t b = (uint8_t)buf[at];
    if (!is_ws_byte(b) && b != '>') return at;
    pos = at;
  }
  return 0;
}

static void aligner_main(Pipeline* p) {
  std::string buf;
  AlignState st;
  uint64_t cid = 0;
  bool io_err = false;
  const uint64_t block = 1 << 20;
  // pending continuation flags for the NEXT emitted chunk (set by a
  // mid-record cut; the overlap bytes are left at the head of buf)
  int pend_cont = 0;
  uint64_t pend_prime = 0;

  for (;;) {
    {
      std::unique_lock<std::mutex> lk(p->mu);
      if (p->closing) return;
    }
    // pull one block
    int64_t n;
    if (p->mode == Pipeline::BGZF) {
      n = bgzf_next_text(p, buf);
    } else {
      size_t old = buf.size();
      buf.resize(old + block);
      n = p_read_raw(p, (uint8_t*)&buf[old], block);
      buf.resize(old + (n > 0 ? (size_t)n : 0));
    }
    if (n < 0) { io_err = true; break; }
    if (n == 0) break;  // EOF

    // detect format on first non-ws byte
    if (st.fmt == 0) {
      size_t i = 0;
      while (i < buf.size() && is_ws_byte((uint8_t)buf[i])) i++;
      if (i < buf.size()) {
        st.fmt = buf[i] == '>' ? 1 : (buf[i] == '@' ? 2 : 3);
      }
    }
    if (st.fmt == 2) fastq_walk(st, buf);
    if (st.fmt == 3) {
      // unknown format: hand the buffer to a parser now so the error
      // surfaces without buffering the rest of the stream
      p_emit_chunk(p, std::move(buf), cid);
      buf.clear();
      break;
    }

    while (buf.size() >= p->chunk_target) {
      size_t cut = 0;
      if (st.fmt == 1) cut = fasta_boundary(buf);
      else if (st.fmt == 2) cut = st.last_boundary;
      if (cut == 0 || cut >= buf.size()) break;  // no split point yet: grow
      std::string chunk = buf.substr(0, cut);
      buf.erase(0, cut);
      // shift fastq walker state
      if (st.fmt == 2) {
        st.scan_pos -= cut;
        st.last_boundary = 0;
      }
      p_emit_chunk(p, std::move(chunk), cid, pend_cont, pend_prime, 0);
      pend_cont = 0;
      pend_prime = 0;
      {
        std::unique_lock<std::mutex> lk(p->mu);
        if (p->closing) return;
      }
    }

    // Within-record splitting: a single giant FASTA record never shows a
    // "\n>" boundary, so the loop above would buffer it whole and hand it
    // to ONE worker. Cut it mid-sequence at a newline followed by more
    // sequence, re-seeding the next chunk's k-mer window with a
    // (k-1)-valid-base overlap — every window is emitted exactly once and
    // raw-byte/record totals stay byte-identical to the serial parser
    // (SURVEY §7.2; exactness notes at Parser::prime/ends_mid).
    while (st.fmt == 1 && buf.size() >= 2 * p->chunk_target &&
           fasta_boundary(buf) == 0) {
      const char* fn = (const char*)memchr(buf.data(), '\n', buf.size());
      if (!fn) break;
      size_t from = (size_t)(fn - buf.data()) + 1;
      if (from < p->chunk_target) from = p->chunk_target;
      size_t cut = fasta_midcut(buf, from);
      if (cut == 0) break;
      // sequence bytes begin after the header line when this buffer
      // still starts with one (possible only at buf[0]:
      // fasta_boundary == 0 rules out any later "\n>" header). The
      // back-scan must never cross into header bytes — ACGT letters in
      // a long header would otherwise be primed as sequence and the
      // continuation chunk would emit k-mers spanning header+sequence
      // that the serial parser never produces.
      size_t seq_start = 0;
      if (buf[0] == '>') seq_start = (size_t)(fn - buf.data()) + 1;
      // overlap back-scan: k-1 valid bases; an invalid byte stops it (no
      // k-mer window spans an invalid base)
      size_t ov = cut;
      uint32_t nbases = 0;
      while (ov > seq_start && nbases < p->k - 1) {
        uint8_t cls = BYTE_CLASS[(uint8_t)buf[ov - 1]];
        if (cls == 5) break;
        if (cls < 4) nbases++;
        ov--;
      }
      // Progress guard: ov is how many bytes this split actually retires
      // (the rest stays buffered as primed overlap). A sparse prefix --
      // e.g. a long blank-line run holding < k-1 valid bases -- can drive
      // ov to 0, and erase(0, 0) would re-emit the same chunk forever
      // (livelock). Requiring a quarter-chunk of progress keeps total
      // work linear; when it trips we simply keep buffering, which is the
      // serial parser's behavior for that stretch of the record.
      if (ov < p->chunk_target / 4) break;
      std::string chunk = buf.substr(0, cut);
      uint64_t prime = cut - ov;
      buf.erase(0, ov);
      p_emit_chunk(p, std::move(chunk), cid, pend_cont, pend_prime, 1);
      pend_cont = 1;
      pend_prime = prime;
      {
        std::unique_lock<std::mutex> lk(p->mu);
        if (p->closing) return;
      }
    }
  }

  if (!buf.empty() || cid == 0) {
    // final chunk (also covers empty input -> parser emits err 1)
    p_emit_chunk(p, std::move(buf), cid, pend_cont, pend_prime, 0);
  }
  std::unique_lock<std::mutex> lk(p->mu);
  if (io_err && !p->err) p->err = 4;
  p->aligner_done = true;
  lk.unlock();
  p->cv_work.notify_all();
  p->cv_ready.notify_all();
}

// --------------------------------------------------------------------------
// stage 3: parse workers
// --------------------------------------------------------------------------

static void parse_worker_main(Pipeline* p) {
  for (;;) {
    ChunkPtr c;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_work.wait(lk, [&] {
        return p->closing || !p->work_q.empty() ||
               (p->aligner_done && p->work_q.empty());
      });
      if (p->closing) return;
      if (p->work_q.empty()) return;  // aligner done + drained
      c = p->work_q.front();
      p->work_q.pop_front();
    }
    int perr = 0;
    Parser* ps = parser_new();
    ps->src.kind = SRC_MEM;
    ps->src.data = (const uint8_t*)c->text.data();
    ps->src.len = c->text.size();
    if (c->cont) {
      // chunk continues a record cut mid-sequence: start in the FASTA
      // sequence state and replay the overlap bytes (uncounted)
      ps->format = 1;
      ps->state = P_FASTA_SEQ;
      ps->at_line_start = false;
      ps->prime = c->prime;
    }
    ps->ends_mid = c->ends_mid;
    // a chunk of B bytes yields at most B k-mers
    uint64_t cap = p->batch_cap < c->text.size() + 1 ? p->batch_cap
                                                     : c->text.size() + 1;
    for (;;) {
      PBatch b;
      uint64_t n = 0;
      int fmt = 0;
      int r;
      if (p->composite) {
        b.lo.reset(new uint32_t[cap]);
        b.hi.reset(new uint32_t[cap]);
        r = fn_next_batch_c(ps, p->k, p->canonical, cap,
                            b.lo.get(), b.hi.get(), &n, &fmt);
      } else {
        b.kmers.reset(new uint64_t[cap]);
        b.rc.reset(new uint8_t[cap]);
        r = fn_next_batch(ps, p->k, p->canonical, cap,
                          b.kmers.get(), b.rc.get(), &n, &fmt);
      }
      if (r < 0) { perr = ps->err; break; }
      b.n = n;
      bool last = (r == 0);
      {
        std::unique_lock<std::mutex> lk(p->mu);
        if (p->closing) { fn_close(ps); return; }
        if (n) c->ready.push_back(std::move(b));
        if (last) break;
      }
      if (n) p->cv_ready.notify_all();
      if (last) break;
    }
    {
      std::unique_lock<std::mutex> lk(p->mu);
      c->bases = ps->total_bases;
      c->kmers = ps->total_kmers;
      c->records = ps->total_records;
      c->fmt = ps->format;
      c->err = perr;
      c->parsed = true;
      c->text.clear();
      c->text.shrink_to_fit();
    }
    p->cv_ready.notify_all();
    ps->src.data = nullptr;
    fn_close(ps);
  }
}

}  // namespace ppipe

// --------------------------------------------------------------------------
// C ABI
// --------------------------------------------------------------------------

using ppipe::Pipeline;

static void p_start_threads(Pipeline* p) {
  if (p->mode == Pipeline::BGZF) {
    p->threads.emplace_back(ppipe::bgzf_reader_main, p);
    int inflators = p->nthreads < 4 ? p->nthreads : p->nthreads / 2 + 1;
    for (int i = 0; i < inflators; i++)
      p->threads.emplace_back(ppipe::bgzf_inflate_main, p);
  }
  p->threads.emplace_back(ppipe::aligner_main, p);
  for (int i = 0; i < p->nthreads; i++)
    p->threads.emplace_back(ppipe::parse_worker_main, p);
}

static Pipeline* p_common_init(uint32_t k, int canonical, uint64_t batch_cap,
                               int threads, int composite, int* err) {
  if (k < 1 || k > 31) { *err = 6; return nullptr; }
  Pipeline* p = new Pipeline();
  p->k = k;
  p->canonical = canonical;
  p->composite = composite;
  p->batch_cap = batch_cap ? batch_cap : (1 << 22);
  p->nthreads = threads > 0 ? threads : 1;
  p->max_live = p->nthreads + 2;
  // memory bound ~= max_live * chunk_target * 10 (text + u64/u8 batches)
  if (const char* e = getenv("FINCH_TPU_CHUNK")) {
    long v = atol(e);
    if (v >= (1 << 12)) p->chunk_target = (uint64_t)v;
  }
  byte_class_init();
  return p;
}

extern "C" void* fn_popen_path(const char* path, uint32_t k, int canonical,
                               uint64_t batch_cap, int threads,
                               int composite, int* err) {
  *err = 0;
  Pipeline* p = p_common_init(k, canonical, batch_cap, threads, composite,
                              err);
  if (!p) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) { *err = 2; delete p; return nullptr; }
  uint8_t head[18];
  size_t got = fread(head, 1, sizeof(head), f);
  if (got >= 2 && head[0] == 0x1f && head[1] == 0x8b) {
    if (ppipe::bgzf_member_size(head, got) > 0 ||
        (got >= 4 && (head[3] & 4))) {
      // FEXTRA present: re-check with a longer header read for BC subfield
      uint8_t hdr2[4096];
      rewind(f);
      size_t g2 = fread(hdr2, 1, sizeof(hdr2), f);
      if (ppipe::bgzf_member_size(hdr2, g2) > 0) {
        rewind(f);
        p->mode = Pipeline::BGZF;
        p->file = f;
        p_start_threads(p);
        return p;
      }
    }
    fclose(f);
    gzFile gf = gzopen(path, "rb");
    if (!gf) { *err = 2; delete p; return nullptr; }
    p->mode = Pipeline::SERIAL_GZ;
    p->gzf = gf;
    p_start_threads(p);
    return p;
  }
  rewind(f);
  p->mode = Pipeline::PLAIN;
  p->file = f;
  p_start_threads(p);
  return p;
}

extern "C" void* fn_popen_bytes(const uint8_t* data, uint64_t len, uint32_t k,
                                int canonical, uint64_t batch_cap,
                                int threads, int composite, int* err) {
  *err = 0;
  Pipeline* p = p_common_init(k, canonical, batch_cap, threads, composite,
                              err);
  if (!p) return nullptr;
  p->mem = data;
  p->mem_len = len;
  if (len >= 2 && data[0] == 0x1f && data[1] == 0x8b) {
    if (ppipe::bgzf_member_size(data, len) > 0) {
      p->mode = Pipeline::BGZF;
    } else {
      p->mode = Pipeline::SERIAL_GZ;
      memset(&p->zs, 0, sizeof(z_stream));
      if (inflateInit2(&p->zs, 15 + 32) != Z_OK) {
        *err = 3;
        delete p;
        return nullptr;
      }
      p->zs_live = true;
    }
  } else {
    p->mode = Pipeline::PLAIN;
  }
  p_start_threads(p);
  return p;
}

// Blocking next-batch: 1 = batch delivered, 0 = EOF, -1 = error.
extern "C" int fn_pnext(void* h, uint64_t* out_kmers, uint8_t* out_rc,
                        uint64_t* n_out, int* format_out) {
  Pipeline* p = (Pipeline*)h;
  std::unique_lock<std::mutex> lk(p->mu);
  *n_out = 0;
  for (;;) {
    if (p->err) { *format_out = p->fmt; return -1; }
    if (!p->order_q.empty()) {
      ppipe::ChunkPtr c = p->order_q.front();
      if (!c->ready.empty()) {
        ppipe::PBatch b = std::move(c->ready.front());
        c->ready.pop_front();
        lk.unlock();
        if (p->composite) {
          memcpy(out_kmers, b.lo.get(), b.n * 4);
          memcpy(out_rc, b.hi.get(), b.n * 4);
        } else {
          memcpy(out_kmers, b.kmers.get(), b.n * 8);
          memcpy(out_rc, b.rc.get(), b.n);
        }
        *n_out = b.n;
        lk.lock();
        if (p->fmt == 0 && c->fmt) p->fmt = c->fmt;
        *format_out = p->fmt;
        return 1;
      }
      if (c->parsed) {
        if (c->err) {
          p->err = c->err;
          *format_out = p->fmt;
          return -1;
        }
        p->total_bases += c->bases;
        p->total_kmers += c->kmers;
        p->total_records += c->records;
        if (p->fmt == 0 && c->fmt) p->fmt = c->fmt;
        p->order_q.pop_front();
        lk.unlock();
        p->cv_space.notify_one();
        lk.lock();
        continue;
      }
      p->cv_ready.wait(lk);
      continue;
    }
    if (p->aligner_done) { *format_out = p->fmt; return 0; }
    p->cv_ready.wait(lk);
  }
}

extern "C" void fn_ptotals(void* h, uint64_t* bases, uint64_t* kmers,
                           uint64_t* records) {
  Pipeline* p = (Pipeline*)h;
  std::unique_lock<std::mutex> lk(p->mu);
  *bases = p->total_bases;
  *kmers = p->total_kmers;
  *records = p->total_records;
}

extern "C" int fn_perror_code(void* h) {
  Pipeline* p = (Pipeline*)h;
  std::unique_lock<std::mutex> lk(p->mu);
  return p->err;
}

extern "C" void fn_pclose(void* h) { delete (Pipeline*)h; }

// ===========================================================================
// Native host fold engine: batch k-mer stream -> bottom-k sketch state.
//
// The host-side analog of the device bottom-k (ops/bottomk.py), built for
// the CPU: an identity-hashed open-addressing table (murmur outputs are
// already uniform, cf. the reference's NoHashHasher, hashing.rs:41-64)
// keyed by hash with (count, extra_count, first-seen packed kmer) payload,
// plus an adaptive admission threshold.
//
// Retention rule (matches models/engine.py's batch semantics, derived from
// mash.rs:34-63 / scaled.rs:37-61):
//   mash   — the `size` smallest distinct hashes
//   scaled — all distinct hashes <= max_hash, topped up to >= `size`
//            entries with the smallest above-threshold hashes
// The admission threshold only ever tightens, and anything ever admitted
// under a stale threshold is a superset of the final sketch, so folding is
// exact in any batch order (the monotone-max theorem, SURVEY §2.3).
// ===========================================================================

#include <algorithm>

namespace fold {

struct Entry {
  uint64_t hash;
  uint64_t count;
  uint64_t extra;
  uint64_t packed;
};

struct FoldState {
  std::vector<Entry> slots;     // open addressing; occupied iff count > 0
  uint64_t mask = 0;            // slots.size() - 1 (power of two)
  uint64_t used = 0;
  uint64_t thr = ~0ULL;         // admit iff hash <= thr
  uint64_t size = 0;            // kmers_to_sketch
  uint64_t max_hash = 0;        // scaled cutoff; scheme==0 ignores
  int scheme = 0;               // 0 mash, 1 scaled
  uint32_t k = 21;
  uint64_t seed = 0;
  // Flat candidate-buffer mode (schemes 0/1; buf_cap > 0 enables it):
  // admitted (hash, 1, rc, packed) tuples append sequentially to `buf`
  // and are bulk-selected at flush time into `kept` (distinct hashes,
  // summed counts, ascending). Appends are ~1 ns vs the open-addressed
  // table's cache-missing probe (~100 ns during warmup, when the
  // threshold is still loose and most of the stream admits — the
  // many-small-files regime). The retention rule applied at flush is
  // identical to fold_compact's, so the monotone-threshold exactness
  // argument above is unchanged: a hash is only ever dropped when it
  // provably exceeds the retention target of a superset of the final
  // candidate set. Counts mode (scheme 2) keeps the table: its key is
  // the packed code, not an orderable hash.
  std::vector<Entry> buf;       // unsorted admitted tuples since last flush
  std::vector<Entry> kept;      // flushed survivors, ascending by hash
  uint64_t buf_cap = 0;         // flush trigger; 0 = table mode
  bool dup_heavy = false;       // last flush saw <50% distinct: skip the
                                // selection pre-pass, radix-sort outright
};

// Slot index: a multiplicative scramble of the (already uniform) hash.
// A pure identity map (slot = h & mask) suffers catastrophic primary
// clustering when keys arrive in ascending-low-bit order — exactly what
// iterating another fold table produces during merges (measured: 12k
// probes/insert). The odd-constant multiply is a bijection that breaks
// ordered runs for ~1 cycle.
static inline uint64_t fold_slot(uint64_t h, uint64_t mask) {
  return (h * 0x9E3779B97F4A7C15ULL) & mask;
}

static void fold_rehash(FoldState* s, uint64_t new_cap) {
  std::vector<Entry> old;
  old.swap(s->slots);
  s->slots.assign(new_cap, Entry{0, 0, 0, 0});
  s->mask = new_cap - 1;
  s->used = 0;
  for (const Entry& e : old) {
    if (!e.count || e.hash > s->thr) continue;
    uint64_t i = fold_slot(e.hash, s->mask);
    while (s->slots[i].count) i = (i + 1) & s->mask;
    s->slots[i] = e;
    s->used++;
  }
}

// Tighten the threshold to the retention rule's keep-target and drop
// everything above it; grow the table if the survivors still crowd it.
static void fold_compact(FoldState* s) {
  if (s->scheme == 2) {
    // counts mode retains every distinct key: only grow, never tighten
    fold_rehash(s, (s->mask + 1) * 2);
    return;
  }
  std::vector<uint64_t> hashes;
  hashes.reserve(s->used);
  for (const Entry& e : s->slots)
    if (e.count) hashes.push_back(e.hash);
  uint64_t below = 0;
  if (s->scheme == 1) {
    for (uint64_t h : hashes) below += (h <= s->max_hash);
  }
  uint64_t target = below + s->size;
  if (hashes.size() > target && target > 0) {
    std::nth_element(hashes.begin(), hashes.begin() + (target - 1),
                     hashes.end());
    s->thr = hashes[target - 1];
    // the scaled scheme may never reject a below-cutoff hash
    if (s->scheme == 1 && s->thr < s->max_hash) s->thr = s->max_hash;
  }
  uint64_t survivors = target < hashes.size() ? target : hashes.size();
  uint64_t cap = s->mask + 1;
  while (cap > 64 && survivors * 4 < cap) cap /= 2;
  while (survivors * 2 >= cap) cap *= 2;
  fold_rehash(s, cap);
}

// Bulk-select the buffered candidates: sort, accumulate equal-hash runs,
// merge into `kept`, tighten the threshold to the retention target, drop
// everything above it. Always leaves `kept` ascending-distinct and
// `used` == kept.size(); cheap no-op when the buffer is empty.
// Stable LSD radix sort by hash (4 x 16-bit passes). Stability keeps the
// first-appended occurrence of a hash first, so the packed-kmer tie rule
// on (astronomically rare) hash collisions matches the streaming heap's
// first-encountered semantics. ~6x std::sort on 32-byte structs.
static void radix_sort_entries(std::vector<Entry>& v, std::vector<Entry>& tmp,
                               std::vector<uint32_t>& cnt) {
  const size_t n = v.size();
  if (n < 32768) {
    std::stable_sort(v.begin(), v.end(),
                     [](const Entry& a, const Entry& b) {
                       return a.hash < b.hash;
                     });
    return;
  }
  tmp.resize(n);
  cnt.resize(1 << 16);
  Entry* a = v.data();
  Entry* b = tmp.data();
  for (int pass = 0; pass < 4; pass++) {
    const int sh = 16 * pass;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (size_t i = 0; i < n; i++) cnt[(a[i].hash >> sh) & 0xFFFF]++;
    uint32_t sum = 0;
    for (size_t d = 0; d < (size_t)(1 << 16); d++) {
      uint32_t c = cnt[d];
      cnt[d] = sum;
      sum += c;
    }
    for (size_t i = 0; i < n; i++) b[cnt[(a[i].hash >> sh) & 0xFFFF]++] = a[i];
    std::swap(a, b);
  }
  // 4 passes (even count): result landed back in v's storage
}

// Accumulate equal-hash runs of a sorted range into `out` (appending;
// merges into out.back() when the first run continues its last hash).
static void accumulate_runs(const Entry* b, const Entry* e,
                            std::vector<Entry>& out) {
  for (const Entry* it = b; it != e;) {
    Entry acc = *it++;
    while (it != e && it->hash == acc.hash) {
      acc.count += it->count;
      acc.extra += it->extra;
      ++it;
    }
    if (!out.empty() && out.back().hash == acc.hash) {
      out.back().count += acc.count;
      out.back().extra += acc.extra;
    } else {
      out.push_back(acc);
    }
  }
}

// Reduce `buf` to distinct-accumulated ascending entries containing at
// least the retention target: selection (nth_element) first, so only the
// ~target smallest entries are ever fully sorted. Exactness: an entry is
// dropped only when `want` distinct values strictly smaller than it have
// already been kept — i.e. it exceeds the retention target of buf alone,
// hence of the merged (kept + buf) set too, since merging only adds
// values. Duplicates of the partition pivot are swept into the kept side
// before counting so every retained hash keeps exact counts.
static void fold_select_buf(FoldState* s, std::vector<Entry>& scratch,
                            std::vector<uint32_t>& cnt) {
  std::vector<Entry>& buf = s->buf;
  std::vector<Entry> out;
  auto hlt = [](const Entry& a, const Entry& b) { return a.hash < b.hash; };
  size_t lo = 0, hi = buf.size();
  const size_t n_in = buf.size();
  if (s->dup_heavy) {
    // duplicate-dominated stream: runs collapse the buffer better than
    // selection can shrink it — sort everything and accumulate
    radix_sort_entries(buf, scratch, cnt);
    accumulate_runs(buf.data(), buf.data() + buf.size(), out);
    s->dup_heavy = out.size() * 2 < n_in;
    buf.swap(out);
    return;
  }
  if (s->scheme == 1 && s->max_hash) {
    // scaled: everything <= max_hash is mandatory — sort & keep it all
    auto mid = std::partition(buf.begin(), buf.end(), [&](const Entry& e) {
      return e.hash <= s->max_hash;
    });
    lo = (size_t)(mid - buf.begin());
    if (lo) {
      std::vector<Entry> mand(buf.begin(), mid);
      radix_sort_entries(mand, scratch, cnt);
      out.reserve(mand.size() + s->size);
      accumulate_runs(mand.data(), mand.data() + mand.size(), out);
    }
  }
  uint64_t want = s->size;
  while (lo < hi && want > 0) {
    if (hi - lo <= want + (want >> 2) + 4096) {
      // close enough to the target: sort the remainder outright
      std::vector<Entry> rest(buf.begin() + lo, buf.begin() + hi);
      radix_sort_entries(rest, scratch, cnt);
      accumulate_runs(rest.data(), rest.data() + rest.size(), out);
      lo = hi;
      break;
    }
    std::nth_element(buf.begin() + lo, buf.begin() + lo + want - 1,
                     buf.begin() + hi, hlt);
    const uint64_t v = buf[lo + want - 1].hash;
    // sweep duplicates of the pivot value out of the right side so the
    // kept run for v carries its full count
    auto vmid = std::partition(buf.begin() + lo + want, buf.begin() + hi,
                               [&](const Entry& e) { return e.hash == v; });
    const size_t lend = (size_t)(vmid - buf.begin());
    std::vector<Entry> left(buf.begin() + lo, buf.begin() + lend);
    radix_sort_entries(left, scratch, cnt);
    const size_t before = out.size();
    accumulate_runs(left.data(), left.data() + left.size(), out);
    const uint64_t d = out.size() - before;  // distinct gained (<= want)
    want -= d < want ? d : want;
    lo = lend;
  }
  // <50% distinct among the consumed prefix: flag the next flush to skip
  // selection (duplicate-dominated streams collapse better under sort-all)
  s->dup_heavy = lo > 0 && out.size() * 2 < lo;
  buf.swap(out);
}

static void fold_flush(FoldState* s) {
  if (!s->buf.empty()) {
    std::vector<Entry> scratch;
    std::vector<uint32_t> cnt;
    fold_select_buf(s, scratch, cnt);
    std::vector<Entry> merged;
    merged.reserve(s->kept.size() + s->buf.size());
    size_t i = 0, j = 0;
    const size_t nk = s->kept.size(), nb = s->buf.size();
    while (i < nk || j < nb) {
      Entry e;
      if (i < nk && (j >= nb || s->kept[i].hash <= s->buf[j].hash)) {
        e = s->kept[i++];
      } else {
        e = s->buf[j++];
      }
      while (j < nb && s->buf[j].hash == e.hash) {
        e.count += s->buf[j].count;
        e.extra += s->buf[j].extra;
        j++;
      }
      merged.push_back(e);
    }
    s->kept.swap(merged);
    s->buf.clear();
  }
  uint64_t target = s->size;
  if (s->scheme == 1) {
    // kept is sorted: count the scaled-mandatory entries (<= max_hash)
    size_t lo = 0, hi = s->kept.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (s->kept[mid].hash <= s->max_hash) lo = mid + 1; else hi = mid;
    }
    target = lo + s->size;
  }
  if (target && s->kept.size() > target) {
    uint64_t t = s->kept[target - 1].hash;
    if (s->scheme == 1 && t < s->max_hash) t = s->max_hash;
    if (t < s->thr) s->thr = t;
  }
  // an externally-tightened threshold (another worker's flush) also
  // prunes here; anything above thr can never re-enter
  while (!s->kept.empty() && s->kept.back().hash > s->thr)
    s->kept.pop_back();
  s->used = s->kept.size();
}

static inline void fold_insert(FoldState* s, uint64_t h, uint64_t rc,
                               uint64_t packed) {
  uint64_t i = fold_slot(h, s->mask);
  for (;;) {
    Entry& e = s->slots[i];
    if (!e.count) {
      e.hash = h;
      e.count = 1;
      e.extra = rc;
      e.packed = packed;
      s->used++;
      if (s->used * 10 >= (s->mask + 1) * 7) {
        fold_compact(s);  // 70% load: tighten the threshold + resize
      }
      return;
    }
    if (e.hash == h) {
      e.count++;
      e.extra += rc;
      return;
    }
    i = (i + 1) & s->mask;
  }
}

// Fast packed->murmur path: decode 8 bases per 512KB-table lookup instead
// of 21 scalar byte writes. T16[i] holds the 8 ASCII bytes of the 8 2-bit
// codes in i (first base = most-significant pair of i = least-significant
// byte of the word, i.e. ready for little-endian murmur block loads).
static uint64_t DECODE16[65536];
static bool decode16_done = false;
static void decode16_init() {
  if (decode16_done) return;
  for (uint32_t i = 0; i < 65536; i++) {
    uint64_t w = 0;
    for (int b = 0; b < 8; b++) {
      uint32_t code = (i >> (14 - 2 * b)) & 3;
      w |= uint64_t(BASE_ASCII[code]) << (8 * b);
    }
    DECODE16[i] = w;
  }
  decode16_done = true;
}

// MurmurHash3_x64_128 low word of a 2-bit packed k-mer, k in 1..=31,
// bit-identical to decode-then-hash (tests pin it against the oracle).
static inline uint64_t murmur_packed_fast(uint64_t p, uint32_t k,
                                          uint64_t seed) {
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = seed, h2 = seed;
  const uint32_t bits = 2 * k;
  uint64_t w0 = 0, w1 = 0, w2 = 0;
  // group g covers bases 8g..8g+7; index = those 16 bits, left-aligned
  // (shift the packed code so the group's first base sits at bit 15:14)
  if (k > 0) {
    int sh = (int)bits - 16;
    w0 = DECODE16[(sh >= 0 ? (p >> sh) : (p << -sh)) & 0xFFFF];
  }
  if (k > 8) {
    int sh = (int)bits - 32;
    w1 = DECODE16[(sh >= 0 ? (p >> sh) : (p << -sh)) & 0xFFFF];
  }
  uint64_t w3 = 0;
  if (k > 16) {
    int sh = (int)bits - 48;
    w2 = DECODE16[(sh >= 0 ? (p >> sh) : (p << -sh)) & 0xFFFF];
  }
  if (k > 24) {
    int sh = (int)bits - 64;  // always negative for k <= 31
    w3 = DECODE16[(p << -sh) & 0xFFFF];
  }
  if (k >= 16) {
    uint64_t k1 = w0, k2 = w1;
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ULL;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ULL;
    uint32_t t = k - 16;  // tail <= 15 bytes in (w2, w3)
    if (t) {
      if (t > 8) {
        uint64_t k2t = w3 & ((1ULL << (8 * (t - 8))) - 1);
        k2t *= c2; k2t = rotl64(k2t, 33); k2t *= c1; h2 ^= k2t;
      }
      uint64_t k1t = t >= 8 ? w2 : (w2 & ((1ULL << (8 * t)) - 1));
      k1t *= c1; k1t = rotl64(k1t, 31); k1t *= c2; h1 ^= k1t;
    }
  } else {
    // k < 16: tail-only, bytes split (w0 low 8, w1 next)
    uint32_t t = k;
    uint64_t k1 = t >= 8 ? w0 : (w0 & ((1ULL << (8 * t)) - 1));
    if (t > 8) {
      uint64_t k2 = w1 & ((t - 8) >= 8 ? ~0ULL
                                       : ((1ULL << (8 * (t - 8))) - 1));
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    }
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (uint64_t)k; h2 ^= (uint64_t)k;
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2;
  return h1;
}

}  // namespace fold

// scheme: 0 = mash (bottom-k), 1 = scaled, 2 = counts (key = packed code)
extern "C" void* fn_fold_new(int scheme, uint32_t k, uint64_t seed,
                             uint64_t size, uint64_t max_hash) {
  fold::FoldState* s = new fold::FoldState();
  s->scheme = scheme;
  s->k = k;
  s->seed = seed;
  s->size = size;
  s->max_hash = max_hash;
  // pure scaled (size 0): only hashes <= max_hash are ever retained, so
  // admit exactly those from the start (engine.py _threshold parity);
  // size-0 mash admits nothing (handled in fn_fold_batch)
  if (scheme == 1 && size == 0) s->thr = max_hash;
  uint64_t cap = 1024;
  const char* nobuf = getenv("FINCH_TPU_FOLD_BUF");
  if (scheme != 2 && !(nobuf && nobuf[0] == '0')) {
    // flat candidate-buffer mode: flush cadence 2x the retention target
    // (so one flush usually suffices for small streams), bounded at 1M
    // tuples (32 MB) per state. FINCH_TPU_FOLD_BUF=0 restores the
    // open-addressed table path (ablation / kill switch).
    uint64_t bc = 2 * size + 1024;
    if (bc > (1ULL << 20)) bc = 1ULL << 20;
    s->buf_cap = bc;
  } else {
    while (cap < size / 4) cap *= 2;
  }
  s->slots.assign(cap, fold::Entry{0, 0, 0, 0});
  s->mask = cap - 1;
  return s;
}

extern "C" void fn_fold_batch(void* h, const uint64_t* packed,
                              const uint8_t* rc, uint64_t n) {
  fold::FoldState* s = (fold::FoldState*)h;
  if (s->scheme == 0 && s->size == 0) return;  // admit nothing
  fold::decode16_init();
  const uint32_t k = s->k;
  const uint64_t seed = s->seed;
  if (s->scheme == 2) {
    // counts mode (AllCounts / sketch-type none, counts.rs:25-33): the
    // key IS the packed forward-strand code — exact per-k-mer counts
    // with no hash involved, any k <= 31
    for (uint64_t i = 0; i < n; i++)
      fold::fold_insert(s, packed[i], 0, packed[i]);
    return;
  }
  if (s->buf_cap) {
    // flat-buffer mode: hash, threshold-filter, append; bulk-select on
    // flush. No random memory access in the loop.
    for (uint64_t i = 0; i < n; i++) {
      uint64_t h1 = fold::murmur_packed_fast(packed[i], k, seed);
      if (h1 <= s->thr)
        s->buf.push_back(fold::Entry{h1, 1, rc[i], packed[i]});
    }
    if (s->buf.size() >= s->buf_cap) fold::fold_flush(s);
    return;
  }
  // block-wise: hash a block, software-prefetch the admitted slots, then
  // insert — overlaps the table's random-access latency across the block
  const uint64_t B = 32;
  uint64_t hs[B];
  for (uint64_t base = 0; base < n; base += B) {
    uint64_t m = n - base < B ? n - base : B;
    const uint64_t thr = s->thr;
    for (uint64_t j = 0; j < m; j++) {
      hs[j] = fold::murmur_packed_fast(packed[base + j], k, seed);
      if (hs[j] <= thr)
        __builtin_prefetch(&s->slots[fold::fold_slot(hs[j], s->mask)], 1, 1);
    }
    for (uint64_t j = 0; j < m; j++) {
      if (hs[j] <= s->thr)
        fold::fold_insert(s, hs[j], rc[base + j], packed[base + j]);
    }
  }
}

// Number of live entries (call before fn_fold_result to size buffers).
extern "C" uint64_t fn_fold_used(void* h) {
  fold::FoldState* s = (fold::FoldState*)h;
  if (s->buf_cap) fold::fold_flush(s);
  return s->used;
}

// Emit entries sorted ascending by hash. Returns count written (<= cap).
extern "C" uint64_t fn_fold_result(void* h, uint64_t cap, uint64_t* out_h,
                                   uint64_t* out_c, uint64_t* out_e,
                                   uint64_t* out_pk) {
  fold::FoldState* s = (fold::FoldState*)h;
  if (s->buf_cap) {
    fold::fold_flush(s);
    uint64_t n = s->kept.size() < cap ? s->kept.size() : cap;
    for (uint64_t i = 0; i < n; i++) {
      out_h[i] = s->kept[i].hash;
      out_c[i] = s->kept[i].count;
      out_e[i] = s->kept[i].extra;
      out_pk[i] = s->kept[i].packed;
    }
    return n;
  }
  std::vector<fold::Entry> live;
  live.reserve(s->used);
  for (const fold::Entry& e : s->slots)
    if (e.count) live.push_back(e);
  std::sort(live.begin(), live.end(),
            [](const fold::Entry& a, const fold::Entry& b) {
              return a.hash < b.hash;
            });
  uint64_t n = live.size() < cap ? live.size() : cap;
  for (uint64_t i = 0; i < n; i++) {
    out_h[i] = live[i].hash;
    out_c[i] = live[i].count;
    out_e[i] = live[i].extra;
    out_pk[i] = live[i].packed;
  }
  return n;
}

extern "C" void fn_fold_free(void* h) { delete (fold::FoldState*)h; }

// ===========================================================================
// Fused parse+fold pipeline ("sketch mode").
//
// The parallel parse pipeline above feeds Python batches; in sketch mode
// the parse workers fold their chunks directly into worker-local fold
// tables instead, so one file's parse AND fold scale across cores with no
// per-batch Python hop. A shared atomic admission threshold (the min of
// every worker's local threshold — each local threshold is the (below +
// size)-th smallest of a SUBSET of the stream, hence always >= the true
// global threshold, hence superset-safe) keeps the tables small; the
// final merge dedups and sums counts, and the usual retention rule
// truncates. Exact by the monotone-max theorem for any chunk split.
// ===========================================================================

namespace spipe {

struct SketchPipeline {
  ppipe::Pipeline pipe;  // reused machinery: reader/aligner/queues
  int scheme = 0;
  uint64_t seed = 0;
  uint64_t size = 0;
  uint64_t max_hash = 0;
  std::atomic<uint64_t> shared_thr{~0ULL};
  std::mutex result_mu;
  std::vector<fold::FoldState*> worker_states;
  fold::FoldState* merged = nullptr;
  std::atomic<int> workers_done{0};
  int n_workers = 0;
  std::atomic<int> err{0};
  std::atomic<int> fmt{0};
  // totals accumulated from chunk parsers
  std::atomic<uint64_t> t_bases{0}, t_kmers{0}, t_records{0};
  std::condition_variable cv_done;
  std::mutex done_mu;
  bool finished = false;
  std::atomic<uint64_t> ns_parse{0}, ns_fold{0}, ns_merge{0};

  ~SketchPipeline() {
    // shut the pipeline's threads down BEFORE freeing the fold states
    // they write to (the member dtor would run after this body)
    {
      std::unique_lock<std::mutex> lk(pipe.mu);
      pipe.closing = true;
    }
    pipe.cv_work.notify_all();
    pipe.cv_space.notify_all();
    pipe.cv_gz_work.notify_all();
    pipe.cv_gz_ready.notify_all();
    pipe.cv_gz_space.notify_all();
    for (auto& th : pipe.threads) th.join();
    pipe.threads.clear();
    for (auto* s : worker_states) delete s;
    delete merged;
  }
};

static void sketch_worker_main(SketchPipeline* sp, fold::FoldState* st) {
  ppipe::Pipeline* p = &sp->pipe;
  const uint64_t B = 1 << 16;
  std::unique_ptr<uint64_t[]> kb(new uint64_t[B]);
  std::unique_ptr<uint8_t[]> rb(new uint8_t[B]);
  for (;;) {
    ppipe::ChunkPtr c;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_work.wait(lk, [&] {
        return p->closing || !p->work_q.empty() ||
               (p->aligner_done && p->work_q.empty());
      });
      if (p->closing) break;
      if (p->work_q.empty()) break;  // aligner done + drained
      c = p->work_q.front();
      p->work_q.pop_front();
      p->order_q.pop_front();  // no consumer: release live-chunk budget
    }
    p->cv_space.notify_one();
    Parser* ps = parser_new();
    ps->src.kind = SRC_MEM;
    ps->src.data = (const uint8_t*)c->text.data();
    ps->src.len = c->text.size();
    if (c->cont) {
      // chunk continues a record cut mid-sequence: start in the FASTA
      // sequence state and replay the overlap bytes (uncounted)
      ps->format = 1;
      ps->state = P_FASTA_SEQ;
      ps->at_line_start = false;
      ps->prime = c->prime;
    }
    ps->ends_mid = c->ends_mid;
    int perr = 0;
    for (;;) {
      uint64_t n = 0;
      int fmt = 0;
      auto t0 = std::chrono::steady_clock::now();
      int r = fn_next_batch(ps, sp->pipe.k, sp->pipe.canonical, B,
                            kb.get(), rb.get(), &n, &fmt);
      auto t1 = std::chrono::steady_clock::now();
      sp->ns_parse += std::chrono::duration_cast<std::chrono::nanoseconds>(
          t1 - t0).count();
      if (r < 0) { perr = ps->err; break; }
      if (n) {
        // refresh the shared admission bound, fold, publish tightenings
        uint64_t g = sp->shared_thr.load(std::memory_order_relaxed);
        if (g < st->thr) st->thr = g;
        fn_fold_batch(st, kb.get(), rb.get(), n);
        auto t2 = std::chrono::steady_clock::now();
        sp->ns_fold += std::chrono::duration_cast<
            std::chrono::nanoseconds>(t2 - t1).count();
        uint64_t mine = st->thr;
        uint64_t cur = sp->shared_thr.load(std::memory_order_relaxed);
        while (mine < cur && !sp->shared_thr.compare_exchange_weak(
                   cur, mine, std::memory_order_relaxed)) {
        }
      }
      if (r == 0) break;
    }
    sp->t_bases += ps->total_bases;
    sp->t_kmers += ps->total_kmers;
    sp->t_records += ps->total_records;
    if (ps->format) sp->fmt.store(ps->format, std::memory_order_relaxed);
    if (perr) sp->err.store(perr, std::memory_order_relaxed);
    ps->src.data = nullptr;
    fn_close(ps);
  }
  if (sp->workers_done.fetch_add(1) + 1 == sp->n_workers) {
    // last worker out merges everything
    auto tm0 = std::chrono::steady_clock::now();
    fold::FoldState* m =
        (fold::FoldState*)fn_fold_new(sp->scheme, sp->pipe.k, sp->seed,
                                      sp->size, sp->max_hash);
    uint64_t n_ins = 0, n_cmp = 0, n_probe = 0;
    if (m->buf_cap) {
      // buffer-mode workers (schemes 0/1): their kept vectors are
      // sorted-distinct; one worker hands its vector over outright,
      // several concatenate into m's buffer and bulk-flush (the flush's
      // run-accumulate sums counts across workers on hash ties)
      for (auto* ws : sp->worker_states) {
        if (!ws->buf_cap) continue;
        fold::fold_flush(ws);
        if (m->kept.empty() && m->buf.empty()) {
          m->kept.swap(ws->kept);
        } else {
          m->buf.insert(m->buf.end(), ws->kept.begin(), ws->kept.end());
          ws->kept.clear();
          ws->kept.shrink_to_fit();
        }
        ws->slots.clear();
        ws->slots.shrink_to_fit();
      }
      fold::fold_flush(m);
      n_ins = m->used;
    } else {
      uint64_t total_live = 0;
      for (auto* ws : sp->worker_states) total_live += ws->used;
      uint64_t pre = m->mask + 1;
      while (pre < total_live * 2) pre *= 2;
      fold::fold_rehash(m, pre);  // pre-size: no growth rehashes mid-merge
      for (auto* ws : sp->worker_states) {
        for (const fold::Entry& e : ws->slots) {
          if (!e.count || e.hash > m->thr) continue;
          // insert summing counts (hash already computed)
          n_ins++;
          uint64_t i = fold::fold_slot(e.hash, m->mask);
          for (;;) {
            n_probe++;
            fold::Entry& d = m->slots[i];
            if (!d.count) {
              d = e;
              m->used++;
              if (m->used * 10 >= (m->mask + 1) * 7) {
                fold::fold_compact(m);
                n_cmp++;
              }
              break;
            }
            if (d.hash == e.hash) {
              d.count += e.count;
              d.extra += e.extra;
              break;
            }
            i = (i + 1) & m->mask;
          }
        }
        ws->slots.clear();
        ws->slots.shrink_to_fit();
      }
    }
    if (getenv("FINCH_TPU_DEBUG_TIMING"))
      fprintf(stderr, "[merge] inserts %lu probes %lu compacts %lu\n",
              (unsigned long)n_ins, (unsigned long)n_probe,
              (unsigned long)n_cmp);
    sp->ns_merge += std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now() - tm0).count();
    if (getenv("FINCH_TPU_DEBUG_TIMING")) {
      fprintf(stderr, "[fused] parse %.2fs fold %.2fs merge %.2fs\n",
              sp->ns_parse.load() / 1e9, sp->ns_fold.load() / 1e9,
              sp->ns_merge.load() / 1e9);
    }
    {
      std::unique_lock<std::mutex> lk(sp->done_mu);
      sp->merged = m;
      sp->finished = true;
    }
    sp->cv_done.notify_all();
  }
}

}  // namespace spipe

extern "C" void* fn_sopen_path(const char* path, uint32_t k, int canonical,
                               int threads, int scheme, uint64_t seed,
                               uint64_t size, uint64_t max_hash, int* err) {
  // open the parse side with a throwaway pipeline open, then swap in
  // sketch workers instead of parse workers
  spipe::SketchPipeline* sp = new spipe::SketchPipeline();
  sp->scheme = scheme;
  sp->seed = seed;
  sp->size = size;
  sp->max_hash = max_hash;
  if (scheme == 1 && size == 0) sp->shared_thr = max_hash;
  ppipe::Pipeline* p = &sp->pipe;
  *err = 0;
  if (k < 1 || k > 31) { *err = 6; delete sp; return nullptr; }
  p->k = k;
  p->canonical = canonical;
  p->nthreads = threads > 0 ? threads : 1;
  p->max_live = p->nthreads + 2;
  if (const char* e = getenv("FINCH_TPU_CHUNK")) {
    long v = atol(e);
    if (v >= (1 << 12)) p->chunk_target = (uint64_t)v;
  }
  byte_class_init();
  fold::decode16_init();
  FILE* f = fopen(path, "rb");
  if (!f) { *err = 2; delete sp; return nullptr; }
  uint8_t head[4096];
  size_t got = fread(head, 1, sizeof(head), f);
  rewind(f);
  if (got >= 2 && head[0] == 0x1f && head[1] == 0x8b) {
    if (ppipe::bgzf_member_size(head, got) > 0) {
      p->mode = ppipe::Pipeline::BGZF;
      p->file = f;
    } else {
      fclose(f);
      gzFile gf = gzopen(path, "rb");
      if (!gf) { *err = 2; delete sp; return nullptr; }
      p->mode = ppipe::Pipeline::SERIAL_GZ;
      p->gzf = gf;
    }
  } else {
    p->mode = ppipe::Pipeline::PLAIN;
    p->file = f;
  }
  sp->n_workers = p->nthreads;
  for (int i = 0; i < p->nthreads; i++) {
    sp->worker_states.push_back(
        (fold::FoldState*)fn_fold_new(scheme, k, seed, size, max_hash));
  }
  if (p->mode == ppipe::Pipeline::BGZF) {
    p->threads.emplace_back(ppipe::bgzf_reader_main, p);
    int inflators = p->nthreads < 4 ? p->nthreads : p->nthreads / 2 + 1;
    for (int i = 0; i < inflators; i++)
      p->threads.emplace_back(ppipe::bgzf_inflate_main, p);
  }
  p->threads.emplace_back(ppipe::aligner_main, p);
  for (int i = 0; i < p->nthreads; i++)
    p->threads.emplace_back(spipe::sketch_worker_main, sp,
                            sp->worker_states[i]);
  return sp;
}

// Blocks until the stream is fully folded. Returns 0 ok / -1 error (code
// via fn_serror). Outputs: result entry count + totals + format.
extern "C" int fn_swait(void* h, uint64_t* n_out, uint64_t* bases,
                        uint64_t* kmers, uint64_t* records, int* fmt) {
  spipe::SketchPipeline* sp = (spipe::SketchPipeline*)h;
  std::unique_lock<std::mutex> lk(sp->done_mu);
  sp->cv_done.wait(lk, [&] { return sp->finished; });
  *bases = sp->t_bases.load();
  *kmers = sp->t_kmers.load();
  *records = sp->t_records.load();
  *fmt = sp->fmt.load();
  int err = sp->err.load();
  if (!err && sp->pipe.err) err = sp->pipe.err;
  if (!err && *records == 0 && sp->fmt.load() == 0) err = 1;  // empty
  if (err) { sp->err.store(err); return -1; }
  *n_out = sp->merged->used;
  return 0;
}

extern "C" uint64_t fn_sresult(void* h, uint64_t cap, uint64_t* out_h,
                               uint64_t* out_c, uint64_t* out_e,
                               uint64_t* out_pk) {
  spipe::SketchPipeline* sp = (spipe::SketchPipeline*)h;
  return fn_fold_result(sp->merged, cap, out_h, out_c, out_e, out_pk);
}

extern "C" int fn_serror(void* h) {
  return ((spipe::SketchPipeline*)h)->err.load();
}

extern "C" void fn_sclose(void* h) { delete (spipe::SketchPipeline*)h; }

// ---------------------------------------------------------------------------
// .sk JSON bulk-segment parsers (serialization/json_sk.py fast path).
//
// The reference reads .sk documents through serde_json's compiled
// tokenizer (lib/src/serialization/json.rs:91-139); our Python reader cuts
// the three bulk arrays ("hashes"/"kmers"/"counts") out of the document and
// these functions validate + parse one extracted segment (the bytes between
// '[' and ']') in a single pass, replacing a bytes.split + numpy decimal
// parse that allocated one Python object per element at DB scale.
//
// Return conventions: element count on success; -1 = shape not the compact
// serde_json form (caller falls back to json.loads — NOT an error);
// -2 = well-formed but value out of range (caller raises the schema error).
// ---------------------------------------------------------------------------

// quoted u64 decimals: "123","456" -> out[]. cap = capacity of out.
extern "C" int64_t fn_sk_qu64(const uint8_t* s, uint64_t len, uint64_t* out,
                              uint64_t cap) {
  if (len == 0) return 0;
  uint64_t i = 0, n = 0;
  while (true) {
    if (i >= len || s[i] != '"') return -1;
    i++;
    if (i >= len || s[i] < '0' || s[i] > '9') return -1;
    uint64_t v = 0;
    while (i < len && s[i] >= '0' && s[i] <= '9') {
      uint64_t d = (uint64_t)(s[i] - '0');
      if (v > (UINT64_MAX - d) / 10) return -2;  // > u64::MAX
      v = v * 10 + d;
      i++;
    }
    if (i >= len || s[i] != '"') return -1;
    i++;
    if (n >= cap) return -1;
    out[n++] = v;
    if (i == len) return (int64_t)n;
    if (s[i] != ',') return -1;
    i++;
  }
}

// bare u32 decimals: 1,2,3 -> out[]. Values above u32::MAX return -2 (the
// reference's serde u32 deserialization errors on overflow, json.rs:122).
extern "C" int64_t fn_sk_u32(const uint8_t* s, uint64_t len, uint32_t* out,
                             uint64_t cap) {
  if (len == 0) return 0;
  uint64_t i = 0, n = 0;
  while (true) {
    if (i >= len || s[i] < '0' || s[i] > '9') return -1;
    uint64_t v = 0;
    while (i < len && s[i] >= '0' && s[i] <= '9') {
      v = v * 10 + (uint64_t)(s[i] - '0');
      if (v > 0xFFFFFFFFULL) return -2;  // > u32::MAX
      i++;
    }
    if (n >= cap) return -1;
    out[n++] = (uint32_t)v;
    if (i == len) return (int64_t)n;
    if (s[i] != ',') return -1;
    i++;
  }
}

// kmer string segment: "ACG","TGA",... — validates the exact shape the
// Python fast path accepted (outer quotes, no escapes, printable ASCII,
// every '"' at an element boundary). Writes the common element length to
// *fixed_len when all elements share one (so the caller can build a
// fixed-width numpy view with zero per-element objects), else -1 there.
extern "C" int64_t fn_sk_kseg(const uint8_t* s, uint64_t len,
                              int64_t* fixed_len) {
  *fixed_len = -1;
  if (len == 0) return 0;
  uint64_t i = 0, n = 0;
  int64_t common = -2;  // -2 = unset, -1 = mixed
  while (true) {
    if (i >= len || s[i] != '"') return -1;
    i++;
    uint64_t start = i;
    while (i < len && s[i] != '"') {
      uint8_t c = s[i];
      if (c < 0x20 || c > 0x7E || c == '\\') return -1;
      i++;
    }
    if (i >= len) return -1;  // unterminated
    int64_t l = (int64_t)(i - start);
    if (common == -2) common = l;
    else if (common != l) common = -1;
    i++;  // closing quote
    n++;
    if (i == len) break;
    if (i + 1 >= len || s[i] != ',' || s[i + 1] != '"') return -1;
    i++;
  }
  *fixed_len = common;
  return (int64_t)n;
}

// Formatters (writer side): emit the bulk arrays' JSON text in one pass.
// Returns bytes written. Caller sizes out for the worst case.

// u64 -> '"<dec>","<dec>"' (quoted, comma-joined). Worst case 23 B/elem.
extern "C" uint64_t fn_sk_fmt_qu64(const uint64_t* v, uint64_t n,
                                   uint8_t* out) {
  uint8_t* o = out;
  char tmp[20];
  for (uint64_t i = 0; i < n; i++) {
    if (i) *o++ = ',';
    *o++ = '"';
    uint64_t x = v[i];
    int len = 0;
    do { tmp[len++] = (char)('0' + (x % 10)); x /= 10; } while (x);
    while (len) *o++ = (uint8_t)tmp[--len];
    *o++ = '"';
  }
  return (uint64_t)(o - out);
}

// u32 -> '<dec>,<dec>' (bare, comma-joined). Worst case 11 B/elem.
extern "C" uint64_t fn_sk_fmt_u32(const uint32_t* v, uint64_t n,
                                  uint8_t* out) {
  uint8_t* o = out;
  char tmp[10];
  for (uint64_t i = 0; i < n; i++) {
    if (i) *o++ = ',';
    uint32_t x = v[i];
    int len = 0;
    do { tmp[len++] = (char)('0' + (x % 10)); x /= 10; } while (x);
    while (len) *o++ = (uint8_t)tmp[--len];
  }
  return (uint64_t)(o - out);
}
