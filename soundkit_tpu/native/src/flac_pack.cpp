// flac_pack.cpp — native FLAC frame bit-packer (the entropy stage of
// the encode direction).
//
// Byte-identical replacement for the Python writer in
// codecs/flac_encode.py (write_frame / _write_residual / _rice_bits /
// _best_rice_k / _crc8 / _crc16 / _utf8_frame_number).  The batched
// encode models run all block ANALYSIS on device
// (ops/flac_enc_batch.py); this packs the resulting plans into frames
// at native speed — the Python bit-writer was ~80% of batched encode
// wall time (Rice parameter search + CRC in pure Python).
//
// Reference parity: soundkit-flac/src/frame_codec.rs:42-278 (pure
// frame encoder); the Rice partition-order search mirrors the
// canonical FLAC method (first partition short by the predictor
// order, 4-bit params, 5-bit "Rice2" escape when any k > 14).
//
// Two entry points:
//   skt_flac_pack_frames  — MANY frames from device-analysis plans
//                           (assignment + kind/order/shift/qlp/res per
//                           slot, sources rebuilt from the PCM block)
//   skt_flac_pack_frame1  — ONE frame from fully explicit subframe
//                           plans (the generic write_frame path,
//                           incl. verbatim subframes)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ----------------------------------------------------------------- CRC

struct Crc8Table {
  uint8_t t[256];
  Crc8Table() {
    for (int i = 0; i < 256; i++) {
      int c = i;
      for (int b = 0; b < 8; b++)
        c = (c & 0x80) ? ((c << 1) ^ 0x07) & 0xFF : (c << 1) & 0xFF;
      t[i] = (uint8_t)c;
    }
  }
};

struct Crc16Table {
  uint16_t t[256];
  Crc16Table() {
    for (int i = 0; i < 256; i++) {
      int c = i << 8;
      for (int b = 0; b < 8; b++)
        c = (c & 0x8000) ? ((c << 1) ^ 0x8005) & 0xFFFF : (c << 1) & 0xFFFF;
      t[i] = (uint16_t)c;
    }
  }
};

static uint8_t crc8(const uint8_t* d, long n) {
  static const Crc8Table T;
  uint8_t c = 0;
  for (long i = 0; i < n; i++) c = T.t[c ^ d[i]];
  return c;
}

static uint16_t crc16(const uint8_t* d, long n) {
  static const Crc16Table T;
  uint16_t c = 0;
  for (long i = 0; i < n; i++) c = (uint16_t)((c << 8) ^ T.t[(c >> 8) ^ d[i]]);
  return c;
}

// ----------------------------------------------------------- BitWriter

struct BitWriter {
  uint8_t* buf;
  long cap;
  long nbytes = 0;
  uint64_t acc = 0;
  int nacc = 0;  // always < 8 between calls
  bool overflow = false;
  BitWriter(uint8_t* b, long c) : buf(b), cap(c) {}
  inline void write(uint64_t v, int n) {  // n <= 32
    if (!n) return;
    if (n < 64) v &= (1ull << n) - 1;
    acc = (acc << n) | v;
    nacc += n;
    while (nacc >= 8) {
      nacc -= 8;
      if (nbytes >= cap) { overflow = true; return; }
      buf[nbytes++] = (uint8_t)(acc >> nacc);
    }
  }
  inline void align() {
    int pad = (8 - (nacc & 7)) & 7;
    if (pad) write(0, pad);
  }
};

// ------------------------------------------------------- header fields

static int block_size_code(long n) {
  switch (n) {
    case 192: return 1;   case 576: return 2;   case 1152: return 3;
    case 2304: return 4;  case 4608: return 5;  case 256: return 8;
    case 512: return 9;   case 1024: return 10; case 2048: return 11;
    case 4096: return 12; case 8192: return 13; case 16384: return 14;
    case 32768: return 15;
    default: return 7;
  }
}

static int rate_code(int sr) {
  switch (sr) {
    case 88200: return 1;  case 176400: return 2; case 192000: return 3;
    case 8000: return 4;   case 16000: return 5;  case 22050: return 6;
    case 24000: return 7;  case 32000: return 8;  case 44100: return 9;
    case 48000: return 10; case 96000: return 11;
    default: return 0;
  }
}

static int bits_code(int bits) {
  switch (bits) {
    case 8: return 1;  case 12: return 2; case 16: return 4;
    case 20: return 5; case 24: return 6;
    default: return 0;
  }
}

static int utf8_frame_number(uint64_t n, uint8_t* out) {
  if (n < 0x80) { out[0] = (uint8_t)n; return 1; }
  int bits = 64 - __builtin_clzll(n);
  int nbytes = 2;
  while (bits > 6 * (nbytes - 1) + (7 - nbytes)) nbytes++;
  int lead = (0xFF << (8 - nbytes)) & 0xFF;
  int shift = 6 * (nbytes - 1);
  out[0] = (uint8_t)(lead | (n >> shift));
  for (int i = 0; i < nbytes - 1; i++) {
    shift -= 6;
    out[1 + i] = (uint8_t)(0x80 | ((n >> shift) & 0x3F));
  }
  return nbytes;
}

// ------------------------------------------------------ Rice residual

struct RiceScratch {
  std::vector<uint64_t> u;     // zigzag-folded residuals
  std::vector<uint64_t> pref;  // per-k prefix sums, rows of (m+1)
  int krows = 0;
};

// Exact _best_rice_k over partition [a, b) using the prefix tables:
// k0 from the truncated folded mean, candidates max(k0-2,0)..min(k0+3,
// 30), baseline k=0, strict < so ties keep the smaller k.
static inline void best_rice_k(const RiceScratch& s, long stride, long a,
                               long b, int* bk, long long* bc) {
  long cnt = b - a;
  uint64_t sum = s.pref[b] - s.pref[a];  // row k=0 is u itself
  double mean = cnt ? (double)sum / (double)cnt : 0.0;
  int k0 = 0;
  if (mean >= 1.0) {
    uint64_t mi = (uint64_t)mean;
    k0 = (64 - __builtin_clzll(mi)) - 1;
    if (k0 < 0) k0 = 0;
  }
  long long best_c = (long long)sum + cnt;
  int best_k = 0;
  int lo = k0 - 2 > 0 ? k0 - 2 : 0;
  int hi = k0 + 3 < 30 ? k0 + 3 : 30;
  // huge means (hostile residuals) push k0 past the 30 cap; keep the
  // window non-empty so k=30 is evaluated and k=0 can't win by
  // default with an astronomically long unary run
  if (lo > hi) lo = hi;
  for (int k = lo; k <= hi; k++) {
    uint64_t sk = (k < s.krows) ? s.pref[(size_t)k * stride + b] -
                                      s.pref[(size_t)k * stride + a]
                                : 0;
    long long c = (long long)sk + cnt * (1 + (long long)k);
    if (c < best_c) { best_c = c; best_k = k; }
  }
  *bk = best_k;
  *bc = best_c;
}

// Residual section: method + partition order (exact mirror of
// _write_residual's search: po 0..6 dividing n, first partition
// non-empty, lowest po wins cost ties) + Rice codes.
template <typename T>
static void write_residual(BitWriter& w, const T* res, long n,
                           int pred_order, RiceScratch& s) {
  long m = n - pred_order;
  s.u.resize(m);
  uint64_t maxu = 0;
  for (long i = 0; i < m; i++) {
    int64_t r = (int64_t)res[i];
    uint64_t u = ((uint64_t)r << 1) ^ (uint64_t)(r >> 63);
    s.u[i] = u;
    if (u > maxu) maxu = u;
  }
  // prefix-sum rows for k = 0..min(30, bitlen(maxu)+3); higher k rows
  // are all-zero sums (candidate window never exceeds k0+3)
  int kbits = maxu ? 64 - __builtin_clzll(maxu) : 0;
  int krows = std::min(30, kbits + 3) + 1;
  long stride = m + 1;
  s.pref.resize((size_t)krows * stride);
  s.krows = krows;
  for (int k = 0; k < krows; k++) {
    uint64_t* row = s.pref.data() + (size_t)k * stride;
    uint64_t acc = 0;
    row[0] = 0;
    for (long i = 0; i < m; i++) {
      acc += s.u[i] >> k;
      row[i + 1] = acc;
    }
  }

  int best_po = -1, best_nparts = 1;
  long long best_cost = 0;
  int best_ks[64];
  for (int po = 0; po <= 6; po++) {
    int parts = 1 << po;
    if (n % parts) continue;
    long plen = n / parts;
    if (plen <= pred_order || plen < 1) continue;
    long long cost = 0;
    int ks[64], kmaxv = 0;
    long off = 0;
    for (int p = 0; p < parts; p++) {
      long cnt = (p == 0) ? plen - pred_order : plen;
      int k;
      long long c;
      best_rice_k(s, stride, off, off + cnt, &k, &c);
      ks[p] = k;
      if (k > kmaxv) kmaxv = k;
      cost += c;
      off += cnt;
    }
    cost += (long long)parts * (kmaxv > 14 ? 5 : 4);
    if (best_po < 0 || cost < best_cost) {
      best_po = po;
      best_cost = cost;
      best_nparts = parts;
      memcpy(best_ks, ks, sizeof(int) * parts);
    }
  }
  if (best_po < 0) {  // unreachable for valid blocks; defensive
    best_po = 0;
    best_nparts = 1;
    long long c;
    best_rice_k(s, stride, 0, m, &best_ks[0], &c);
  }
  int kmaxv = 0;
  for (int p = 0; p < best_nparts; p++)
    if (best_ks[p] > kmaxv) kmaxv = best_ks[p];
  int method = kmaxv > 14 ? 1 : 0;
  int pbits = method ? 5 : 4;
  w.write(method, 2);
  w.write(best_po, 4);
  long plen = n / best_nparts;
  long off = 0;
  for (int p = 0; p < best_nparts; p++) {
    long cnt = (p == 0) ? plen - pred_order : plen;
    int k = best_ks[p];
    w.write(k, pbits);
    for (long i = off; i < off + cnt; i++) {
      uint64_t u = s.u[i];
      uint64_t q = u >> k;
      while (q >= 32) {
        if (w.overflow) return;  // 64-bit residuals can imply unary
        w.write(0, 32);          // runs far past any frame cap; stop
        q -= 32;                 // writing the moment the cap is hit
      }
      w.write(1, (int)q + 1);  // q zeros then the unary terminator
      if (k) w.write(u & ((1ull << k) - 1), k);
    }
    if (w.overflow) return;
    off += cnt;
  }
}

// ---------------------------------------------------------- subframes

enum Kind { K_CONSTANT = 0, K_VERBATIM = 1, K_FIXED = 2, K_LPC = 3 };

template <typename W, typename T>
static void write_subframe(BitWriter& w, int kind, int ord, int slot_bits,
                           const W* warmup, const T* res, long n,
                           int precision, int shift, const int32_t* qlp,
                           RiceScratch& s) {
  w.write(0, 1);  // zero pad
  if (kind == K_CONSTANT) {
    w.write(0, 6);
    w.write(0, 1);
    w.write((uint64_t)(int64_t)warmup[0], slot_bits);
    return;
  }
  if (kind == K_VERBATIM) {
    w.write(1, 6);
    w.write(0, 1);
    for (long i = 0; i < n; i++)
      w.write((uint64_t)(int64_t)warmup[i], slot_bits);
    return;
  }
  if (kind == K_FIXED) {
    w.write(8 | ord, 6);
    w.write(0, 1);
    for (int i = 0; i < ord; i++)
      w.write((uint64_t)(int64_t)warmup[i], slot_bits);
    write_residual(w, res, n, ord, s);
    return;
  }
  w.write(0x20 | (ord - 1), 6);  // LPC
  w.write(0, 1);
  for (int i = 0; i < ord; i++)
    w.write((uint64_t)(int64_t)warmup[i], slot_bits);
  w.write(precision - 1, 4);
  w.write(shift, 5);
  for (int i = 0; i < ord; i++)
    w.write((uint64_t)(int64_t)qlp[i], precision);
  write_residual(w, res, n, ord, s);
}

// -------------------------------------------------------- frame shell

static void frame_header(BitWriter& w, long n, int sample_rate,
                         int declared_bits, int assignment,
                         uint64_t frame_no) {
  w.write(0b11111111111110, 14);
  w.write(0, 1);  // reserved
  w.write(0, 1);  // fixed blocksize strategy
  int bs_code = block_size_code(n);
  w.write(bs_code, 4);
  int sr_code = rate_code(sample_rate);
  if (sr_code == 0 && sample_rate % 10 == 0 && sample_rate / 10 < 65536)
    sr_code = 14;
  else if (sr_code == 0 && sample_rate < 65536)
    sr_code = 13;
  w.write(sr_code, 4);
  w.write(assignment, 4);
  w.write(bits_code(declared_bits), 3);
  w.write(0, 1);  // reserved
  uint8_t fno[16];  // up to 13 bytes for a full 64-bit frame number
  int nb = utf8_frame_number(frame_no, fno);
  for (int i = 0; i < nb; i++) w.write(fno[i], 8);
  if (bs_code == 7) w.write(n - 1, 16);
  if (sr_code == 14)
    w.write(sample_rate / 10, 16);
  else if (sr_code == 13)
    w.write(sample_rate, 16);
  // header is byte-aligned here; CRC-8 covers everything so far
  w.write(crc8(w.buf, w.nbytes), 8);
}

static long finish_frame(BitWriter& w) {
  w.align();
  uint16_t c = crc16(w.buf, w.nbytes);
  w.write(c >> 8, 8);
  w.write(c & 0xFF, 8);
  return w.overflow ? -1 : w.nbytes;
}

// decorrelation slot sources per assignment code, indices into the
// (L, R, L-R, (L+R)>>1) candidate stack (models/flac_encode_batch.py
// _SLOT_SOURCES)
static void slot_sources(int assign, int* s0, int* s1) {
  switch (assign) {
    case 1: *s0 = 0; *s1 = 1; break;
    case 8: *s0 = 0; *s1 = 2; break;
    case 9: *s0 = 2; *s1 = 1; break;
    case 10: *s0 = 3; *s1 = 2; break;
    default: *s0 = 0; *s1 = 0; break;
  }
}

}  // namespace

namespace {

// Pack F frames from device-analysis plans (see the extern "C"
// wrappers for the layout contract).  Templated on the PCM block
// element type: int32 is the generic path, int16 lets <=16-bit
// serving ship its analysis wire dtype straight to the packer with
// no widening copy on the 1-core host.
template <typename T>
long pack_frames_impl(long F, long N, int channels, int sample_rate,
                      int bits, int precision, const int64_t* frame_no,
                      const int32_t* assign, const int32_t* kind,
                      const int32_t* order, const int32_t* shift,
                      const int32_t* qlp, int qstride,
                      const int32_t* res, const T* block,
                      uint8_t* out, long cap, int64_t* out_len) {
  if (precision < 1) precision = 1;
  if (precision > 15) precision = 15;  // 4-bit wire field (15 = escape)
  std::vector<int32_t> src(2 * N);
  std::vector<int64_t> rsc(N);  // recomputed residual scratch
  RiceScratch scratch;
  for (long f = 0; f < F; f++) {
    const T* L = block + (size_t)(f * 2 + 0) * N;
    const T* R = block + (size_t)(f * 2 + 1) * N;
    int a = channels == 1 ? 0 : assign[f];
    int nslots = channels == 1 ? 1 : 2;
    int s0, s1;
    slot_sources(a, &s0, &s1);
    int srcsel[2] = {channels == 1 ? 0 : s0, s1};
    int slot_bits[2] = {
        bits + (channels == 2 && a == 9 ? 1 : 0),
        bits + (channels == 2 && (a == 8 || a == 10) ? 1 : 0)};
    for (int slot = 0; slot < nslots; slot++) {
      int32_t* dst = src.data() + (size_t)slot * N;
      switch (srcsel[slot]) {
        case 0:
          for (long i = 0; i < N; i++) dst[i] = (int32_t)L[i];
          break;
        case 1:
          for (long i = 0; i < N; i++) dst[i] = (int32_t)R[i];
          break;
        case 2:
          for (long i = 0; i < N; i++)
            dst[i] = (int32_t)L[i] - (int32_t)R[i];
          break;
        default:
          for (long i = 0; i < N; i++)
            dst[i] = (int32_t)(((int64_t)L[i] + R[i]) >> 1);
          break;
      }
    }
    BitWriter w(out + (size_t)f * cap, cap);
    frame_header(w, N, sample_rate, bits, a, (uint64_t)frame_no[f]);
    for (int slot = 0; slot < nslots; slot++) {
      const int32_t* sv = src.data() + (size_t)slot * N;
      bool is_const = true;
      if (sv[0] != sv[N - 1]) {
        is_const = false;
      } else {
        for (long i = 1; i < N; i++)
          if (sv[i] != sv[0]) { is_const = false; break; }
      }
      // clamp plan fields to the wire contract: hostile/garbled plans
      // must not read outside the qlp row or the block
      int o = order[f * 2 + slot];
      int omax = qstride < 32 ? qstride : 32;
      if (o < 0) o = 0;
      if (o > omax) o = omax;
      if ((long)o >= N) o = (int)(N > 0 ? N - 1 : 0);
      int k = is_const ? K_CONSTANT
                       : (kind[f * 2 + slot] == 1 && o >= 1 ? K_LPC
                                                            : K_FIXED);
      if (k == K_FIXED && o > 4) o = 4;
      if (k == K_LPC && o > 32) o = 32;
      int sh = shift[f * 2 + slot];
      if (sh < 0) sh = 0;
      if (sh > 31) sh = 31;
      const int32_t* q = qlp + (size_t)(f * 2 + slot) * qstride;
      if (res) {
        write_subframe(w, k, o, slot_bits[slot], sv,
                       res + (size_t)(f * 2 + slot) * N + o, N, precision,
                       sh, q, scratch);
      } else {
        // recompute the chosen plan's residual (ops/flac_enc_batch.py
        // integer semantics: int64 products, arithmetic >> shift)
        if (k == K_FIXED) {
          long m = N;
          for (long i = 0; i < N; i++) rsc[i] = sv[i];
          for (int d = 0; d < o; d++) {
            for (long i = 0; i + 1 < m; i++) rsc[i] = rsc[i + 1] - rsc[i];
            m--;
          }
        } else if (k == K_LPC) {
          for (long i = o; i < N; i++) {
            int64_t acc = 0;
            for (int j = 0; j < o; j++) acc += (int64_t)q[j] * sv[i - 1 - j];
            rsc[i - o] = (int64_t)sv[i] - (acc >> sh);
          }
        }
        write_subframe(w, k, o, slot_bits[slot], sv, rsc.data(), N,
                       precision, sh, q, scratch);
      }
    }
    long len = finish_frame(w);
    if (len < 0) return -(f + 1);
    out_len[f] = len;
  }
  return 0;
}

}  // namespace

extern "C" {

// Pack F frames from device-analysis plans.  Layouts:
//   frame_no [F] i64        assign [F] i32
//   kind/order/shift [F*2] i32   (kind: 0=fixed 1=lpc, device coding)
//   qlp [F*2*qstride] i32        res [F*2*N] i32 (aligned at [order:])
//   block [F*2*N] i32 original channel samples (row 1 ignored if mono)
//   out [F*cap] u8               out_len [F] i64
// res may be NULL: the residuals are then recomputed here from the
// decorrelated sources with the decoder's exact integer semantics
// (identical to the device values by construction) — this keeps the
// 2*N*4-byte-per-frame residual plane off the d2h link entirely;
// only the ~50-byte plan rows come back from device.
// Returns 0, or -(f+1) if frame f overflowed cap.
long skt_flac_pack_frames(long F, long N, int channels, int sample_rate,
                          int bits, int precision, const int64_t* frame_no,
                          const int32_t* assign, const int32_t* kind,
                          const int32_t* order, const int32_t* shift,
                          const int32_t* qlp, int qstride,
                          const int32_t* res, const int32_t* block,
                          uint8_t* out, long cap, int64_t* out_len) {
  return pack_frames_impl<int32_t>(F, N, channels, sample_rate, bits,
                                   precision, frame_no, assign, kind, order,
                                   shift, qlp, qstride, res, block, out, cap,
                                   out_len);
}

// Same contract with an int16 block plane (<=16-bit streams: the
// analysis wire dtype, half the bytes and no host widening copy).
long skt_flac_pack_frames16(long F, long N, int channels, int sample_rate,
                            int bits, int precision, const int64_t* frame_no,
                            const int32_t* assign, const int32_t* kind,
                            const int32_t* order, const int32_t* shift,
                            const int32_t* qlp, int qstride,
                            const int32_t* res, const int16_t* block,
                            uint8_t* out, long cap, int64_t* out_len) {
  return pack_frames_impl<int16_t>(F, N, channels, sample_rate, bits,
                                   precision, frame_no, assign, kind, order,
                                   shift, qlp, qstride, res, block, out, cap,
                                   out_len);
}

// Pack ONE frame from explicit subframe plans (the generic
// write_frame path; kind here is the wire enum incl. verbatim:
// 0=constant 1=verbatim 2=fixed 3=lpc).  warmup/res are [nslots*n]
// i64 rows (verbatim uses the full warmup row; res rows hold the
// residual at [0:n-order)).  Returns the byte length, or -1 on
// overflow.
long skt_flac_pack_frame1(long n, int sample_rate, int bits, int precision,
                          int64_t frame_no, int assignment, int nslots,
                          const int32_t* kind, const int32_t* order,
                          const int32_t* slot_bits, const int32_t* shiftv,
                          const int64_t* warmup, const int64_t* res,
                          const int32_t* qlp, uint8_t* out, long cap) {
  BitWriter w(out, cap);
  frame_header(w, n, sample_rate, bits, assignment, (uint64_t)frame_no);
  RiceScratch scratch;
  if (precision < 1) precision = 1;
  if (precision > 15) precision = 15;  // 4-bit wire field (15 = escape)
  for (int slot = 0; slot < nslots; slot++) {
    int k = kind[slot];
    if (k < 0 || k > 3) k = K_VERBATIM;
    int o = order[slot];
    if (o < 0) o = 0;
    if (o > 32) o = 32;
    if ((long)o >= n) o = (int)(n > 0 ? n - 1 : 0);
    if (k == K_LPC && o < 1) k = K_FIXED;
    if (k == K_FIXED && o > 4) o = 4;
    int sh = shiftv[slot];
    if (sh < 0) sh = 0;
    if (sh > 31) sh = 31;
    int sb = slot_bits[slot];
    if (sb < 1) sb = 1;
    if (sb > 33) sb = 33;
    write_subframe(w, k, o, sb, warmup + (size_t)slot * n,
                   res + (size_t)slot * n, n, precision, sh,
                   qlp + (size_t)slot * 32, scratch);
  }
  return finish_frame(w);
}

// Serving-wire packer: scatter F variable-length frame byte blobs
// (concatenated in `buf`, offsets/lengths per frame) into the
// [F, W] uint32 big-endian word plane the device Rice interpreter
// reads.  `out` must be zero-initialised (np.zeros = calloc, cheap);
// only the valid bytes of each frame are touched, byteswapped on the
// way in — the numpy path rewrote the WHOLE padded plane (~3x the
// traffic) per fleet collect.
void skt_pack_frames_be(long F, const uint8_t* buf, const int64_t* offs,
                        const int64_t* lens, long W, uint32_t* out) {
  for (long i = 0; i < F; i++) {
    const uint8_t* src = buf + offs[i];
    long nb = lens[i];
    if (nb > W * 4) nb = W * 4;
    uint32_t* dst = out + (size_t)i * W;
    long full = nb / 4;
    for (long w = 0; w < full; w++) {
      const uint8_t* p = src + w * 4;
      dst[w] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
               ((uint32_t)p[2] << 8) | (uint32_t)p[3];
    }
    long rem = nb - full * 4;
    if (rem > 0) {
      uint32_t v = 0;
      for (long r = 0; r < rem; r++)
        v |= (uint32_t)src[full * 4 + r] << (24 - 8 * r);
      dst[full] = v;
    }
  }
}

}  // extern "C"
