// C++ AAC-LC host syntax parser.
//
// Production port of the Python reference in codecs/aac_lc.py (which
// itself is the parity rebuild of soundkit-aac-lc's host layer): ADTS
// AU parse -> device-ready lane tensors (quantized spectra, per-line
// scales, M/S masks, intensity factors, TNS lpc/regions/permutation,
// window metadata) in exactly the FrameBatch layout consumed by
// ops/aac_batch.py.  The Python parser stays as the executable spec;
// this path removes it from the serving hot loop.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "../generated/aac_tables.h"

namespace {

constexpr int MAX_ORDER = 20;
constexpr int MAX_FILTERS = 8;

struct BitReader {
    // Register-cached reader: `cache` holds bits [pos, pos+ncached)
    // MSB-aligned, refilled 32 bits at a time, so the hot VLC loop
    // peeks and consumes from a register instead of re-loading and
    // byte-swapping memory on every code (the load+bswap dependency
    // chain was the bulk of spectral decode latency).  Invariant:
    // pos + ncached is always byte-aligned.  Reads past EOF yield
    // zero bits; get() reports the overrun via `bad`.
    const uint8_t* data;
    long nbytes;
    long nbits;
    long pos = 0;  // next unconsumed bit (absolute)
    bool bad = false;
    uint64_t cache = 0;
    int ncached = 0;

    BitReader(const uint8_t* d, long len) : data(d), nbytes(len), nbits(len * 8) {
        resync();
    }

    void resync() {
        long byte = pos >> 3;
        uint64_t w = 0;
        if (byte + 8 <= nbytes) {
            memcpy(&w, data + byte, 8);
            w = __builtin_bswap64(w);
        } else {
            for (int i = 0; i < 8; ++i) {
                uint64_t b = (byte + i) < nbytes ? data[byte + i] : 0;
                w = (w << 8) | b;
            }
        }
        int sh = (int)(pos & 7);
        cache = w << sh;
        ncached = 64 - sh;
    }

    inline void refill() {
        long b = (pos + ncached) >> 3;
        if (b + 4 <= nbytes && ncached <= 32) {
            uint32_t w;
            memcpy(&w, data + b, 4);
            w = __builtin_bswap32(w);
            cache |= (uint64_t)w << (32 - ncached);
            ncached += 32;
            return;
        }
        while (ncached <= 56) {
            uint64_t v = b < nbytes ? data[b] : 0;
            cache |= v << (56 - ncached);
            ncached += 8;
            ++b;
        }
    }

    // top 32 bits at `pos`, zero-padded past EOF
    inline uint32_t peek32() {
        if (ncached < 32) refill();
        return (uint32_t)(cache >> 32);
    }

    inline void consume(int n) {
        cache <<= n;
        ncached -= n;
        pos += n;
    }

    inline uint32_t get(int n) {
        if (pos + n > nbits) { bad = true; pos = nbits; cache = 0; ncached = 0; return 0; }
        if (!n) return 0;
        if (ncached < n) refill();
        uint32_t v = (uint32_t)(cache >> (64 - n));
        consume(n);
        return v;
    }

    // forward skip of arbitrary bit count (DSE/FIL payloads)
    inline void skip(long n) {
        pos += n;
        if (pos > nbits) { bad = true; pos = nbits; }
        resync();
    }

    long left() const { return nbits - pos; }
};

struct Vlc {
    // Two-level table.  A flat 2^max_len LUT is catastrophic for long
    // books: the scalefactor book has max_len 19, so the flat table is
    // 2 MiB and a 1-bit code strides 1 MiB of it -- nearly every read
    // was an L2/L3 miss.  Level 1 covers L1_BITS (4 KiB, cache
    // resident, hits every code <= L1_BITS which is all the hot ones);
    // longer codes escape to small per-prefix subtables.
    // Entry encoding: (sym << 8) | code_len for a direct hit;
    // ~((sub_off << 8) | rem_bits) for an escape; INT32_MIN invalid.
    static constexpr int L1_BITS = 10;
    int l1 = 0;
    int max_len = 0;
    std::vector<int32_t> tab;
    std::vector<int32_t> sub;

    void build(const uint32_t* codes32, const uint16_t* codes16,
               const uint8_t* bits, int n) {
        max_len = 0;
        for (int i = 0; i < n; ++i) max_len = std::max<int>(max_len, bits[i]);
        l1 = std::min(max_len, L1_BITS);
        tab.assign(1u << l1, INT32_MIN);
        sub.clear();

        // pass 1: direct entries + per-prefix max remainder
        std::vector<int> rem(1u << l1, 0);
        for (int i = 0; i < n; ++i) {
            uint32_t c = codes32 ? codes32[i] : codes16[i];
            int l = bits[i];
            if (l <= l1) {
                uint32_t base = c << (l1 - l);
                uint32_t span = 1u << (l1 - l);
                for (uint32_t j = 0; j < span; ++j)
                    tab[base + j] = (int32_t)((i << 8) | l);
            } else {
                uint32_t prefix = c >> (l - l1);
                rem[prefix] = std::max(rem[prefix], l - l1);
            }
        }
        // pass 2: allocate one subtable per escaping prefix
        for (uint32_t p = 0; p < (1u << l1); ++p) {
            if (!rem[p]) continue;
            uint32_t off = (uint32_t)sub.size();
            sub.resize(sub.size() + (1u << rem[p]), INT32_MIN);
            tab[p] = ~(int32_t)((off << 8) | (uint32_t)rem[p]);
        }
        // pass 3: fill subtables
        for (int i = 0; i < n; ++i) {
            uint32_t c = codes32 ? codes32[i] : codes16[i];
            int l = bits[i];
            if (l <= l1) continue;
            uint32_t prefix = c >> (l - l1);
            int32_t e = ~tab[prefix];
            uint32_t off = (uint32_t)e >> 8;
            int r = e & 0xFF;
            uint32_t lo = (c & ((1u << (l - l1)) - 1)) << (r - (l - l1));
            uint32_t span = 1u << (r - (l - l1));
            for (uint32_t j = 0; j < span; ++j)
                sub[off + lo + j] = (int32_t)((i << 8) | l);
        }
    }

    // resolve the packed (sym << 8 | len) entry for window `w`
    // without consuming; sets br.bad (and returns 0) on invalid codes
    inline int32_t entry_for(uint32_t w, BitReader& br) const {
        int32_t e = tab[w >> (32 - l1)];
        if (e >= 0) return e;
        if (e == INT32_MIN) { br.bad = true; return 0; }
        e = ~e;
        int r = e & 0xFF;
        uint32_t idx = (uint32_t)((uint64_t)w << l1) >> (32 - r);
        int32_t e2 = sub[((uint32_t)e >> 8) + idx];
        if (e2 < 0) { br.bad = true; return 0; }
        return e2;
    }

    inline int read(BitReader& br) const {
        int32_t e = entry_for(br.peek32(), br);
        if (br.bad) return 0;
        br.consume(e & 0xFF);
        if (br.pos > br.nbits) { br.bad = true; return 0; }
        return e >> 8;
    }
};

// codebook properties
struct CbInfo { int dim; int base; bool sign; };
static const CbInfo CB[12] = {
    {0,0,false}, {4,3,true}, {4,3,true}, {4,3,false}, {4,3,false},
    {2,9,true}, {2,9,true}, {2,8,false}, {2,8,false},
    {2,13,false}, {2,13,false}, {2,17,false},
};

struct Tables {
    Vlc spectral[11];
    Vlc sf;
    // per-codebook tuple unpack: 4 int8 values per symbol, pre-offset
    // for the signed books (replaces a div/mod chain per decoded tuple
    // on the hottest loop in the parser)
    std::vector<int8_t> unpack[11];
    // nonzero-value count per symbol (= sign-bit count for the
    // unsigned books, letting the sign bits come out of the same
    // 32-bit window as the codeword)
    std::vector<uint8_t> nzcnt[11];
    // 2^(0.25*(sf-100)) for sf in [0,255] (pow per band was ~25% of
    // the full-mode parse)
    double sf_scale[256];
    bool ready = false;

    void init() {
        if (ready) return;
        for (int i = 0; i < 11; ++i) {
            spectral[i].build(nullptr, AAC_SPECTRAL_CODES[i], AAC_SPECTRAL_BITS[i],
                              AAC_SPECTRAL_SIZES[i]);
            const CbInfo& ci = CB[i + 1];
            int n = AAC_SPECTRAL_SIZES[i];
            unpack[i].assign((size_t)n * 4, 0);
            for (int s = 0; s < n; ++s) {
                int tmp = s;
                int vals[4] = {0, 0, 0, 0};
                for (int d = ci.dim - 1; d >= 0; --d) {
                    vals[d] = tmp % ci.base;
                    tmp /= ci.base;
                }
                if (ci.sign) {
                    int offv = (ci.base - 1) / 2;
                    for (int d = 0; d < ci.dim; ++d) vals[d] -= offv;
                }
                for (int d = 0; d < 4; ++d)
                    unpack[i][(size_t)s * 4 + d] = (int8_t)vals[d];
                int nz = 0;
                for (int d = 0; d < ci.dim; ++d) nz += vals[d] != 0;
                nzcnt[i].push_back((uint8_t)(ci.sign ? 0 : nz));
            }
        }
        sf.build(AAC_SF_CODE, nullptr, AAC_SF_BITS, 121);
        for (int s = 0; s < 256; ++s)
            sf_scale[s] = std::pow(2.0, 0.25 * (s - 100));
        ready = true;
    }
};

Tables g_tables;

// per-channel lane output (matches FrameBatch lane layout)
struct LaneOut {
    int32_t quant[1024];
    int16_t quant16[1024];  // compact wire (written when !full)
    float scale[1024];
    int32_t perm[1024];
    int32_t filt_id[1024];
    float lpc[MAX_FILTERS][MAX_ORDER];
    int32_t seq;
    int32_t shape;
    int32_t valid;
    int32_t overflow;  // |quant| exceeded int16 (compact path)
};

struct FrameOut {
    LaneOut ch[2];
    uint8_t ms_mask[1024];
    float int_factor[1024];
    int8_t int_pos[1024];    // intensity position per line (compact wire)
    int8_t int_sign[1024];   // -1/0/+1 incl. ms inversion
    uint8_t line_sf[2][1024];  // sf per line, 0 = silent (compact wire)
    int16_t regions[2][MAX_FILTERS][3];  // start, end, direction
    int32_t n_channels;
    int32_t element_kind;  // 0 sce, 1 cpe, 3 lfe
    char error[128];
};

struct IcsInfo {
    int window_sequence = 0;
    int window_shape = 0;
    int max_sfb = 0;
    int num_windows = 1;
    int num_window_groups = 1;
    int group_lens[8] = {1};
    int num_swb = 0;
    const uint16_t* swb = nullptr;
};

struct TnsFilt {
    int length, order, direction;
    float coefs[MAX_ORDER];
    // raw sign-extended coef indices + resolution for the v3 wire
    // (device reruns the sin dequant + lattice->direct conversion)
    int8_t raw[MAX_ORDER];
    int crb;
};

struct IcsData {
    IcsInfo info;
    int global_gain = 0;
    int band_type[8][64];
    double band_scale[8][64];
    int band_sf[8][64];      // integer sf (or noise sf); -1 = silent
    int n_tns[8] = {0};
    TnsFilt tns[8][4];
    int coded_limit = 1024;  // quant[coded_limit:] is implicitly zero
    int32_t quant[1024];
    // v4 wire (device entropy decode): spectral_data location + flags
    // for content the raw-AU wire cannot carry (fallback to v3)
    int spectral_bit_start = -1;
    int had_pulse = 0;
    int had_pns = 0;
};

struct Parser {
    int sr_index;
    char error[128] = {0};
    uint32_t pns_state = 0x12345678u;  // PNS sign-noise LCG

    bool fail(const char* msg) {
        snprintf(error, sizeof error, "%s", msg);
        return false;
    }

    bool decode_ics_info(BitReader& br, IcsInfo& ii) {
        if (br.get(1)) return fail("ics_reserved_bit set");
        ii.window_sequence = br.get(2);
        ii.window_shape = br.get(1);
        if (ii.window_sequence == 2) {
            ii.max_sfb = br.get(4);
            uint32_t grouping = br.get(7);
            ii.num_windows = 8;
            ii.num_window_groups = 1;
            ii.group_lens[0] = 1;
            for (int b = 6; b >= 0; --b) {
                if ((grouping >> b) & 1) {
                    ii.group_lens[ii.num_window_groups - 1] += 1;
                } else {
                    ii.group_lens[ii.num_window_groups++] = 1;
                }
            }
            ii.num_swb = AAC_NUM_SWB_128[sr_index];
            ii.swb = AAC_SWB_128[sr_index];
        } else {
            ii.max_sfb = br.get(6);
            if (br.get(1)) return fail("predictor/LTP not supported");
            ii.num_windows = 1;
            ii.num_window_groups = 1;
            ii.group_lens[0] = 1;
            ii.num_swb = AAC_NUM_SWB_1024[sr_index];
            ii.swb = AAC_SWB_1024[sr_index];
        }
        if (ii.max_sfb > ii.num_swb) return fail("max_sfb exceeds num_swb");
        return true;
    }

    // one scalefactor band's worth of spectral tuples; DIM/SIGNED/ESC
    // are compile-time so the hot loop is branch-minimal
    template <int DIM, bool SIGNED, bool ESC>
    static bool decode_band(BitReader& br, const Vlc& vlc,
                            const int8_t* up_tab, const uint8_t* nz_tab,
                            int lo, int hi, int32_t* q) {
        for (int k = lo; k < hi; k += DIM) {
            uint32_t w = br.peek32();
            int32_t e = vlc.entry_for(w, br);
            if (br.bad) return false;
            int sym = e >> 8;
            int len = e & 0xFF;
            const int8_t* up = up_tab + (size_t)sym * 4;
            if (SIGNED) {
                br.consume(len);
                if (br.pos > br.nbits) { br.bad = true; return false; }
                for (int d = 0; d < DIM; ++d) q[k + d] = up[d];
            } else {
                // sign bits follow the codeword, one per nonzero value
                // in value order -- they come out of the same window
                int nz = nz_tab[sym];
                uint32_t sbits = (w >> (32 - len - nz)) & ((1u << nz) - 1u);
                br.consume(len + nz);
                if (br.pos > br.nbits) { br.bad = true; return false; }
                int bit = nz;
                for (int d = 0; d < DIM; ++d) {
                    int v = up[d];
                    if (v) {
                        bool neg = (sbits >> --bit) & 1;
                        if (ESC && v == 16) {
                            int n = 4;
                            while (br.get(1)) {
                                if (++n > 28) { br.bad = true; return false; }
                            }
                            v = (1 << n) | (int)br.get(n);
                        }
                        if (neg) v = -v;
                    }
                    q[k + d] = v;
                }
            }
        }
        return true;
    }

    // length-only spectral walk for the v4 raw-AU wire: advances the
    // reader past one band's tuples without materializing values (the
    // device entropy interpreter re-decodes them from the raw AU)
    template <int DIM, bool SIGNED, bool ESC>
    static bool skip_band(BitReader& br, const Vlc& vlc,
                          const int8_t* up_tab, const uint8_t* nz_tab,
                          int lo, int hi) {
        for (int k = lo; k < hi; k += DIM) {
            uint32_t w = br.peek32();
            int32_t e = vlc.entry_for(w, br);
            if (br.bad) return false;
            int sym = e >> 8;
            int len = e & 0xFF;
            if (SIGNED) {
                br.consume(len);
            } else {
                int nz = nz_tab[sym];
                br.consume(len + nz);
                if (ESC) {
                    const int8_t* up = up_tab + (size_t)sym * 4;
                    for (int d = 0; d < DIM; ++d) {
                        if (up[d] == 16) {
                            int n = 4;
                            while (br.get(1)) {
                                if (++n > 28) { br.bad = true; return false; }
                            }
                            br.consume(n);
                        }
                    }
                }
            }
            if (br.pos > br.nbits) { br.bad = true; return false; }
        }
        return true;
    }

    bool decode_ics(BitReader& br, bool common, const IcsInfo* shared, IcsData& ics,
                    double* is_scale /* [8][64] out for intensity */,
                    int* is_sign /* [8][64] */,
                    int* is_ipos /* [8][64] */,
                    bool full = true /* compact wire skips float scales */,
                    bool skip_spec = false /* v4: length-only spectral walk */) {
        ics.global_gain = (int)br.get(8);
        if (common) ics.info = *shared;
        else if (!decode_ics_info(br, ics.info)) return false;

        const IcsInfo& ii = ics.info;
        bool short_win = ii.window_sequence == 2;
        int bits = short_win ? 3 : 5;
        int esc = (1 << bits) - 1;

        // init only the rows the walks below read ([group][0..max_sfb));
        // the full 8x64 memsets were a measurable slice of the per-AU
        // cost (gprof: decode_ics ~79% of batch parse)
        for (int g = 0; g < ii.num_window_groups; ++g) {
            memset(ics.band_type[g], 0, (size_t)ii.max_sfb * sizeof(int));
            if (full)
                memset(ics.band_scale[g], 0, (size_t)ii.max_sfb * sizeof(double));
        }
        for (int g = 0; g < ii.num_window_groups; ++g) {
            int k = 0;
            while (k < ii.max_sfb) {
                int cb = (int)br.get(4);
                if (cb == 12) return fail("invalid codebook 12");
                int run = 0, incr;
                do { incr = (int)br.get(bits); run += incr; } while (incr == esc);
                // an exhausted reader returns 0 without advancing, so a
                // zero-length run must bail or this loop never ends
                // (fuzz: 21-byte AU spun forever here)
                if (br.bad) return fail("bitstream overrun");
                if (k + run > ii.max_sfb) return fail("section overrun");
                for (int s = k; s < k + run; ++s) ics.band_type[g][s] = cb;
                k += run;
            }
        }

        int sf = ics.global_gain, is_pos = 0, noise = ics.global_gain - 90;
        bool noise_first = true;
        for (int g = 0; g < ii.num_window_groups; ++g)
            for (int s = 0; s < ii.max_sfb; ++s) ics.band_sf[g][s] = -1;
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int s = 0; s < ii.max_sfb; ++s) {
                int cb = ics.band_type[g][s];
                if (cb == 0) continue;
                if (cb == 14 || cb == 15) {
                    is_pos += g_tables.sf.read(br) - 60;
                    if (full) {
                        int t = 100 - is_pos;
                        is_scale[g * 64 + s] = (t >= 0 && t < 256)
                            ? g_tables.sf_scale[t]
                            : std::pow(2.0, -0.25 * is_pos);
                    }
                    is_sign[g * 64 + s] = (cb == 14) ? -1 : 1;
                    is_ipos[g * 64 + s] = is_pos;
                } else if (cb == 13) {
                    if (noise_first) { noise += (int)br.get(9) - 256; noise_first = false; }
                    else noise += g_tables.sf.read(br) - 60;
                    if (full)
                        ics.band_scale[g][s] = (noise >= 0 && noise < 256)
                            ? g_tables.sf_scale[noise]
                            : std::pow(2.0, 0.25 * (noise - 100));
                    // clamp into the u8 line_sf wire (0 means silent)
                    ics.band_sf[g][s] = noise < 1 ? 1 : (noise > 255 ? 255 : noise);
                } else {
                    sf += g_tables.sf.read(br) - 60;
                    if (sf < 0 || sf > 255) return fail("scalefactor out of range");
                    if (full) ics.band_scale[g][s] = g_tables.sf_scale[sf];
                    ics.band_sf[g][s] = sf;
                }
                if (br.bad) return fail("bitstream overrun");
            }
        }

        // pulse
        int n_pulse = 0, pulse_pos[4], pulse_amp[4];
        if (br.get(1)) {
            if (short_win) return fail("pulse in short window");
            n_pulse = (int)br.get(2) + 1;
            int start_sfb = (int)br.get(6);
            if (start_sfb >= ii.num_swb) return fail("pulse start out of range");
            int pos = ii.swb[start_sfb];
            for (int p = 0; p < n_pulse; ++p) {
                pos += (int)br.get(5);
                pulse_pos[p] = pos;
                pulse_amp[p] = (int)br.get(4);
            }
        }

        // tns
        memset(ics.n_tns, 0, sizeof ics.n_tns);
        if (br.get(1)) {
            for (int w = 0; w < ii.num_windows; ++w) {
                int n_filt = (int)br.get(short_win ? 1 : 2);
                int coef_res = n_filt ? (int)br.get(1) : 0;
                for (int f = 0; f < n_filt; ++f) {
                    TnsFilt& tf = ics.tns[w][f];
                    tf.length = (int)br.get(short_win ? 4 : 6);
                    tf.order = (int)br.get(short_win ? 3 : 5);
                    tf.direction = 0;
                    tf.crb = coef_res + 3;
                    if (tf.order) {
                        tf.direction = (int)br.get(1);
                        int compress = (int)br.get(1);
                        int coef_len = coef_res + 3 - compress;
                        int crb = coef_res + 3;
                        double iqfac = ((1 << (crb - 1)) - 0.5) / (M_PI / 2.0);
                        double iqfac_m = ((1 << (crb - 1)) + 0.5) / (M_PI / 2.0);
                        for (int i = 0; i < tf.order && i < MAX_ORDER; ++i) {
                            int c = (int)br.get(coef_len);
                            if (c >= 1 << (coef_len - 1)) c -= 1 << coef_len;
                            tf.raw[i] = (int8_t)c;
                            tf.coefs[i] = (float)std::sin(c / (c >= 0 ? iqfac : iqfac_m));
                        }
                    }
                }
                ics.n_tns[w] = n_filt;
            }
        }

        if (br.get(1)) return fail("gain control (SSR) not supported");

        // spectral data.  Only lines below swb[max_sfb] are ever coded
        // (long windows), so zero and later convert just that prefix.
        ics.spectral_bit_start = (int)br.pos;
        ics.had_pulse = n_pulse;
        ics.had_pns = 0;
        for (int g = 0; g < ii.num_window_groups; ++g)
            for (int s = 0; s < ii.max_sfb; ++s)
                if (ics.band_type[g][s] == 13) ics.had_pns = 1;
        if (skip_spec) {
            // v4 raw-AU wire: traverse the spectral bits (to locate
            // the next syntactic element) without decoding values
            for (int g = 0; g < ii.num_window_groups; ++g) {
                for (int s = 0; s < ii.max_sfb; ++s) {
                    int cb = ics.band_type[g][s];
                    if (cb == 0 || cb >= 13) continue;
                    int lo = ii.swb[s], hi = ii.swb[s + 1];
                    const Vlc& vlc = g_tables.spectral[cb - 1];
                    const int8_t* up_tab = g_tables.unpack[cb - 1].data();
                    const uint8_t* nz_tab = g_tables.nzcnt[cb - 1].data();
                    for (int w = 0; w < ii.group_lens[g]; ++w) {
                        bool ok;
                        switch (cb) {
                            case 1: case 2:
                                ok = skip_band<4, true, false>(br, vlc, up_tab, nz_tab, lo, hi);
                                break;
                            case 3: case 4:
                                ok = skip_band<4, false, false>(br, vlc, up_tab, nz_tab, lo, hi);
                                break;
                            case 5: case 6:
                                ok = skip_band<2, true, false>(br, vlc, up_tab, nz_tab, lo, hi);
                                break;
                            case 11:
                                ok = skip_band<2, false, true>(br, vlc, up_tab, nz_tab, lo, hi);
                                break;
                            default:
                                ok = skip_band<2, false, false>(br, vlc, up_tab, nz_tab, lo, hi);
                                break;
                        }
                        if (!ok) return fail("spectral overrun");
                    }
                }
            }
            return !br.bad || !fail("bitstream overrun");
        }
        ics.coded_limit = (short_win || n_pulse) ? 1024 : ii.swb[ii.max_sfb];
        memset(ics.quant, 0, (size_t)ics.coded_limit * 4);
        int win_base[8];
        int acc = 0;
        for (int g = 0; g < ii.num_window_groups; ++g) { win_base[g] = acc; acc += ii.group_lens[g]; }
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int s = 0; s < ii.max_sfb; ++s) {
                int cb = ics.band_type[g][s];
                if (cb == 0 || cb >= 13) continue;
                int lo = ii.swb[s], hi = ii.swb[s + 1];
                const Vlc& vlc = g_tables.spectral[cb - 1];
                const int8_t* up_tab = g_tables.unpack[cb - 1].data();
                const uint8_t* nz_tab = g_tables.nzcnt[cb - 1].data();
                for (int w = 0; w < ii.group_lens[g]; ++w) {
                    int off = short_win ? (win_base[g] + w) * 128 : 0;
                    int32_t* q = ics.quant + off;
                    bool ok;
                    // dim/sign/escape as compile-time constants so the
                    // per-tuple loop carries no data-dependent branches
                    switch (cb) {
                        case 1: case 2:
                            ok = decode_band<4, true, false>(br, vlc, up_tab, nz_tab, lo, hi, q);
                            break;
                        case 3: case 4:
                            ok = decode_band<4, false, false>(br, vlc, up_tab, nz_tab, lo, hi, q);
                            break;
                        case 5: case 6:
                            ok = decode_band<2, true, false>(br, vlc, up_tab, nz_tab, lo, hi, q);
                            break;
                        case 11:
                            ok = decode_band<2, false, true>(br, vlc, up_tab, nz_tab, lo, hi, q);
                            break;
                        default:  // 7, 8, 9, 10
                            ok = decode_band<2, false, false>(br, vlc, up_tab, nz_tab, lo, hi, q);
                            break;
                    }
                    if (!ok) return fail("spectral overrun");
                }
            }
        }
        for (int p = 0; p < n_pulse; ++p) {
            if (pulse_pos[p] >= 1024) return fail("pulse position out of range");
            int32_t& q = ics.quant[pulse_pos[p]];
            q += (q > 0) ? pulse_amp[p] : -pulse_amp[p];
        }
        return !br.bad || !fail("bitstream overrun");
    }

    void fill_lane(const IcsData& ics, LaneOut& lane,
                   uint8_t* line_sf, int16_t (*regions)[3], bool full = true) {
        const IcsInfo& ii = ics.info;
        bool short_win = ii.window_sequence == 2;
        int lim = ics.coded_limit;
        if (full) {
            memcpy(lane.quant, ics.quant, (size_t)lim * 4);
            memset(lane.quant + lim, 0, (size_t)(1024 - lim) * 4);
            memset(lane.scale, 0, sizeof lane.scale);
            for (int i = 0; i < 1024; ++i) lane.perm[i] = i;
            for (int i = 0; i < 1024; ++i) lane.filt_id[i] = -1;
        } else {
            // compact wire: i16 quant only; scale/perm/filt are
            // reconstructed on device from line_sf/regions/seq
            lane.overflow = 0;
            for (int i = 0; i < lim; ++i) {
                int32_t v = ics.quant[i];
                if (v > 32767 || v < -32768) {
                    lane.overflow = 1;
                    v = v > 0 ? 32767 : -32768;
                }
                lane.quant16[i] = (int16_t)v;
            }
            memset(lane.quant16 + lim, 0, (size_t)(1024 - lim) * 2);
        }
        memset(lane.lpc, 0, sizeof lane.lpc);
        lane.seq = ii.window_sequence;
        lane.shape = ii.window_shape;
        lane.valid = 1;

        memset(line_sf, 0, 1024);
        int wbase = 0;
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int s = 0; s < ii.max_sfb; ++s) {
                int cb = ics.band_type[g][s];
                if (cb == 0 || cb == 14 || cb == 15) continue;
                bool pns = cb == 13;
                int lo = ii.swb[s], hi = ii.swb[s + 1];
                for (int w = 0; w < ii.group_lens[g]; ++w) {
                    int off = short_win ? (wbase + w) * 128 : 0;
                    for (int k = lo; k < hi; ++k) {
                        if (full) lane.scale[off + k] = (float)ics.band_scale[g][s];
                        int sfv = ics.band_sf[g][s];
                        line_sf[off + k] = (uint8_t)(sfv > 0 ? sfv : 0);
                        if (pns) {
                            // perceptual noise substitution as sign
                            // noise on the quant wire: |+-1|^(4/3) = 1
                            // so coef = +-scale, band energy n*scale^2
                            // (exactly the host apply_pns target); the
                            // RNG is unspecified by the spec
                            pns_state = pns_state * 1664525u + 1013904223u;
                            int32_t v = (pns_state >> 16) & 1 ? 1 : -1;
                            if (full) lane.quant[off + k] = v;
                            else lane.quant16[off + k] = (int16_t)v;
                        }
                    }
                }
            }
            wbase += ii.group_lens[g];
        }
        for (int f = 0; f < MAX_FILTERS; ++f)
            regions[f][0] = regions[f][1] = regions[f][2] = 0;

        // tns -> filt ids / lpc / perm
        int tmax = short_win ? AAC_TNS_MAX_128[sr_index] : AAC_TNS_MAX_1024[sr_index];
        int mmax = std::min(tmax, ii.max_sfb);
        int nf = 0;
        for (int w = 0; w < ii.num_windows; ++w) {
            int bottom = ii.num_swb;
            for (int f = 0; f < ics.n_tns[w]; ++f) {
                const TnsFilt& tf = ics.tns[w][f];
                int top = bottom;
                bottom = std::max(0, top - tf.length);
                int order = std::min(tf.order, MAX_ORDER);
                if (!order || nf >= MAX_FILTERS) continue;
                int start = ii.swb[std::min(bottom, mmax)];
                int end = ii.swb[std::min(top, mmax)];
                if (end - start <= 0) continue;
                int off = short_win ? w * 128 : 0;
                // parcor -> lpc
                double lpc[MAX_ORDER] = {0};
                for (int m = 0; m < order; ++m) {
                    double kk = tf.coefs[m];
                    double nw[MAX_ORDER];
                    for (int i = 0; i < m; ++i) nw[i] = lpc[i] + kk * lpc[m - 1 - i];
                    nw[m] = kk;
                    for (int i = 0; i <= m; ++i) lpc[i] = nw[i];
                }
                for (int i = 0; i < order; ++i) lane.lpc[nf][i] = (float)lpc[i];
                if (full) {
                    for (int i = off + start; i < off + end; ++i) lane.filt_id[i] = nf;
                    if (tf.direction) {
                        int a = off + start, b = off + end - 1;
                        for (int i = 0; a + i <= b; ++i) lane.perm[a + i] = b - i;
                    }
                }
                regions[nf][0] = (int16_t)(off + start);
                regions[nf][1] = (int16_t)(off + end);
                regions[nf][2] = (int16_t)tf.direction;
                ++nf;
            }
        }
    }

    // ---- compact wire, written directly into the caller's packed
    // buffer (no LaneOut staging + memcpy: the copies were ~20% of the
    // batch entry's time) ----

    struct CompactLaneDest {
        int16_t* quant;    // [1024]
        uint8_t* line_sf;  // [1024]
        int16_t* regions;  // [MAX_FILTERS*3]
        float* lpc;        // [MAX_FILTERS*MAX_ORDER]
    };

    struct CompactDest {
        CompactLaneDest ch[2];
        int8_t* int_pos;   // [1024]
        int8_t* int_sign;  // [1024]
        uint8_t* ms;       // [1024]
        int32_t* seq;      // [2]
        int32_t* shape;    // [2]
        uint8_t* valid;    // [2]
        int32_t* overflow; // accumulated across lanes
    };

    static void zero_lane_compact(const CompactLaneDest& d) {
        memset(d.quant, 0, 1024 * 2);
        memset(d.line_sf, 0, 1024);
        memset(d.regions, 0, MAX_FILTERS * 3 * 2);
        memset(d.lpc, 0, MAX_FILTERS * MAX_ORDER * 4);
    }

    void fill_lane_compact(const IcsData& ics, const CompactLaneDest& d,
                           int32_t* overflow) {
        const IcsInfo& ii = ics.info;
        bool short_win = ii.window_sequence == 2;
        int lim = ics.coded_limit;
        for (int i = 0; i < lim; ++i) {
            int32_t v = ics.quant[i];
            if (v > 32767 || v < -32768) {
                *overflow = 1;
                v = v > 0 ? 32767 : -32768;
            }
            d.quant[i] = (int16_t)v;
        }
        memset(d.quant + lim, 0, (size_t)(1024 - lim) * 2);

        memset(d.line_sf, 0, 1024);
        int wbase = 0;
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int s = 0; s < ii.max_sfb; ++s) {
                int cb = ics.band_type[g][s];
                if (cb == 0 || cb == 14 || cb == 15) continue;
                bool pns = cb == 13;
                int lo = ii.swb[s], hi = ii.swb[s + 1];
                uint8_t sfv = (uint8_t)std::max(ics.band_sf[g][s], 0);
                for (int w = 0; w < ii.group_lens[g]; ++w) {
                    int off = short_win ? (wbase + w) * 128 : 0;
                    if (pns) {
                        for (int k = lo; k < hi; ++k) {
                            d.line_sf[off + k] = sfv;
                            // PNS as sign noise (see fill_lane)
                            pns_state = pns_state * 1664525u + 1013904223u;
                            d.quant[off + k] = (pns_state >> 16) & 1 ? 1 : -1;
                        }
                    } else {
                        memset(d.line_sf + off + lo, sfv, (size_t)(hi - lo));
                    }
                }
            }
            wbase += ii.group_lens[g];
        }

        memset(d.regions, 0, MAX_FILTERS * 3 * 2);
        memset(d.lpc, 0, MAX_FILTERS * MAX_ORDER * 4);
        int tmax = short_win ? AAC_TNS_MAX_128[sr_index] : AAC_TNS_MAX_1024[sr_index];
        int mmax = std::min(tmax, ii.max_sfb);
        int nf = 0;
        for (int w = 0; w < ii.num_windows; ++w) {
            int bottom = ii.num_swb;
            for (int f = 0; f < ics.n_tns[w]; ++f) {
                const TnsFilt& tf = ics.tns[w][f];
                int top = bottom;
                bottom = std::max(0, top - tf.length);
                int order = std::min(tf.order, MAX_ORDER);
                if (!order || nf >= MAX_FILTERS) continue;
                int start = ii.swb[std::min(bottom, mmax)];
                int end = ii.swb[std::min(top, mmax)];
                if (end - start <= 0) continue;
                int off = short_win ? w * 128 : 0;
                double lpc[MAX_ORDER] = {0};
                for (int m = 0; m < order; ++m) {
                    double kk = tf.coefs[m];
                    double nw[MAX_ORDER];
                    for (int i = 0; i < m; ++i) nw[i] = lpc[i] + kk * lpc[m - 1 - i];
                    nw[m] = kk;
                    for (int i = 0; i <= m; ++i) lpc[i] = nw[i];
                }
                for (int i = 0; i < order; ++i)
                    d.lpc[nf * MAX_ORDER + i] = (float)lpc[i];
                d.regions[nf * 3 + 0] = (int16_t)(off + start);
                d.regions[nf * 3 + 1] = (int16_t)(off + end);
                d.regions[nf * 3 + 2] = (int16_t)tf.direction;
                ++nf;
            }
        }
    }

    // ---- v3 wire: ~3.6 KB/lane vs compact's ~10.6 KB.  quant as i8
    // plus an escape list, scalefactors / MS / intensity as run-length
    // tables expanded on device, TNS as raw reflection-coef indices
    // (sin dequant + lattice->direct conversion moved on-device).
    // The host writes ~3x fewer bytes per AU and the h2d wire shrinks
    // accordingly. ----

    static constexpr int V3_RUNS = 128;   // sf runs per channel
    static constexpr int V3_ESC = 32;     // escape slots per lane

    struct V3LaneDest {
        int8_t* quant;     // [1024]
        uint8_t* sf_len;   // [V3_RUNS]
        uint8_t* sf_val;   // [V3_RUNS]
        int16_t* regions;  // [MAX_FILTERS*3]
        int8_t* refl;      // [MAX_FILTERS*MAX_ORDER]
        uint8_t* crb;      // [MAX_FILTERS]
        uint8_t* order;    // [MAX_FILTERS]
    };

    struct V3Dest {
        V3LaneDest ch[2];
        uint16_t* esc_idx;  // [V3_ESC], 0xFFFF = unused
        int16_t* esc_val;   // [V3_ESC]
        uint8_t* msis_len;  // [V3_RUNS]
        uint8_t* msis_ms;   // [V3_RUNS]
        int8_t* msis_pos;   // [V3_RUNS]
        int8_t* msis_sign;  // [V3_RUNS]
        uint8_t* seq;       // [2]
        uint8_t* shape;     // [2]
        uint8_t* valid;     // [2]
        int32_t* overflow;
    };

    struct EscState {
        uint16_t* idx;
        int16_t* val;
        int n = 0;
    };

    static void zero_lane_v3(const V3LaneDest& d) {
        memset(d.quant, 0, 1024);
        memset(d.sf_len, 0, V3_RUNS);
        memset(d.sf_val, 0, V3_RUNS);
        memset(d.regions, 0, MAX_FILTERS * 3 * 2);
        memset(d.refl, 0, MAX_FILTERS * MAX_ORDER);
        memset(d.crb, 0, MAX_FILTERS);
        memset(d.order, 0, MAX_FILTERS);
    }

    static void zero_v3(const V3Dest& d) {
        zero_lane_v3(d.ch[0]);
        zero_lane_v3(d.ch[1]);
        memset(d.esc_idx, 0xFF, V3_ESC * 2);
        memset(d.esc_val, 0, V3_ESC * 2);
        memset(d.msis_len, 0, V3_RUNS);
        memset(d.msis_ms, 0, V3_RUNS);
        memset(d.msis_pos, 0, V3_RUNS);
        memset(d.msis_sign, 0, V3_RUNS);
        d.seq[0] = d.seq[1] = 0;
        d.shape[0] = d.shape[1] = 0;
        d.valid[0] = d.valid[1] = 0;
    }

    void fill_lane_v3(const IcsData& ics, const V3LaneDest& d, int ch,
                      EscState& esc, int32_t* overflow) {
        const IcsInfo& ii = ics.info;
        bool short_win = ii.window_sequence == 2;
        int lim = ics.coded_limit;
        for (int i = 0; i < lim; ++i) {
            int32_t v = ics.quant[i];
            if (v >= -127 && v <= 127) {
                d.quant[i] = (int8_t)v;
            } else {
                d.quant[i] = 0;
                if (esc.n < V3_ESC && v >= -32768 && v <= 32767) {
                    esc.idx[esc.n] = (uint16_t)(ch * 1024 + i);
                    esc.val[esc.n] = (int16_t)v;
                    ++esc.n;
                } else {
                    *overflow = 1;
                }
            }
        }
        memset(d.quant + lim, 0, (size_t)(1024 - lim));

        // scalefactor runs in line order; every line of the frame is
        // covered (bands, then per-window pad), so the device-side
        // cumulative-length search never falls off the table
        int nrun = 0;
        auto emit = [&](int len, uint8_t val) {
            while (len > 0) {
                if (nrun >= V3_RUNS) { *overflow = 1; return; }
                int l = len > 255 ? 255 : len;
                d.sf_len[nrun] = (uint8_t)l;
                d.sf_val[nrun] = val;
                ++nrun;
                len -= l;
            }
        };
        int wlen = short_win ? 128 : 1024;
        int wbase = 0;
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int w = 0; w < ii.group_lens[g]; ++w) {
                int off = short_win ? (wbase + w) * 128 : 0;
                for (int s = 0; s < ii.max_sfb; ++s) {
                    int cb = ics.band_type[g][s];
                    int lo = ii.swb[s], hi = ii.swb[s + 1];
                    if (cb == 0 || cb == 14 || cb == 15) {
                        emit(hi - lo, 0);
                        continue;
                    }
                    uint8_t sfv = (uint8_t)std::max(ics.band_sf[g][s], 0);
                    emit(hi - lo, sfv);
                    if (cb == 13) {
                        // PNS sign noise straight onto the i8 quant wire
                        for (int k = lo; k < hi; ++k) {
                            pns_state = pns_state * 1664525u + 1013904223u;
                            d.quant[off + k] = (pns_state >> 16) & 1 ? 1 : -1;
                        }
                    }
                }
                int covered = ii.max_sfb > 0 ? ii.swb[ii.max_sfb] : 0;
                emit(wlen - covered, 0);
            }
            wbase += ii.group_lens[g];
        }
        memset(d.sf_len + nrun, 0, (size_t)(V3_RUNS - nrun));
        memset(d.sf_val + nrun, 0, (size_t)(V3_RUNS - nrun));

        // tns: regions + raw reflection indices (device converts)
        memset(d.regions, 0, MAX_FILTERS * 3 * 2);
        memset(d.refl, 0, MAX_FILTERS * MAX_ORDER);
        memset(d.crb, 0, MAX_FILTERS);
        memset(d.order, 0, MAX_FILTERS);
        int tmax = short_win ? AAC_TNS_MAX_128[sr_index] : AAC_TNS_MAX_1024[sr_index];
        int mmax = std::min(tmax, ii.max_sfb);
        int nf = 0;
        for (int w = 0; w < ii.num_windows; ++w) {
            int bottom = ii.num_swb;
            for (int f = 0; f < ics.n_tns[w]; ++f) {
                const TnsFilt& tf = ics.tns[w][f];
                int top = bottom;
                bottom = std::max(0, top - tf.length);
                int order = std::min(tf.order, MAX_ORDER);
                if (!order || nf >= MAX_FILTERS) continue;
                int start = ii.swb[std::min(bottom, mmax)];
                int end = ii.swb[std::min(top, mmax)];
                if (end - start <= 0) continue;
                int off = short_win ? w * 128 : 0;
                for (int i = 0; i < order; ++i)
                    d.refl[nf * MAX_ORDER + i] = tf.raw[i];
                d.crb[nf] = (uint8_t)tf.crb;
                d.order[nf] = (uint8_t)order;
                d.regions[nf * 3 + 0] = (int16_t)(off + start);
                d.regions[nf * 3 + 1] = (int16_t)(off + end);
                d.regions[nf * 3 + 2] = (int16_t)tf.direction;
                ++nf;
            }
        }
    }

    // run-length accumulator for the pair-level MS/intensity table,
    // merging adjacent equal (ms,pos,sign) triples
    struct MsisRuns {
        const V3Dest& d;
        int n = 0;
        int cur_len = 0;
        uint8_t cms = 0;
        int8_t cpos = 0, csgn = 0;
        bool any = false;

        explicit MsisRuns(const V3Dest& dd) : d(dd) {}

        void flush() {
            while (cur_len > 0) {
                if (n >= V3_RUNS) { *d.overflow = 1; cur_len = 0; return; }
                int l = cur_len > 255 ? 255 : cur_len;
                d.msis_len[n] = (uint8_t)l;
                d.msis_ms[n] = cms;
                d.msis_pos[n] = cpos;
                d.msis_sign[n] = csgn;
                ++n;
                cur_len -= l;
            }
        }

        void push(int len, uint8_t ms, int8_t pos, int8_t sgn) {
            if (len <= 0) return;
            if (any && ms == cms && pos == cpos && sgn == csgn) {
                cur_len += len;
                return;
            }
            flush();
            cur_len = len; cms = ms; cpos = pos; csgn = sgn; any = true;
        }

        void done() {
            flush();
            memset(d.msis_len + n, 0, (size_t)(V3_RUNS - n));
            memset(d.msis_ms + n, 0, (size_t)(V3_RUNS - n));
            memset(d.msis_pos + n, 0, (size_t)(V3_RUNS - n));
            memset(d.msis_sign + n, 0, (size_t)(V3_RUNS - n));
        }
    };

    // ---- v4 wire: raw AU + section program; the spectral Huffman
    // decode happens ON DEVICE (ops/aac_entropy.py).  The host parses
    // syntax up to spectral_data, walks the spectral bits length-only
    // to reach the next element, and emits per channel: the bit offset
    // where spectral_data starts plus packed (codebook, n_codewords,
    // out_line) runs in decode order.  Falls back (overflow=1) for
    // content the raw wire cannot express: PNS bands, pulses, more
    // than V4_RUNS band runs, AUs larger than V4_AU_CAP. ----

    static constexpr int V4_RUNS = 128;
    static constexpr int V4_PNS = 16;
    static constexpr int V4_AU_CAP = 1024;

    struct V4LaneDest {
        uint8_t* sf_len;    // [V3_RUNS]
        uint8_t* sf_val;    // [V3_RUNS]
        int16_t* regions;   // [MAX_FILTERS*3]
        int8_t* refl;       // [MAX_FILTERS*MAX_ORDER]
        uint8_t* crb;       // [MAX_FILTERS]
        uint8_t* order;     // [MAX_FILTERS]
        uint32_t* runs;     // [V4_RUNS]: cb | ncw<<4 | out<<10
        uint8_t* n_runs;    // [1]
        uint16_t* spec_bit; // [1]
        uint32_t* pns;      // [V4_PNS]: start | nlines<<12 (0 = unused)
    };

    struct V4Dest {
        V4LaneDest ch[2];
        uint8_t* msis_len;  // [V3_RUNS]
        uint8_t* msis_ms;   // [V3_RUNS]
        int8_t* msis_pos;   // [V3_RUNS]
        int8_t* msis_sign;  // [V3_RUNS]
        uint8_t* seq;       // [2]
        uint8_t* shape;     // [2]
        uint8_t* valid;     // [2]
        int32_t* overflow;
    };

    static void zero_lane_v4(const V4LaneDest& d) {
        memset(d.sf_len, 0, V3_RUNS);
        memset(d.sf_val, 0, V3_RUNS);
        memset(d.regions, 0, MAX_FILTERS * 3 * 2);
        memset(d.refl, 0, MAX_FILTERS * MAX_ORDER);
        memset(d.crb, 0, MAX_FILTERS);
        memset(d.order, 0, MAX_FILTERS);
        memset(d.runs, 0, V4_RUNS * 4);
        memset(d.pns, 0, V4_PNS * 4);
        d.n_runs[0] = 0;
        d.spec_bit[0] = 0;
    }

    static void zero_v4(const V4Dest& d) {
        zero_lane_v4(d.ch[0]);
        zero_lane_v4(d.ch[1]);
        memset(d.msis_len, 0, V3_RUNS);
        memset(d.msis_ms, 0, V3_RUNS);
        memset(d.msis_pos, 0, V3_RUNS);
        memset(d.msis_sign, 0, V3_RUNS);
        d.seq[0] = d.seq[1] = 0;
        d.shape[0] = d.shape[1] = 0;
        d.valid[0] = d.valid[1] = 0;
    }

    void fill_lane_v4(const IcsData& ics, const V4LaneDest& d,
                      int32_t* overflow) {
        const IcsInfo& ii = ics.info;
        bool short_win = ii.window_sequence == 2;

        if (ics.had_pulse) *overflow = 1;
        if (ics.spectral_bit_start < 0 || ics.spectral_bit_start > 0xFFFF)
            *overflow = 1;
        d.spec_bit[0] = (uint16_t)std::max(ics.spectral_bit_start, 0);

        // section program in decode order (g, s, w)
        int nr = 0;
        int wbase_g[8];
        int acc = 0;
        for (int g = 0; g < ii.num_window_groups; ++g) {
            wbase_g[g] = acc;
            acc += ii.group_lens[g];
        }
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int s = 0; s < ii.max_sfb; ++s) {
                int cb = ics.band_type[g][s];
                if (cb == 0 || cb >= 13) continue;
                int lo = ii.swb[s], hi = ii.swb[s + 1];
                int dim = cb < 5 ? 4 : 2;
                uint32_t ncw = (uint32_t)((hi - lo + dim - 1) / dim);
                for (int w = 0; w < ii.group_lens[g]; ++w) {
                    uint32_t out =
                        (uint32_t)((short_win ? (wbase_g[g] + w) * 128 : 0) + lo);
                    if (nr >= V4_RUNS) { *overflow = 1; break; }
                    d.runs[nr++] = (uint32_t)cb | (ncw << 4) | (out << 10);
                }
            }
        }
        d.n_runs[0] = (uint8_t)nr;
        memset(d.runs + nr, 0, (size_t)(V4_RUNS - nr) * 4);

        // PNS bands: noise positions for the device-side sign fill
        // (energies ride the line_sf runs; the device draws the +-1
        // signs — spec-conformant noise, not bit-identical to the v3
        // host LCG)
        int np_ = 0;
        memset(d.pns, 0, V4_PNS * 4);
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int s = 0; s < ii.max_sfb; ++s) {
                if (ics.band_type[g][s] != 13) continue;
                int lo = ii.swb[s], hi = ii.swb[s + 1];
                for (int w = 0; w < ii.group_lens[g]; ++w) {
                    uint32_t out =
                        (uint32_t)((short_win ? (wbase_g[g] + w) * 128 : 0) + lo);
                    if (np_ >= V4_PNS) { *overflow = 1; break; }
                    d.pns[np_++] = out | ((uint32_t)(hi - lo) << 12);
                }
            }
        }

        // scalefactor runs + TNS: identical semantics to the v3 lane
        int nrun = 0;
        auto emit = [&](int len, uint8_t val) {
            while (len > 0) {
                if (nrun >= V3_RUNS) { *overflow = 1; return; }
                int l = len > 255 ? 255 : len;
                d.sf_len[nrun] = (uint8_t)l;
                d.sf_val[nrun] = val;
                ++nrun;
                len -= l;
            }
        };
        int wlen = short_win ? 128 : 1024;
        int wbase = 0;
        for (int g = 0; g < ii.num_window_groups; ++g) {
            for (int w = 0; w < ii.group_lens[g]; ++w) {
                for (int s = 0; s < ii.max_sfb; ++s) {
                    int cb = ics.band_type[g][s];
                    int lo = ii.swb[s], hi = ii.swb[s + 1];
                    if (cb == 0 || cb == 14 || cb == 15) {
                        emit(hi - lo, 0);
                        continue;
                    }
                    uint8_t sfv = (uint8_t)std::max(ics.band_sf[g][s], 0);
                    emit(hi - lo, sfv);
                }
                int covered = ii.max_sfb > 0 ? ii.swb[ii.max_sfb] : 0;
                emit(wlen - covered, 0);
            }
            wbase += ii.group_lens[g];
        }
        memset(d.sf_len + nrun, 0, (size_t)(V3_RUNS - nrun));
        memset(d.sf_val + nrun, 0, (size_t)(V3_RUNS - nrun));

        memset(d.regions, 0, MAX_FILTERS * 3 * 2);
        memset(d.refl, 0, MAX_FILTERS * MAX_ORDER);
        memset(d.crb, 0, MAX_FILTERS);
        memset(d.order, 0, MAX_FILTERS);
        int tmax = short_win ? AAC_TNS_MAX_128[sr_index] : AAC_TNS_MAX_1024[sr_index];
        int mmax = std::min(tmax, ii.max_sfb);
        int nf = 0;
        for (int w = 0; w < ii.num_windows; ++w) {
            int bottom = ii.num_swb;
            for (int f = 0; f < ics.n_tns[w]; ++f) {
                const TnsFilt& tf = ics.tns[w][f];
                int top = bottom;
                bottom = std::max(0, top - tf.length);
                int order = std::min(tf.order, MAX_ORDER);
                if (!order || nf >= MAX_FILTERS) continue;
                int start = ii.swb[std::min(bottom, mmax)];
                int end = ii.swb[std::min(top, mmax)];
                if (end - start <= 0) continue;
                int off = short_win ? w * 128 : 0;
                for (int i = 0; i < order; ++i)
                    d.refl[nf * MAX_ORDER + i] = tf.raw[i];
                d.crb[nf] = (uint8_t)tf.crb;
                d.order[nf] = (uint8_t)order;
                d.regions[nf * 3 + 0] = (int16_t)(off + start);
                d.regions[nf * 3 + 1] = (int16_t)(off + end);
                d.regions[nf * 3 + 2] = (int16_t)tf.direction;
                ++nf;
            }
        }
    }

    bool parse_au_v4(const uint8_t* au, long len, const V4Dest& d) {
        g_tables.init();
        BitReader br(au, len);
        *d.overflow = 0;
        if (len > V4_AU_CAP) *d.overflow = 1;

        while (br.left() >= 3) {
            int ide = (int)br.get(3);
            if (ide == 7) break;
            if (ide == 0 || ide == 3) {  // SCE / LFE
                br.get(4);
                IcsData ics;
                double is_scale[8 * 64];
                int is_sign[8 * 64];
                int is_ipos[8 * 64];
                if (!decode_ics(br, false, nullptr, ics, is_scale, is_sign,
                                is_ipos, /*full=*/false, /*skip_spec=*/true))
                    return false;
                fill_lane_v4(ics, d.ch[0], d.overflow);
                zero_lane_v4(d.ch[1]);
                memset(d.msis_len, 0, V3_RUNS);
                memset(d.msis_ms, 0, V3_RUNS);
                memset(d.msis_pos, 0, V3_RUNS);
                memset(d.msis_sign, 0, V3_RUNS);
                d.seq[0] = (uint8_t)ics.info.window_sequence;
                d.shape[0] = (uint8_t)ics.info.window_shape;
                d.seq[1] = d.shape[1] = 0;
                d.valid[0] = 1;
                d.valid[1] = 0;
                return true;
            }
            if (ide == 1) {  // CPE
                br.get(4);
                int common = (int)br.get(1);
                IcsInfo shared;
                uint8_t ms_band[8][64];
                memset(ms_band, 0, sizeof ms_band);
                int ms_present = 0;
                if (common) {
                    if (!decode_ics_info(br, shared)) return false;
                    ms_present = (int)br.get(2);
                    if (ms_present == 1) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = (uint8_t)br.get(1);
                    } else if (ms_present == 2) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = 1;
                    } else if (ms_present == 3) {
                        return fail("reserved ms_mask_present");
                    }
                }
                IcsData ics0, ics1;
                double is_sc0[8 * 64], is_sc1[8 * 64];
                int is_sg0[8 * 64], is_sg1[8 * 64];
                int is_ip0[8 * 64], is_ip1[8 * 64];
                if (!decode_ics(br, common != 0, &shared, ics0, is_sc0, is_sg0,
                                is_ip0, false, /*skip_spec=*/true) ||
                    !decode_ics(br, common != 0, &shared, ics1, is_sc1, is_sg1,
                                is_ip1, false, /*skip_spec=*/true))
                    return false;
                fill_lane_v4(ics0, d.ch[0], d.overflow);
                fill_lane_v4(ics1, d.ch[1], d.overflow);
                d.seq[0] = (uint8_t)ics0.info.window_sequence;
                d.shape[0] = (uint8_t)ics0.info.window_shape;
                d.seq[1] = (uint8_t)ics1.info.window_sequence;
                d.shape[1] = (uint8_t)ics1.info.window_shape;
                d.valid[0] = d.valid[1] = 1;

                // pair-level MS / intensity runs in line order (same
                // walk as the v3 CPE; see the common==0 note there)
                const IcsInfo& ii = ics0.info;
                bool short_win = ii.window_sequence == 2;
                int wlen2 = short_win ? 128 : 1024;
                MsisRuns4 runs(d);
                for (int g = 0; g < ii.num_window_groups; ++g) {
                    for (int w = 0; w < ii.group_lens[g]; ++w) {
                        for (int s = 0; s < ii.max_sfb; ++s) {
                            int bt1 = common ? ics1.band_type[g][s] : 0;
                            int lo = ii.swb[s], hi = ii.swb[s + 1];
                            bool is_int = bt1 == 14 || bt1 == 15;
                            if (is_int) {
                                int c = is_sg1[g * 64 + s];
                                if (ms_present && ms_band[g][s]) c = -c;
                                int ip = is_ip1[g * 64 + s];
                                int8_t ipc =
                                    (int8_t)std::max(-128, std::min(127, ip));
                                runs.push(hi - lo, 0, ipc,
                                          (int8_t)(c < 0 ? -1 : 1));
                            } else if (ms_band[g][s] &&
                                       ics0.band_type[g][s] < 13 && bt1 < 13) {
                                runs.push(hi - lo, 1, 0, 0);
                            } else {
                                runs.push(hi - lo, 0, 0, 0);
                            }
                        }
                        int covered = ii.max_sfb > 0 ? ii.swb[ii.max_sfb] : 0;
                        runs.push(wlen2 - covered, 0, 0, 0);
                    }
                }
                runs.done();
                return true;
            }
            if (ide == 4) {  // DSE
                br.get(4);
                int align = (int)br.get(1);
                int count = (int)br.get(8);
                if (count == 255) count += (int)br.get(8);
                long sk = count * 8L;
                if (align) sk += (8 - br.pos % 8) % 8;
                br.skip(sk);
            } else if (ide == 6) {  // FIL
                int count = (int)br.get(4);
                if (count == 15) count += (int)br.get(8) - 1;
                br.skip(count * 8L);
            } else {
                return fail("unsupported element");
            }
            if (br.bad) return fail("bitstream overrun");
        }
        return fail("empty access unit");
    }

    // MsisRuns over a V4Dest (same run semantics as the v3 variant)
    struct MsisRuns4 {
        const V4Dest& d;
        int n = 0;
        int cur_len = 0;
        uint8_t cms = 0;
        int8_t cpos = 0, csgn = 0;
        bool any = false;

        explicit MsisRuns4(const V4Dest& dd) : d(dd) {}

        void flush() {
            while (cur_len > 0) {
                if (n >= V3_RUNS) { *d.overflow = 1; cur_len = 0; return; }
                int l = cur_len > 255 ? 255 : cur_len;
                d.msis_len[n] = (uint8_t)l;
                d.msis_ms[n] = cms;
                d.msis_pos[n] = cpos;
                d.msis_sign[n] = csgn;
                ++n;
                cur_len -= l;
            }
        }

        void push(int len, uint8_t ms, int8_t pos, int8_t sgn) {
            if (len <= 0) return;
            if (any && ms == cms && pos == cpos && sgn == csgn) {
                cur_len += len;
                return;
            }
            flush();
            cur_len = len; cms = ms; cpos = pos; csgn = sgn; any = true;
        }

        void done() {
            flush();
            memset(d.msis_len + n, 0, (size_t)(V3_RUNS - n));
            memset(d.msis_ms + n, 0, (size_t)(V3_RUNS - n));
            memset(d.msis_pos + n, 0, (size_t)(V3_RUNS - n));
            memset(d.msis_sign + n, 0, (size_t)(V3_RUNS - n));
        }
    };

    bool parse_au_v3(const uint8_t* au, long len, const V3Dest& d) {
        g_tables.init();
        BitReader br(au, len);
        *d.overflow = 0;
        EscState esc{d.esc_idx, d.esc_val, 0};

        while (br.left() >= 3) {
            int ide = (int)br.get(3);
            if (ide == 7) break;
            if (ide == 0 || ide == 3) {  // SCE / LFE
                br.get(4);
                IcsData ics;
                double is_scale[8 * 64];
                int is_sign[8 * 64];
                int is_ipos[8 * 64];
                if (!decode_ics(br, false, nullptr, ics, is_scale, is_sign,
                                is_ipos, /*full=*/false))
                    return false;
                fill_lane_v3(ics, d.ch[0], 0, esc, d.overflow);
                zero_lane_v3(d.ch[1]);
                memset(d.msis_len, 0, V3_RUNS);
                memset(d.msis_ms, 0, V3_RUNS);
                memset(d.msis_pos, 0, V3_RUNS);
                memset(d.msis_sign, 0, V3_RUNS);
                d.seq[0] = (uint8_t)ics.info.window_sequence;
                d.shape[0] = (uint8_t)ics.info.window_shape;
                d.seq[1] = d.shape[1] = 0;
                d.valid[0] = 1;
                d.valid[1] = 0;
                for (int e = esc.n; e < V3_ESC; ++e) {
                    d.esc_idx[e] = 0xFFFF;
                    d.esc_val[e] = 0;
                }
                return true;
            }
            if (ide == 1) {  // CPE
                br.get(4);
                int common = (int)br.get(1);
                IcsInfo shared;
                uint8_t ms_band[8][64];
                memset(ms_band, 0, sizeof ms_band);
                int ms_present = 0;
                if (common) {
                    if (!decode_ics_info(br, shared)) return false;
                    ms_present = (int)br.get(2);
                    if (ms_present == 1) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = (uint8_t)br.get(1);
                    } else if (ms_present == 2) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = 1;
                    } else if (ms_present == 3) {
                        return fail("reserved ms_mask_present");
                    }
                }
                IcsData ics0, ics1;
                double is_sc0[8 * 64], is_sc1[8 * 64];
                int is_sg0[8 * 64], is_sg1[8 * 64];
                int is_ip0[8 * 64], is_ip1[8 * 64];
                if (!decode_ics(br, common != 0, &shared, ics0, is_sc0, is_sg0,
                                is_ip0, false) ||
                    !decode_ics(br, common != 0, &shared, ics1, is_sc1, is_sg1,
                                is_ip1, false))
                    return false;
                fill_lane_v3(ics0, d.ch[0], 0, esc, d.overflow);
                fill_lane_v3(ics1, d.ch[1], 1, esc, d.overflow);
                for (int e = esc.n; e < V3_ESC; ++e) {
                    d.esc_idx[e] = 0xFFFF;
                    d.esc_val[e] = 0;
                }
                d.seq[0] = (uint8_t)ics0.info.window_sequence;
                d.shape[0] = (uint8_t)ics0.info.window_shape;
                d.seq[1] = (uint8_t)ics1.info.window_sequence;
                d.shape[1] = (uint8_t)ics1.info.window_shape;
                d.valid[0] = d.valid[1] = 1;

                // pair-level MS / intensity runs in line order
                const IcsInfo& ii = ics0.info;
                bool short_win = ii.window_sequence == 2;
                int wlen = short_win ? 128 : 1024;
                MsisRuns runs(d);
                for (int g = 0; g < ii.num_window_groups; ++g) {
                    for (int w = 0; w < ii.group_lens[g]; ++w) {
                        for (int s = 0; s < ii.max_sfb; ++s) {
                            // intensity/MS need a shared ics_info (14496-3
                            // 4.6.8.2); with common==0 ics1's grouping may
                            // differ from ics0's, so reading ics1.band_type
                            // indexed by ics0's (g,s) would touch rows
                            // decode_ics never initialized
                            int bt1 = common ? ics1.band_type[g][s] : 0;
                            int lo = ii.swb[s], hi = ii.swb[s + 1];
                            bool is_int = bt1 == 14 || bt1 == 15;
                            if (is_int) {
                                int c = is_sg1[g * 64 + s];
                                if (ms_present && ms_band[g][s]) c = -c;
                                int ip = is_ip1[g * 64 + s];
                                int8_t ipc =
                                    (int8_t)std::max(-128, std::min(127, ip));
                                runs.push(hi - lo, 0, ipc,
                                          (int8_t)(c < 0 ? -1 : 1));
                            } else if (ms_band[g][s] &&
                                       ics0.band_type[g][s] < 13 && bt1 < 13) {
                                runs.push(hi - lo, 1, 0, 0);
                            } else {
                                runs.push(hi - lo, 0, 0, 0);
                            }
                        }
                        int covered = ii.max_sfb > 0 ? ii.swb[ii.max_sfb] : 0;
                        runs.push(wlen - covered, 0, 0, 0);
                    }
                }
                runs.done();
                return true;
            }
            if (ide == 4) {  // DSE
                br.get(4);
                int align = (int)br.get(1);
                int count = (int)br.get(8);
                if (count == 255) count += (int)br.get(8);
                long sk = count * 8L;
                if (align) sk += (8 - br.pos % 8) % 8;
                br.skip(sk);
            } else if (ide == 6) {  // FIL
                int count = (int)br.get(4);
                if (count == 15) count += (int)br.get(8) - 1;
                br.skip(count * 8L);
            } else {
                return fail("unsupported element");
            }
            if (br.bad) return fail("bitstream overrun");
        }
        return fail("empty access unit");
    }

    bool parse_au_compact(const uint8_t* au, long len, const CompactDest& d) {
        g_tables.init();
        BitReader br(au, len);
        memset(d.ms, 0, 1024);
        memset(d.int_pos, 0, 1024);
        memset(d.int_sign, 0, 1024);
        d.valid[0] = d.valid[1] = 0;
        d.seq[0] = d.seq[1] = 0;
        d.shape[0] = d.shape[1] = 0;

        while (br.left() >= 3) {
            int ide = (int)br.get(3);
            if (ide == 7) break;
            if (ide == 0 || ide == 3) {  // SCE / LFE
                br.get(4);
                IcsData ics;
                double is_scale[8 * 64];
                int is_sign[8 * 64];
                int is_ipos[8 * 64];
                if (!decode_ics(br, false, nullptr, ics, is_scale, is_sign,
                                is_ipos, /*full=*/false))
                    return false;
                fill_lane_compact(ics, d.ch[0], d.overflow);
                zero_lane_compact(d.ch[1]);
                d.seq[0] = ics.info.window_sequence;
                d.shape[0] = ics.info.window_shape;
                d.valid[0] = 1;
                return true;
            }
            if (ide == 1) {  // CPE
                br.get(4);
                int common = (int)br.get(1);
                IcsInfo shared;
                uint8_t ms_band[8][64];
                memset(ms_band, 0, sizeof ms_band);
                int ms_present = 0;
                if (common) {
                    if (!decode_ics_info(br, shared)) return false;
                    ms_present = (int)br.get(2);
                    if (ms_present == 1) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = (uint8_t)br.get(1);
                    } else if (ms_present == 2) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = 1;
                    } else if (ms_present == 3) {
                        return fail("reserved ms_mask_present");
                    }
                }
                IcsData ics0, ics1;
                double is_sc0[8 * 64], is_sc1[8 * 64];
                int is_sg0[8 * 64], is_sg1[8 * 64];
                int is_ip0[8 * 64], is_ip1[8 * 64];
                if (!decode_ics(br, common != 0, &shared, ics0, is_sc0, is_sg0,
                                is_ip0, false) ||
                    !decode_ics(br, common != 0, &shared, ics1, is_sc1, is_sg1,
                                is_ip1, false))
                    return false;
                fill_lane_compact(ics0, d.ch[0], d.overflow);
                fill_lane_compact(ics1, d.ch[1], d.overflow);
                d.seq[0] = ics0.info.window_sequence;
                d.shape[0] = ics0.info.window_shape;
                d.seq[1] = ics1.info.window_sequence;
                d.shape[1] = ics1.info.window_shape;
                d.valid[0] = d.valid[1] = 1;

                const IcsInfo& ii = ics0.info;
                bool short_win = ii.window_sequence == 2;
                int wbase = 0;
                for (int g = 0; g < ii.num_window_groups; ++g) {
                    for (int s = 0; s < ii.max_sfb; ++s) {
                        // common==0: skip pair tools (see v3 CPE note)
                        int bt1 = common ? ics1.band_type[g][s] : 0;
                        int lo = ii.swb[s], hi = ii.swb[s + 1];
                        bool is_int = bt1 == 14 || bt1 == 15;
                        for (int w = 0; w < ii.group_lens[g]; ++w) {
                            int off = short_win ? (wbase + w) * 128 : 0;
                            if (is_int) {
                                int c = is_sg1[g * 64 + s];
                                if (ms_present && ms_band[g][s]) c = -c;
                                int ip = is_ip1[g * 64 + s];
                                int8_t ipc =
                                    (int8_t)std::max(-128, std::min(127, ip));
                                int8_t sgn = (int8_t)(c < 0 ? -1 : 1);
                                for (int k = lo; k < hi; ++k) {
                                    d.int_pos[off + k] = ipc;
                                    d.int_sign[off + k] = sgn;
                                }
                            } else if (ms_band[g][s] &&
                                       ics0.band_type[g][s] < 13 && bt1 < 13) {
                                memset(d.ms + off + lo, 1, (size_t)(hi - lo));
                            }
                        }
                    }
                    wbase += ii.group_lens[g];
                }
                return true;
            }
            if (ide == 4) {  // DSE
                br.get(4);
                int align = (int)br.get(1);
                int count = (int)br.get(8);
                if (count == 255) count += (int)br.get(8);
                long sk = count * 8L;
                if (align) sk += (8 - br.pos % 8) % 8;
                br.skip(sk);
            } else if (ide == 6) {  // FIL
                int count = (int)br.get(4);
                if (count == 15) count += (int)br.get(8) - 1;
                br.skip(count * 8L);
            } else {
                return fail("unsupported element");
            }
            if (br.bad) return fail("bitstream overrun");
        }
        return fail("empty access unit");
    }

    bool parse_au(const uint8_t* au, long len, FrameOut& out, bool full = true) {
        g_tables.init();
        BitReader br(au, len);
        memset(out.ms_mask, 0, sizeof out.ms_mask);
        if (full) memset(out.int_factor, 0, sizeof out.int_factor);
        out.ch[0].valid = out.ch[1].valid = 0;
        out.n_channels = 0;
        out.error[0] = 0;

        while (br.left() >= 3) {
            int ide = (int)br.get(3);
            if (ide == 7) break;
            if (ide == 0 || ide == 3) {  // SCE / LFE
                br.get(4);
                IcsData ics;
                // intensity arrays are written before any read (every
                // cb 14/15 band is filled in the scalefactor pass), so
                // no 12KB stack zeroing on the per-AU hot path
                double is_scale[8 * 64];
                int is_sign[8 * 64];
                int is_ipos[8 * 64];
                if (!decode_ics(br, false, nullptr, ics, is_scale, is_sign, is_ipos, full)) {
                    snprintf(out.error, sizeof out.error, "%s", error);
                    return false;
                }
                fill_lane(ics, out.ch[0], out.line_sf[0], out.regions[0], full);
                memset(out.int_pos, 0, sizeof out.int_pos);
                memset(out.int_sign, 0, sizeof out.int_sign);
                out.n_channels = 1;
                out.element_kind = ide;
                return true;  // single-track decode: first element
            }
            if (ide == 1) {  // CPE
                br.get(4);
                int common = (int)br.get(1);
                IcsInfo shared;
                uint8_t ms_band[8][64];
                memset(ms_band, 0, sizeof ms_band);
                int ms_present = 0;
                if (common) {
                    if (!decode_ics_info(br, shared)) {
                        snprintf(out.error, sizeof out.error, "%s", error);
                        return false;
                    }
                    ms_present = (int)br.get(2);
                    if (ms_present == 1) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = (uint8_t)br.get(1);
                    } else if (ms_present == 2) {
                        for (int g = 0; g < shared.num_window_groups; ++g)
                            for (int s = 0; s < shared.max_sfb; ++s)
                                ms_band[g][s] = 1;
                    } else if (ms_present == 3) {
                        snprintf(out.error, sizeof out.error, "reserved ms_mask_present");
                        return false;
                    }
                }
                IcsData ics0, ics1;
                // written-before-read (see SCE note): no stack zeroing
                double is_sc0[8 * 64], is_sc1[8 * 64];
                int is_sg0[8 * 64], is_sg1[8 * 64];
                int is_ip0[8 * 64], is_ip1[8 * 64];
                if (!decode_ics(br, common != 0, &shared, ics0, is_sc0, is_sg0, is_ip0, full) ||
                    !decode_ics(br, common != 0, &shared, ics1, is_sc1, is_sg1, is_ip1, full)) {
                    snprintf(out.error, sizeof out.error, "%s", error);
                    return false;
                }
                fill_lane(ics0, out.ch[0], out.line_sf[0], out.regions[0], full);
                fill_lane(ics1, out.ch[1], out.line_sf[1], out.regions[1], full);
                memset(out.int_pos, 0, sizeof out.int_pos);
                memset(out.int_sign, 0, sizeof out.int_sign);
                out.n_channels = 2;
                out.element_kind = 1;

                // ms/intensity line masks
                const IcsInfo& ii = ics0.info;
                bool short_win = ii.window_sequence == 2;
                int wbase = 0;
                for (int g = 0; g < ii.num_window_groups; ++g) {
                    for (int s = 0; s < ii.max_sfb; ++s) {
                        // common==0: skip pair tools (see v3 CPE note)
                        int bt1 = common ? ics1.band_type[g][s] : 0;
                        int lo = ii.swb[s], hi = ii.swb[s + 1];
                        bool is_int = bt1 == 14 || bt1 == 15;
                        for (int w = 0; w < ii.group_lens[g]; ++w) {
                            int off = short_win ? (wbase + w) * 128 : 0;
                            if (is_int) {
                                double c = is_sg1[g * 64 + s];
                                if (ms_present && ms_band[g][s]) c = -c;
                                int ip = is_ip1[g * 64 + s];
                                for (int k = lo; k < hi; ++k) {
                                    if (full)
                                        out.int_factor[off + k] =
                                            (float)(c * is_sc1[g * 64 + s]);
                                    out.int_pos[off + k] =
                                        (int8_t)std::max(-128, std::min(127, ip));
                                    out.int_sign[off + k] = (int8_t)(c < 0 ? -1 : 1);
                                }
                            } else if (ms_band[g][s] &&
                                       ics0.band_type[g][s] < 13 && bt1 < 13) {
                                for (int k = lo; k < hi; ++k)
                                    out.ms_mask[off + k] = 1;
                            }
                        }
                    }
                    wbase += ii.group_lens[g];
                }
                return true;
            }
            if (ide == 4) {  // DSE
                br.get(4);
                int align = (int)br.get(1);
                int count = (int)br.get(8);
                if (count == 255) count += (int)br.get(8);
                long sk = count * 8L;
                if (align) sk += (8 - br.pos % 8) % 8;
                br.skip(sk);
            } else if (ide == 6) {  // FIL
                int count = (int)br.get(4);
                if (count == 15) count += (int)br.get(8) - 1;
                br.skip(count * 8L);
            } else {
                snprintf(out.error, sizeof out.error, "unsupported element %d", ide);
                return false;
            }
            if (br.bad) {
                snprintf(out.error, sizeof out.error, "bitstream overrun");
                return false;
            }
        }
        snprintf(out.error, sizeof out.error, "empty access unit");
        return false;
    }
};

}  // namespace

extern "C" {

void* skt_aac_new(int sr_index) {
    auto* p = new Parser();
    p->sr_index = sr_index;
    return p;
}

void skt_aac_free(void* h) { delete (Parser*)h; }

// out buffers are provided by the caller (numpy arrays):
//   quant   int32 [2,1024]     scale f32 [2,1024]
//   perm    int32 [2,1024]     filt  int32 [2,1024]
//   lpc     f32   [2,8,20]     meta  int32 [8]: seq0,shape0,valid0,
//                                          seq1,shape1,valid1,nch,kind
//   ms      uint8 [1024]       intf  f32 [1024]
// returns 0 on success, -1 on parse error (see skt_aac_error)
int skt_aac_parse_au(void* h, const uint8_t* au, long len,
                     int32_t* quant, float* scale, int32_t* perm,
                     int32_t* filt, float* lpc, int32_t* meta,
                     uint8_t* ms, float* intf) {
    auto* p = (Parser*)h;
    static thread_local FrameOut out;
    if (!p->parse_au(au, len, out)) {
        snprintf(p->error, sizeof p->error, "%s", out.error);
        return -1;
    }
    for (int c = 0; c < 2; ++c) {
        const LaneOut& l = out.ch[c];
        if (c < out.n_channels) {
            memcpy(quant + c * 1024, l.quant, 1024 * 4);
            memcpy(scale + c * 1024, l.scale, 1024 * 4);
            memcpy(perm + c * 1024, l.perm, 1024 * 4);
            memcpy(filt + c * 1024, l.filt_id, 1024 * 4);
            memcpy(lpc + c * MAX_FILTERS * MAX_ORDER, l.lpc,
                   MAX_FILTERS * MAX_ORDER * 4);
            meta[c * 3 + 0] = l.seq;
            meta[c * 3 + 1] = l.shape;
            meta[c * 3 + 2] = 1;
        } else {
            memset(quant + c * 1024, 0, 1024 * 4);
            memset(scale + c * 1024, 0, 1024 * 4);
            for (int i = 0; i < 1024; ++i) perm[c * 1024 + i] = i;
            for (int i = 0; i < 1024; ++i) filt[c * 1024 + i] = -1;
            memset(lpc + c * MAX_FILTERS * MAX_ORDER, 0, MAX_FILTERS * MAX_ORDER * 4);
            meta[c * 3 + 0] = 0;
            meta[c * 3 + 1] = 0;
            meta[c * 3 + 2] = 0;
        }
    }
    meta[6] = out.n_channels;
    meta[7] = out.element_kind;
    memcpy(ms, out.ms_mask, 1024);
    memcpy(intf, out.int_factor, 1024 * 4);
    return 0;
}

const char* skt_aac_error(void* h) { return ((Parser*)h)->error; }

}  // extern "C"

extern "C" {

// Batched: parse B AUs (concatenated in `au_data` with per-lane
// offsets/lengths; len<0 = silent lane) straight into [B,...] arrays.
// Returns number of failed lanes (their valid flags stay 0).
int skt_aac_parse_batch(void* h, const uint8_t* au_data,
                        const int64_t* offsets, const int64_t* lens, int B,
                        int32_t* quant, float* scale, int32_t* perm,
                        int32_t* filt, float* lpc, int32_t* seq,
                        int32_t* shape, uint8_t* chan_valid,
                        uint8_t* ms, float* intf) {
    auto* p = (Parser*)h;
    int failures = 0;
    static thread_local FrameOut out;
    for (int b = 0; b < B; ++b) {
        int32_t* q = quant + (long)b * 2 * 1024;
        float* sc = scale + (long)b * 2 * 1024;
        int32_t* pm = perm + (long)b * 2 * 1024;
        int32_t* ft = filt + (long)b * 2 * 1024;
        float* lp = lpc + (long)b * 2 * MAX_FILTERS * MAX_ORDER;
        uint8_t* msk = ms + (long)b * 1024;
        float* inf = intf + (long)b * 1024;
        // Skip silent lanes BEFORE writing defaults: callers may issue
        // one parse call per sample-rate subgroup into the same output
        // arrays (mixed-rate lane groups), so untouched lanes must stay
        // untouched. Python's empty_frame_batch pre-fills the defaults.
        if (lens[b] < 0) continue;

        // defaults (also the failure state for unparseable lanes)
        memset(q, 0, 2 * 1024 * 4);
        memset(sc, 0, 2 * 1024 * 4);
        for (int c = 0; c < 2; ++c)
            for (int i = 0; i < 1024; ++i) pm[c * 1024 + i] = i;
        for (int i = 0; i < 2 * 1024; ++i) ft[i] = -1;
        memset(lp, 0, 2 * MAX_FILTERS * MAX_ORDER * 4);
        memset(msk, 0, 1024);
        memset(inf, 0, 1024 * 4);
        seq[b * 2] = seq[b * 2 + 1] = 0;
        shape[b * 2] = shape[b * 2 + 1] = 0;
        chan_valid[b * 2] = chan_valid[b * 2 + 1] = 0;
        if (!p->parse_au(au_data + offsets[b], lens[b], out)) {
            ++failures;
            continue;
        }
        for (int c = 0; c < out.n_channels && c < 2; ++c) {
            const LaneOut& l = out.ch[c];
            memcpy(q + c * 1024, l.quant, 1024 * 4);
            memcpy(sc + c * 1024, l.scale, 1024 * 4);
            memcpy(pm + c * 1024, l.perm, 1024 * 4);
            memcpy(ft + c * 1024, l.filt_id, 1024 * 4);
            memcpy(lp + c * MAX_FILTERS * MAX_ORDER, l.lpc, MAX_FILTERS * MAX_ORDER * 4);
            seq[b * 2 + c] = l.seq;
            shape[b * 2 + c] = l.shape;
            chan_valid[b * 2 + c] = 1;
        }
        memcpy(msk, out.ms_mask, 1024);
        memcpy(inf, out.int_factor, 1024 * 4);
    }
    return failures;
}

}  // extern "C"

namespace {

struct CompactOutputs {
    int16_t* quant;
    uint8_t* line_sf;
    int8_t* int_pos;
    int8_t* int_sign;
    uint8_t* ms;
    int16_t* regions;
    float* lpc;
    int32_t* seq;
    int32_t* shape;
    uint8_t* chan_valid;
    int32_t* overflow;
};

// one lane parsed directly into the packed wire; on failure the lane
// is reset to silent defaults.  Returns false on failure.
inline bool compact_lane(Parser* p, const uint8_t* au, long len, long b,
                         const CompactOutputs& o) {
    Parser::CompactDest d;
    for (int c = 0; c < 2; ++c) {
        d.ch[c].quant = o.quant + (b * 2 + c) * 1024;
        d.ch[c].line_sf = o.line_sf + (b * 2 + c) * 1024;
        d.ch[c].regions = o.regions + (b * 2 + c) * MAX_FILTERS * 3;
        d.ch[c].lpc = o.lpc + (b * 2 + c) * MAX_FILTERS * MAX_ORDER;
    }
    d.int_pos = o.int_pos + b * 1024;
    d.int_sign = o.int_sign + b * 1024;
    d.ms = o.ms + b * 1024;
    d.seq = o.seq + b * 2;
    d.shape = o.shape + b * 2;
    d.valid = o.chan_valid + b * 2;
    d.overflow = o.overflow;
    if (p->parse_au_compact(au, len, d)) return true;
    Parser::zero_lane_compact(d.ch[0]);
    Parser::zero_lane_compact(d.ch[1]);
    memset(d.int_pos, 0, 1024);
    memset(d.int_sign, 0, 1024);
    memset(d.ms, 0, 1024);
    d.seq[0] = d.seq[1] = 0;
    d.shape[0] = d.shape[1] = 0;
    d.valid[0] = d.valid[1] = 0;
    return false;
}

}  // namespace

extern "C" {

// Compact-wire batched parse: int16 quant, u8 line_sf, i8 intensity
// pos/sign, i16 tns regions.  Returns failures count; sets *overflow
// if any |quant| > 32767 occurred (caller should retry via the full
// int32 path for that batch).
int skt_aac_parse_batch_compact(void* h, const uint8_t* au_data,
                                const int64_t* offsets, const int64_t* lens, int B,
                                int16_t* quant, uint8_t* line_sf,
                                int8_t* int_pos, int8_t* int_sign,
                                uint8_t* ms, int16_t* regions, float* lpc,
                                int32_t* seq, int32_t* shape,
                                uint8_t* chan_valid, int32_t* overflow) {
    auto* p = (Parser*)h;
    int failures = 0;
    *overflow = 0;
    CompactOutputs o{quant, line_sf, int_pos, int_sign, ms,
                     regions, lpc, seq, shape, chan_valid, overflow};
    for (int b = 0; b < B; ++b) {
        // Skip silent lanes entirely (callers pre-zero the wire and may
        // compose one call per sample-rate subgroup into it — writing
        // defaults here would clobber other subgroups' lanes).
        if (lens[b] < 0) continue;
        if (!compact_lane(p, au_data + offsets[b], lens[b], b, o)) ++failures;
    }
    return failures;
}

// Pointer-array variant: aus[b] points at lane b's AU bytes (NULL =
// silent lane), so the caller skips assembling a concatenated blob.
// nthreads > 1 slices the lanes across worker threads, each with its
// own Parser clone (per-lane outputs are disjoint; *overflow is
// or-accumulated after join).  Intended for multi-core hosts; on a
// single core pass nthreads=1 for the inline path.
int skt_aac_parse_batch_compact_ptrs(void* h, const uint8_t* const* aus,
                                     const int64_t* lens, int B, int nthreads,
                                     int16_t* quant, uint8_t* line_sf,
                                     int8_t* int_pos, int8_t* int_sign,
                                     uint8_t* ms, int16_t* regions, float* lpc,
                                     int32_t* seq, int32_t* shape,
                                     uint8_t* chan_valid, int32_t* overflow) {
    auto* p = (Parser*)h;
    *overflow = 0;
    CompactOutputs o{quant, line_sf, int_pos, int_sign, ms,
                     regions, lpc, seq, shape, chan_valid, overflow};
    if (nthreads <= 1) {
        int failures = 0;
        for (int b = 0; b < B; ++b) {
            if (!aus[b] || lens[b] < 0) continue;
            if (!compact_lane(p, aus[b], lens[b], b, o)) ++failures;
        }
        return failures;
    }
    g_tables.init();  // once, before workers race on it
    if (nthreads > B) nthreads = B;
    std::vector<std::thread> workers;
    std::vector<int> fails((size_t)nthreads, 0);
    std::vector<int32_t> ovfs((size_t)nthreads, 0);
    for (int t = 0; t < nthreads; ++t) {
        workers.emplace_back([&, t]() {
            Parser w;
            w.sr_index = p->sr_index;
            w.pns_state = 0x12345678u ^ (uint32_t)(t * 2654435761u);
            CompactOutputs ot = o;
            ot.overflow = &ovfs[t];
            for (int b = t; b < B; b += nthreads) {
                if (!aus[b] || lens[b] < 0) continue;
                if (!compact_lane(&w, aus[b], lens[b], b, ot)) ++fails[t];
            }
        });
    }
    int failures = 0;
    for (int t = 0; t < nthreads; ++t) {
        workers[t].join();
        failures += fails[t];
        *overflow |= ovfs[t];
    }
    return failures;
}

}  // extern "C"

namespace {

struct V3Outputs {
    uint16_t* esc_idx;  // [B,32]
    int16_t* esc_val;   // [B,32]
    int16_t* regions;   // [B,2,8,3]
    int8_t* quant;      // [B,2,1024]
    uint8_t* sf_len;    // [B,2,128]
    uint8_t* sf_val;    // [B,2,128]
    uint8_t* msis_len;  // [B,128]
    uint8_t* msis_ms;   // [B,128]
    int8_t* msis_pos;   // [B,128]
    int8_t* msis_sign;  // [B,128]
    int8_t* refl;       // [B,2,8,20]
    uint8_t* crb;       // [B,2,8]
    uint8_t* order;     // [B,2,8]
    uint8_t* seq;       // [B,2]
    uint8_t* shape;     // [B,2]
    uint8_t* chan_valid;// [B,2]
};

inline bool v3_lane(Parser* p, const uint8_t* au, long len, long b,
                    const V3Outputs& o, int32_t* overflow) {
    constexpr int R = Parser::V3_RUNS;
    constexpr int E = Parser::V3_ESC;
    Parser::V3Dest d;
    for (int c = 0; c < 2; ++c) {
        d.ch[c].quant = o.quant + (b * 2 + c) * 1024;
        d.ch[c].sf_len = o.sf_len + (b * 2 + c) * R;
        d.ch[c].sf_val = o.sf_val + (b * 2 + c) * R;
        d.ch[c].regions = o.regions + (b * 2 + c) * MAX_FILTERS * 3;
        d.ch[c].refl = o.refl + (b * 2 + c) * MAX_FILTERS * MAX_ORDER;
        d.ch[c].crb = o.crb + (b * 2 + c) * MAX_FILTERS;
        d.ch[c].order = o.order + (b * 2 + c) * MAX_FILTERS;
    }
    d.esc_idx = o.esc_idx + b * E;
    d.esc_val = o.esc_val + b * E;
    d.msis_len = o.msis_len + b * R;
    d.msis_ms = o.msis_ms + b * R;
    d.msis_pos = o.msis_pos + b * R;
    d.msis_sign = o.msis_sign + b * R;
    d.seq = o.seq + b * 2;
    d.shape = o.shape + b * 2;
    d.valid = o.chan_valid + b * 2;
    int32_t ovf = 0;
    d.overflow = &ovf;
    bool ok = p->parse_au_v3(au, len, d);
    if (!ok || ovf) Parser::zero_v3(d);
    *overflow |= ovf;
    return ok;
}

}  // namespace

extern "C" {

// v3-wire batched parse (pointer-array lanes, optional worker
// threads).  Per-lane failures zero that lane; *overflow is set when
// any lane exceeded the i8+escape quant budget or the run tables (the
// lane is zeroed and the caller should re-parse that batch through
// the compact/full path).  Returns the failed-lane count.
int skt_aac_parse_batch_v3_ptrs(void* h, const uint8_t* const* aus,
                                const int64_t* lens, int B, int nthreads,
                                uint16_t* esc_idx, int16_t* esc_val,
                                int16_t* regions, int8_t* quant,
                                uint8_t* sf_len, uint8_t* sf_val,
                                uint8_t* msis_len, uint8_t* msis_ms,
                                int8_t* msis_pos, int8_t* msis_sign,
                                int8_t* refl, uint8_t* crb, uint8_t* order,
                                uint8_t* seq, uint8_t* shape,
                                uint8_t* chan_valid, int32_t* overflow) {
    auto* p = (Parser*)h;
    *overflow = 0;
    V3Outputs o{esc_idx, esc_val, regions, quant, sf_len, sf_val,
                msis_len, msis_ms, msis_pos, msis_sign, refl, crb, order,
                seq, shape, chan_valid};
    if (nthreads <= 1) {
        int failures = 0;
        for (int b = 0; b < B; ++b) {
            if (!aus[b] || lens[b] < 0) continue;
            if (!v3_lane(p, aus[b], lens[b], b, o, overflow)) ++failures;
        }
        return failures;
    }
    g_tables.init();  // once, before workers race on it
    if (nthreads > B) nthreads = B;
    std::vector<std::thread> workers;
    std::vector<int> fails((size_t)nthreads, 0);
    std::vector<int32_t> ovfs((size_t)nthreads, 0);
    for (int t = 0; t < nthreads; ++t) {
        workers.emplace_back([&, t]() {
            Parser w;
            w.sr_index = p->sr_index;
            w.pns_state = 0x12345678u ^ (uint32_t)(t * 2654435761u);
            for (int b = t; b < B; b += nthreads) {
                if (!aus[b] || lens[b] < 0) continue;
                if (!v3_lane(&w, aus[b], lens[b], b, o, &ovfs[t])) ++fails[t];
            }
        });
    }
    int failures = 0;
    for (int t = 0; t < nthreads; ++t) {
        workers[t].join();
        failures += fails[t];
        *overflow |= ovfs[t];
    }
    return failures;
}

// v4 raw-AU wire batched parse: syntax metadata + section program on
// the host, spectral values decoded on device from the raw AU bytes
// (copied into au_out, zero padded).  Lane layout mirrors
// ops.aac_batch.v4_wire_layout.
int skt_aac_parse_batch_v4_ptrs(void* h, const uint8_t* const* aus,
                                const int64_t* lens, int B, int nthreads,
                                int16_t* regions, uint8_t* sf_len,
                                uint8_t* sf_val, uint8_t* msis_len,
                                uint8_t* msis_ms, int8_t* msis_pos,
                                int8_t* msis_sign, int8_t* refl,
                                uint8_t* crb, uint8_t* order,
                                uint32_t* runs, uint8_t* n_runs,
                                uint16_t* spec_bit, uint8_t* pns,
                                uint8_t* seq, uint8_t* shape,
                                uint8_t* chan_valid, uint8_t* au_out,
                                int32_t* max_cw, int32_t* overflow) {
    auto* p = (Parser*)h;
    *overflow = 0;
    *max_cw = 0;
    constexpr int R = Parser::V3_RUNS;
    constexpr int VR = Parser::V4_RUNS;
    constexpr int CAP = Parser::V4_AU_CAP;

    auto lane = [&](Parser* w, long b, int32_t* ovf, int32_t* max_cw) -> bool {
        Parser::V4Dest d;
        for (int c = 0; c < 2; ++c) {
            d.ch[c].sf_len = sf_len + (b * 2 + c) * R;
            d.ch[c].sf_val = sf_val + (b * 2 + c) * R;
            d.ch[c].regions = regions + (b * 2 + c) * MAX_FILTERS * 3;
            d.ch[c].refl = refl + (b * 2 + c) * MAX_FILTERS * MAX_ORDER;
            d.ch[c].crb = crb + (b * 2 + c) * MAX_FILTERS;
            d.ch[c].order = order + (b * 2 + c) * MAX_FILTERS;
            d.ch[c].runs = runs + (b * 2 + c) * VR;
            d.ch[c].n_runs = n_runs + (b * 2 + c);
            d.ch[c].spec_bit = spec_bit + (b * 2 + c);
            d.ch[c].pns =
                (uint32_t*)(pns) + (b * 2 + c) * Parser::V4_PNS;
        }
        d.msis_len = msis_len + b * R;
        d.msis_ms = msis_ms + b * R;
        d.msis_pos = msis_pos + b * R;
        d.msis_sign = msis_sign + b * R;
        d.seq = seq + b * 2;
        d.shape = shape + b * 2;
        d.valid = chan_valid + b * 2;
        int32_t o = 0;
        d.overflow = &o;
        bool ok = w->parse_au_v4(aus[b], lens[b], d);
        long n = lens[b] < CAP ? lens[b] : CAP;
        memcpy(au_out + b * CAP, aus[b], (size_t)n);
        memset(au_out + b * CAP + n, 0, (size_t)(CAP - n));
        if (!ok || o) Parser::zero_v4(d);
        *ovf |= o;
        // total codewords across both channels' section programs (the
        // device interpreter's step budget for this lane)
        int32_t cw = 0;
        for (int c = 0; c < 2; ++c) {
            int32_t lane_cw = 0;
            int nr2 = d.ch[c].n_runs[0];
            for (int r = 0; r < nr2; ++r)
                lane_cw += (int32_t)((d.ch[c].runs[r] >> 4) & 63u);
            if (lane_cw > cw) cw = lane_cw;
        }
        if (cw > *max_cw) *max_cw = cw;
        return ok;
    };

    if (nthreads <= 1) {
        int failures = 0;
        for (int b = 0; b < B; ++b) {
            if (!aus[b] || lens[b] < 0) continue;
            if (!lane(p, b, overflow, max_cw)) ++failures;
        }
        return failures;
    }
    g_tables.init();
    if (nthreads > B) nthreads = B;
    std::vector<std::thread> workers;
    std::vector<int> fails((size_t)nthreads, 0);
    std::vector<int32_t> ovfs((size_t)nthreads, 0);
    std::vector<int32_t> maxes((size_t)nthreads, 0);
    for (int t = 0; t < nthreads; ++t) {
        workers.emplace_back([&, t]() {
            Parser w;
            w.sr_index = p->sr_index;
            for (int b = t; b < B; b += nthreads) {
                if (!aus[b] || lens[b] < 0) continue;
                if (!lane(&w, b, &ovfs[t], &maxes[t])) ++fails[t];
            }
        });
    }
    int failures = 0;
    for (int t = 0; t < nthreads; ++t) {
        workers[t].join();
        failures += fails[t];
        *overflow |= ovfs[t];
        if (maxes[t] > *max_cw) *max_cw = maxes[t];
    }
    return failures;
}

// blob+offsets variant (len<0 = untouched lane) so mixed-rate callers
// can compose one call per sample-rate subgroup into the same wire.
int skt_aac_parse_batch_v3(void* h, const uint8_t* au_data,
                           const int64_t* offsets, const int64_t* lens, int B,
                           uint16_t* esc_idx, int16_t* esc_val,
                           int16_t* regions, int8_t* quant,
                           uint8_t* sf_len, uint8_t* sf_val,
                           uint8_t* msis_len, uint8_t* msis_ms,
                           int8_t* msis_pos, int8_t* msis_sign,
                           int8_t* refl, uint8_t* crb, uint8_t* order,
                           uint8_t* seq, uint8_t* shape,
                           uint8_t* chan_valid, int32_t* overflow) {
    auto* p = (Parser*)h;
    *overflow = 0;
    V3Outputs o{esc_idx, esc_val, regions, quant, sf_len, sf_val,
                msis_len, msis_ms, msis_pos, msis_sign, refl, crb, order,
                seq, shape, chan_valid};
    int failures = 0;
    for (int b = 0; b < B; ++b) {
        if (lens[b] < 0) continue;
        if (!v3_lane(p, au_data + offsets[b], lens[b], b, o, overflow))
            ++failures;
    }
    return failures;
}

}  // extern "C"
