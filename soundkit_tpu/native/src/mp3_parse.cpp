// C++ MP3 Layer III host syntax parser.
//
// Production port of codecs/mp3_native.py (the executable spec):
// frame sync with ID3 skip, side info, bit reservoir, MPEG-1 + LSF
// scalefactors, Huffman big-values + count1, requantize exponents,
// short-block reorder — emitting per-granule compact lanes (int16
// quant, int16 quarter-exponents) for ops/mp3_batch.py.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

#include "../generated/mp3_tables.h"

namespace {

struct BitReader {
    const uint8_t* data;
    long nbytes, nbits;
    long pos = 0;
    bool bad = false;

    BitReader(const uint8_t* d, long len) : data(d), nbytes(len), nbits(len * 8) {}

    inline uint32_t window32(long p) const {
        long byte = p >> 3;
        if (byte + 8 <= nbytes) {  // hot path: one unaligned 64-bit load
            uint64_t w;
            memcpy(&w, data + byte, 8);
            w = __builtin_bswap64(w);
            return (uint32_t)(w >> (32 - (p & 7)));
        }
        uint64_t w = 0;
        for (int i = 0; i < 5; ++i) {
            uint64_t b = (byte + i) < nbytes ? data[byte + i] : 0;
            w = (w << 8) | b;
        }
        return (uint32_t)(w >> (8 - (p & 7)));
    }
    inline uint32_t get(int n) {
        if (pos + n > nbits) { bad = true; pos = nbits; return 0; }
        uint32_t v = n ? (window32(pos) >> (32 - n)) : 0;
        pos += n;
        return v;
    }
    inline uint32_t peek(int n) const { return n ? (window32(pos) >> (32 - n)) : 0; }
};

struct Vlc {  // from-lengths canonical (ff_init_vlc_from_lengths semantics)
    int max_len = 0;
    // packed (sym << 8) | len per prefix, -1 = invalid: one load per
    // decode instead of two parallel-vector cache lines
    std::vector<int32_t> tab;

    void build_from_lengths(const int8_t* lens, const uint8_t* syms, int n) {
        max_len = 0;
        for (int i = 0; i < n; ++i) if (lens[i] > 0) max_len = std::max<int>(max_len, lens[i]);
        tab.assign(1u << max_len, -1);
        uint64_t code = 0;
        for (int i = 0; i < n; ++i) {
            int l = lens[i];
            if (l <= 0) continue;
            uint32_t cw = (uint32_t)(code >> (32 - l));
            uint32_t base = cw << (max_len - l);
            uint32_t span = 1u << (max_len - l);
            for (uint32_t j = 0; j < span; ++j)
                tab[base + j] = (int32_t)(((int32_t)syms[i] << 8) | l);
            code += 1ull << (32 - l);
        }
    }
    void build_explicit(const uint8_t* bits, const uint8_t* codes, int n) {
        max_len = 0;
        for (int i = 0; i < n; ++i) max_len = std::max<int>(max_len, bits[i]);
        tab.assign(1u << max_len, -1);
        for (int i = 0; i < n; ++i) {
            if (!bits[i]) continue;
            uint32_t base = (uint32_t)codes[i] << (max_len - bits[i]);
            uint32_t span = 1u << (max_len - bits[i]);
            for (uint32_t j = 0; j < span; ++j)
                tab[base + j] = (int32_t)((i << 8) | bits[i]);
        }
    }
    int read(BitReader& br) const {
        int32_t e = tab[br.peek(max_len)];
        if (e < 0) { br.bad = true; return 0; }
        br.pos += e & 0xFF;
        return e >> 8;
    }
};

struct Mp3Tables {
    Vlc vlcs[16];  // 1..15 used
    Vlc quads[2];
    bool ready = false;
    void init() {
        if (ready) return;
        int off = 0;
        for (int i = 0; i < 15; ++i) {
            int n = MP3_HUFF_SIZES_M1[i] + 1;
            vlcs[i + 1].build_from_lengths(MP3_HUFFLENS + off, MP3_HUFFSYMS + off, n);
            off += n;
        }
        quads[0].build_explicit(MP3_QUAD_BITS, MP3_QUAD_CODES, 16);
        quads[1].build_explicit(MP3_QUAD_BITS + 16, MP3_QUAD_CODES + 16, 16);
        ready = true;
    }
};
Mp3Tables g_mp3;

struct Header {
    int version, lsf, sample_rate, sr_index, bitrate, padding, mode, mode_ext;
    int nb_channels, frame_size, samples;
};

bool parse_header(const uint8_t* b, long len, Header& h) {
    if (len < 4) return false;
    uint32_t w = ((uint32_t)b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3];
    if (((w >> 21) & 0x7FF) != 0x7FF) return false;
    int version = (w >> 19) & 3;
    if (version == 1) return false;
    if (((w >> 17) & 3) != 1) return false;  // layer III
    int bi = (w >> 12) & 0xF;
    int si = (w >> 10) & 3;
    if (bi == 0 || bi == 15 || si == 3) return false;
    h.version = version;
    h.lsf = version != 3;
    h.padding = (w >> 9) & 1;
    h.mode = (w >> 6) & 3;
    h.mode_ext = (w >> 4) & 3;
    int rate = MP3_FREQ[si];
    int tier = 0;
    if (version == 2) { rate /= 2; tier = 1; }
    else if (version == 0) { rate /= 4; tier = 2; }
    h.sample_rate = rate;
    h.sr_index = si + 3 * tier;
    h.bitrate = MP3_BITRATE[(h.lsf ? 1 : 0) * 45 + 2 * 15 + bi] * 1000;
    h.samples = h.lsf ? 576 : 1152;
    h.nb_channels = h.mode == 3 ? 1 : 2;
    h.frame_size = (h.samples / 8 * h.bitrate) / rate + h.padding;
    return h.frame_size >= 4;
}

struct Granule {
    int part2_3_length, big_values, global_gain, scalefac_compress;
    int block_type, switch_point;
    int table_select[3], subblock_gain[3];
    int region0_count, region1_count;
    int preflag, scalefac_scale, count1table_select;
    int scale_factors[40];
    int32_t spectrum[576];
    int16_t expq[576];  // quarter-exponent per line
};

// granule lane ready for the device
struct GranuleOut {
    int16_t quant[2][576];
    int16_t expq[2][576];
    int32_t block_type[2];
    int32_t mixed[2];
    int32_t n_alias[2];
    int32_t ms;
    int32_t nch;
    int32_t sample_rate;
};

struct Mp3Parser {
    std::vector<uint8_t> buf;
    std::vector<uint8_t> reservoir;
    std::deque<GranuleOut> out;
    char error[128] = {0};

    void band_index_long(int sr_index, int* bi) {
        bi[0] = 0;
        for (int i = 0; i < 22; ++i) bi[i + 1] = bi[i] + MP3_BAND_LONG[sr_index * 22 + i];
    }

    void push(const uint8_t* data, long len) {
        g_mp3.init();
        buf.insert(buf.end(), data, data + len);
        for (;;) {
            // ID3 skip
            if (buf.size() >= 10 && !memcmp(buf.data(), "ID3", 3)) {
                long size = ((long)buf[6] << 21) | ((long)buf[7] << 14) | (buf[8] << 7) | buf[9];
                if ((long)buf.size() < 10 + size) return;
                buf.erase(buf.begin(), buf.begin() + 10 + size);
                continue;
            }
            size_t i = 0;
            while (i + 1 < buf.size() && !(buf[i] == 0xFF && (buf[i + 1] & 0xE0) == 0xE0)) ++i;
            if (i) buf.erase(buf.begin(), buf.begin() + i);
            if (buf.size() < 4) return;
            Header h;
            if (!parse_header(buf.data(), buf.size(), h)) {
                buf.erase(buf.begin());
                continue;
            }
            if ((long)buf.size() < h.frame_size) return;
            decode_frame(h, buf.data(), h.frame_size);
            buf.erase(buf.begin(), buf.begin() + h.frame_size);
        }
    }

    void decode_frame(const Header& h, const uint8_t* frame, long len) {
        int crc_skip = (frame[1] & 1) ? 0 : 2;
        long pos = 4 + crc_skip;
        int nch = h.nb_channels;
        int ngr = h.lsf ? 1 : 2;

        BitReader si(frame + pos, len - pos);
        int main_data_begin = (int)si.get(h.lsf ? 8 : 9);
        si.get(h.lsf ? (nch == 2 ? 2 : 1) : (nch == 2 ? 3 : 5));
        int scfsi[2][4] = {{0}};
        if (!h.lsf)
            for (int c = 0; c < nch; ++c)
                for (int b = 0; b < 4; ++b) scfsi[c][b] = (int)si.get(1);

        Granule grs[2][2];
        for (int g = 0; g < ngr; ++g) {
            for (int c = 0; c < nch; ++c) {
                Granule& gr = grs[g][c];
                gr.part2_3_length = (int)si.get(12);
                gr.big_values = (int)si.get(9);
                if (gr.big_values > 288) return;
                gr.global_gain = (int)si.get(8);
                gr.scalefac_compress = (int)si.get(h.lsf ? 9 : 4);
                gr.preflag = 0;
                if (si.get(1)) {
                    gr.block_type = (int)si.get(2);
                    if (gr.block_type == 0) return;
                    gr.switch_point = (int)si.get(1);
                    gr.table_select[0] = (int)si.get(5);
                    gr.table_select[1] = (int)si.get(5);
                    gr.table_select[2] = 0;
                    for (int w = 0; w < 3; ++w) gr.subblock_gain[w] = (int)si.get(3);
                    gr.region0_count = 7;
                    gr.region1_count = 36;
                } else {
                    gr.block_type = 0;
                    gr.switch_point = 0;
                    for (int t = 0; t < 3; ++t) gr.table_select[t] = (int)si.get(5);
                    for (int w = 0; w < 3; ++w) gr.subblock_gain[w] = 0;
                    gr.region0_count = (int)si.get(4);
                    gr.region1_count = (int)si.get(3);
                }
                if (!h.lsf) gr.preflag = (int)si.get(1);
                gr.scalefac_scale = (int)si.get(1);
                gr.count1table_select = (int)si.get(1);
            }
        }
        if (si.bad) return;
        long side_bytes = (si.pos + 7) / 8;
        const uint8_t* main_data = frame + pos + side_bytes;
        long main_len = len - pos - side_bytes;

        if (main_data_begin > (long)reservoir.size()) {
            reservoir.insert(reservoir.end(), main_data, main_data + main_len);
            trim_reservoir();
            return;
        }
        std::vector<uint8_t> data;
        if (main_data_begin) {
            data.assign(reservoir.end() - main_data_begin, reservoir.end());
            data.insert(data.end(), main_data, main_data + main_len);
        } else {
            data.assign(main_data, main_data + main_len);
        }
        reservoir.insert(reservoir.end(), main_data, main_data + main_len);
        trim_reservoir();

        BitReader br(data.data(), (long)data.size());
        for (int g = 0; g < ngr; ++g) {
            GranuleOut go;
            memset(&go, 0, sizeof go);
            go.nch = nch;
            go.sample_rate = h.sample_rate;
            go.ms = (nch == 2 && h.mode == 1 && (h.mode_ext & 2)) ? 1 : 0;
            bool ok = true;
            for (int c = 0; c < nch; ++c) {
                Granule& gr = grs[g][c];
                long start = br.pos;
                if (h.lsf) read_scalefactors_lsf(br, gr, h, c);
                else read_scalefactors(br, gr, scfsi[c], grs[0][c], g);
                if (!read_huffman(br, gr, h, start)) { ok = false; break; }
                compute_expq(gr, h);
                reorder_short(gr, h);
                for (int i = 0; i < 576; ++i) {
                    int32_t v = gr.spectrum[i];
                    go.quant[c][i] = (int16_t)std::max(-32768, std::min(32767, v));
                }
                memcpy(go.expq[c], gr.expq, sizeof gr.expq);
                go.block_type[c] = gr.block_type;
                go.mixed[c] = gr.switch_point;
                go.n_alias[c] = (gr.block_type == 2 && !gr.switch_point) ? 0
                                 : (gr.block_type == 2 ? 1 : 31);
            }
            if (ok) out.push_back(go);
        }
    }

    void trim_reservoir() {
        const size_t cap = 511 + 2048;
        if (reservoir.size() > cap)
            reservoir.erase(reservoir.begin(), reservoir.end() - cap);
    }

    void read_scalefactors(BitReader& br, Granule& gr, const int* scfsi,
                           const Granule& gr0, int gnum) {
        int slen1 = MP3_SLEN[gr.scalefac_compress];
        int slen2 = MP3_SLEN[16 + gr.scalefac_compress];
        memset(gr.scale_factors, 0, sizeof gr.scale_factors);
        if (gr.block_type == 2) {
            if (gr.switch_point) {
                for (int i = 0; i < 8; ++i) gr.scale_factors[i] = (int)br.get(slen1);
                for (int i = 3; i < 12; ++i)
                    for (int w = 0; w < 3; ++w)
                        gr.scale_factors[8 + (i - 3) * 3 + w] = (int)br.get(i < 6 ? slen1 : slen2);
            } else {
                for (int i = 0; i < 6; ++i)
                    for (int w = 0; w < 3; ++w) gr.scale_factors[i * 3 + w] = (int)br.get(slen1);
                for (int i = 6; i < 12; ++i)
                    for (int w = 0; w < 3; ++w) gr.scale_factors[i * 3 + w] = (int)br.get(slen2);
            }
        } else {
            static const int groups[4][3] = {{0, 6, 0}, {6, 11, 0}, {11, 16, 1}, {16, 21, 1}};
            for (int b = 0; b < 4; ++b) {
                int lo = groups[b][0], hi = groups[b][1];
                int slen = groups[b][2] ? slen2 : slen1;
                if (gnum == 1 && scfsi[b]) {
                    for (int i = lo; i < hi; ++i) gr.scale_factors[i] = gr0.scale_factors[i];
                } else {
                    for (int i = lo; i < hi; ++i) gr.scale_factors[i] = (int)br.get(slen);
                }
            }
        }
    }

    void read_scalefactors_lsf(BitReader& br, Granule& gr, const Header& h, int ch) {
        bool is_mode = h.mode == 1 && (h.mode_ext & 1) && ch == 1;
        int sc = gr.scalefac_compress;
        int slen[4] = {0, 0, 0, 0};
        int tindex2;
        if (!is_mode) {
            if (sc < 400) { slen[0] = (sc >> 4) / 5; slen[1] = (sc >> 4) % 5; slen[2] = (sc >> 2) & 3; slen[3] = sc & 3; tindex2 = 0; }
            else if (sc < 500) { sc -= 400; slen[0] = (sc >> 2) / 5; slen[1] = (sc >> 2) % 5; slen[2] = sc & 3; tindex2 = 1; }
            else { sc -= 500; slen[0] = sc / 3; slen[1] = sc % 3; tindex2 = 2; gr.preflag = 1; }
        } else {
            sc >>= 1;
            if (sc < 180) { slen[0] = sc / 36; slen[1] = (sc % 36) / 6; slen[2] = sc % 6; tindex2 = 3; }
            else if (sc < 244) { sc -= 180; slen[0] = (sc % 64) >> 4; slen[1] = (sc % 16) >> 2; slen[2] = sc & 3; tindex2 = 4; }
            else { sc -= 244; slen[0] = sc / 3; slen[1] = sc % 3; tindex2 = 5; }
        }
        int tindex = gr.block_type == 2 ? (gr.switch_point ? 2 : 1) : 0;
        memset(gr.scale_factors, 0, sizeof gr.scale_factors);
        int j = 0;
        for (int k = 0; k < 4; ++k) {
            int n = MP3_LSF_NSF[(tindex2 * 3 + tindex) * 4 + k];
            for (int i = 0; i < n; ++i)
                if (j < 40) gr.scale_factors[j++] = slen[k] ? (int)br.get(slen[k]) : 0;
        }
    }

    bool read_huffman(BitReader& br, Granule& gr, const Header& h, long part_start) {
        memset(gr.spectrum, 0, sizeof gr.spectrum);
        int bi[23];
        band_index_long(h.sr_index, bi);
        int region1, region2;
        // 8 kHz MPEG-2.5 (sr_index 8) has double-width bands: the
        // short-block big-values boundary is 72 lines, not 36.
        if (gr.block_type == 2) { region1 = h.sr_index == 8 ? 72 : 36; region2 = 576; }
        else {
            int r0 = std::min(gr.region0_count + 1, 22);
            int r1 = std::min(gr.region0_count + 1 + gr.region1_count + 1, 22);
            region1 = bi[r0];
            region2 = bi[r1];
        }
        int big = std::min(gr.big_values * 2, 576);
        int bounds[4] = {0, std::min(region1, big), std::min(region2, big), big};
        for (int r = 0; r < 3; ++r) {
            int lo = bounds[r], hi = bounds[r + 1];
            if (hi <= lo) continue;
            int table = gr.table_select[r];
            int vlc_idx = MP3_HUFF_DATA[table * 2];
            int linbits = MP3_HUFF_DATA[table * 2 + 1];
            if (vlc_idx == 0) continue;
            const Vlc& vlc = g_mp3.vlcs[vlc_idx];
            for (int i = lo; i < hi; i += 2) {
                int s = vlc.read(br);
                if (br.bad) return false;
                int x = s >> 4, y = s & 0xF;
                if (x) {
                    if (x == 15 && linbits) x += (int)br.get(linbits);
                    if (br.get(1)) x = -x;
                }
                if (y) {
                    if (y == 15 && linbits) y += (int)br.get(linbits);
                    if (br.get(1)) y = -y;
                }
                gr.spectrum[i] = x;
                gr.spectrum[i + 1] = y;
            }
        }
        long limit = part_start + gr.part2_3_length;
        const Vlc& quad = g_mp3.quads[gr.count1table_select];
        int i = big;
        while (br.pos < limit && i <= 572) {
            int s = quad.read(br);
            if (br.bad) break;
            for (int k = 0; k < 4; ++k) {
                int v = (s >> (3 - k)) & 1;
                if (v && br.pos < limit && br.get(1)) v = -v;
                gr.spectrum[i + k] = v;
            }
            i += 4;
        }
        if (br.pos > limit && i >= 4)
            for (int k = i - 4; k < i; ++k) gr.spectrum[k] = 0;
        br.pos = limit;
        br.bad = false;
        return true;
    }

    void compute_expq(Granule& gr, const Header& h) {
        int bi[23];
        band_index_long(h.sr_index, bi);
        int gain = gr.global_gain - 210;
        int shift = gr.scalefac_scale + 1;
        memset(gr.expq, 0, sizeof gr.expq);
        // sentinel for "zero scale" is INT16_MIN
        for (int i = 0; i < 576; ++i) gr.expq[i] = INT16_MIN;
        if (gr.block_type == 2) {
            const uint8_t* szs = MP3_BAND_SHORT + h.sr_index * 13;
            int pos = 0, first_short = 0, sfi = 0;
            if (gr.switch_point) {
                for (int b = 0; b < 8; ++b) {
                    int pre = gr.preflag ? MP3_PRETAB[22 + b] : 0;
                    int e = gain - ((gr.scale_factors[b] + pre) << shift);
                    for (int k = bi[b]; k < bi[b + 1]; ++k) gr.expq[k] = (int16_t)e;
                }
                pos = bi[8];
                first_short = 3;
                sfi = 8;
            }
            for (int b = first_short; b < 13 && pos < 576; ++b) {
                int size = szs[b];
                for (int w = 0; w < 3; ++w) {
                    int sf = sfi < 40 ? gr.scale_factors[sfi] : 0;
                    int e = gain - 8 * gr.subblock_gain[w] - (sf << shift);
                    for (int k = 0; k < size && pos < 576; ++k) gr.expq[pos++] = (int16_t)e;
                    ++sfi;
                }
            }
        } else {
            for (int b = 0; b < 22; ++b) {
                int sf = b < 21 ? gr.scale_factors[b] : 0;
                int pre = gr.preflag ? MP3_PRETAB[22 + b] : 0;
                int e = gain - ((sf + pre) << shift);
                for (int k = bi[b]; k < bi[b + 1]; ++k) gr.expq[k] = (int16_t)e;
            }
        }
        // lines with zero quant keep sentinel only if never assigned;
        // assigned bands carry e even when quant==0 (harmless: 0 * 2^e)
    }

    void reorder_short(Granule& gr, const Header& h) {
        if (gr.block_type != 2) return;
        const uint8_t* szs = MP3_BAND_SHORT + h.sr_index * 13;
        int bi[23];
        band_index_long(h.sr_index, bi);
        int start = gr.switch_point ? 36 : 0;
        int first = gr.switch_point ? 3 : 0;
        int32_t tmp_s[576];
        int16_t tmp_e[576];
        memcpy(tmp_s, gr.spectrum, sizeof tmp_s);
        memcpy(tmp_e, gr.expq, sizeof tmp_e);
        int pos = start;
        for (int b = first; b < 13; ++b) {
            int size = szs[b];
            if (pos + 3 * size > 576) break;
            for (int f = 0; f < size; ++f)
                for (int w = 0; w < 3; ++w) {
                    gr.spectrum[pos + f * 3 + w] = tmp_s[pos + w * size + f];
                    gr.expq[pos + f * 3 + w] = tmp_e[pos + w * size + f];
                }
            pos += 3 * size;
        }
    }
};

}  // namespace

extern "C" {

void* skt_mp3_new() { return new Mp3Parser(); }
void skt_mp3_free(void* h) { delete (Mp3Parser*)h; }

long skt_mp3_push(void* h, const uint8_t* data, long len) {
    auto* p = (Mp3Parser*)h;
    p->push(data, len);
    return (long)p->out.size();
}

// pop one granule into caller buffers:
// quant i16 [2,576], expq i16 [2,576], meta i32 [10]:
//   bt0, mixed0, nal0, bt1, mixed1, nal1, ms, nch, sample_rate, 0
// returns 1 if a granule was produced, 0 if queue empty
int skt_mp3_pop(void* h, int16_t* quant, int16_t* expq, int32_t* meta) {
    auto* p = (Mp3Parser*)h;
    if (p->out.empty()) return 0;
    const GranuleOut& go = p->out.front();
    memcpy(quant, go.quant, sizeof go.quant);
    memcpy(expq, go.expq, sizeof go.expq);
    meta[0] = go.block_type[0];
    meta[1] = go.mixed[0];
    meta[2] = go.n_alias[0];
    meta[3] = go.block_type[1];
    meta[4] = go.mixed[1];
    meta[5] = go.n_alias[1];
    meta[6] = go.ms;
    meta[7] = go.nch;
    meta[8] = go.sample_rate;
    meta[9] = 0;
    p->out.pop_front();
    return 1;
}

// batched pop: one granule from each of B parser handles into [B,...]
// wire arrays shaped for ops.mp3_batch.mp3_granule_device_compact —
//   quant i16 [B,2,576], expq i16 [B,2,576] (-32768 = silent line),
//   bt/nal i32 [B,2], mixed/valid u8 [B,2], ms u8 [B], rate i32 [B]
// lanes with an empty queue are zeroed with valid=0.  Returns the
// number of lanes that produced a granule.
int skt_mp3_pop_batch(void** handles, int B, int16_t* quant, int16_t* expq,
                      int32_t* bt, uint8_t* mixed, int32_t* nal,
                      uint8_t* ms, uint8_t* valid, int32_t* rate) {
    int produced = 0;
    for (int b = 0; b < B; ++b) {
        int16_t* q = quant + (long)b * 2 * 576;
        int16_t* e = expq + (long)b * 2 * 576;
        auto* p = (Mp3Parser*)handles[b];
        if (!p || p->out.empty()) {
            memset(q, 0, 2 * 576 * 2);
            for (int i = 0; i < 2 * 576; ++i) e[i] = -32768;
            bt[b * 2] = bt[b * 2 + 1] = 0;
            nal[b * 2] = nal[b * 2 + 1] = 0;
            mixed[b * 2] = mixed[b * 2 + 1] = 0;
            valid[b * 2] = valid[b * 2 + 1] = 0;
            ms[b] = 0;
            rate[b] = 0;
            continue;
        }
        const GranuleOut& go = p->out.front();
        memcpy(q, go.quant, sizeof go.quant);
        memcpy(e, go.expq, sizeof go.expq);
        for (int c = 0; c < 2; ++c) {
            bt[b * 2 + c] = go.block_type[c];
            mixed[b * 2 + c] = (uint8_t)go.mixed[c];
            nal[b * 2 + c] = go.n_alias[c];
            valid[b * 2 + c] = c < go.nch ? 1 : 0;
        }
        ms[b] = (uint8_t)go.ms;
        rate[b] = go.sample_rate;
        p->out.pop_front();
        ++produced;
    }
    return produced;
}

// Multi-round batched pop (round-5 fleet host diet): pop up to G
// granules from each of B parser handles into G consecutive packed
// wire blocks of `stride` bytes (layout = ops/mp3_batch.
// mp3_wire_layout — the field offsets are passed in so the layout
// stays owned by the Python side).  One call replaces G per-round
// skt_mp3_pop_batch calls + G fresh numpy wire allocations.
// Lanes with fewer than G queued granules zero-fill the remaining
// slots (valid=0, expq=-32768 silent lines).  rate[b] gets the
// lane's last popped granule's sample rate (0 if none popped);
// popped[b] the number of granules consumed from lane b.
void skt_mp3_pop_rounds(void** handles, int B, int G, uint8_t* wire,
                        long stride, long off_bt, long off_nal,
                        long off_quant, long off_expq, long off_mixed,
                        long off_ms, long off_valid, int32_t* rate,
                        int32_t* popped) {
    for (int b = 0; b < B; ++b) {
        auto* p = (Mp3Parser*)handles[b];
        rate[b] = 0;
        popped[b] = 0;
        for (int g = 0; g < G; ++g) {
            uint8_t* base = wire + (size_t)g * stride;
            auto* bt = (int32_t*)(base + off_bt) + b * 2;
            auto* nal = (int32_t*)(base + off_nal) + b * 2;
            auto* q = (int16_t*)(base + off_quant) + (long)b * 2 * 576;
            auto* e = (int16_t*)(base + off_expq) + (long)b * 2 * 576;
            uint8_t* mixed = base + off_mixed + b * 2;
            uint8_t* ms = base + off_ms + b;
            uint8_t* valid = base + off_valid + b * 2;
            if (!p || p->out.empty()) {
                memset(q, 0, 2 * 576 * 2);
                for (int i = 0; i < 2 * 576; ++i) e[i] = -32768;
                bt[0] = bt[1] = nal[0] = nal[1] = 0;
                mixed[0] = mixed[1] = 0;
                valid[0] = valid[1] = 0;
                ms[0] = 0;
                continue;
            }
            const GranuleOut& go = p->out.front();
            memcpy(q, go.quant, sizeof go.quant);
            memcpy(e, go.expq, sizeof go.expq);
            for (int c = 0; c < 2; ++c) {
                bt[c] = go.block_type[c];
                mixed[c] = (uint8_t)go.mixed[c];
                nal[c] = go.n_alias[c];
                valid[c] = c < go.nch ? 1 : 0;
            }
            ms[0] = (uint8_t)go.ms;
            rate[b] = go.sample_rate;
            p->out.pop_front();
            popped[b]++;
        }
    }
}

}  // extern "C"
