// FLAC host-side decoder: container parse, frame/subframe bitstream
// decode, Rice residual decode, LPC/fixed reconstruction.
//
// Role-equivalent of the reference's claxon backend
// (soundkit-flac/src/lib.rs:646-780 FlacDecoderClaxon) but written
// from the FLAC format specification as the framework's native host
// path (SURVEY.md §2.3: entropy decode stays on the host; the batched
// device path receives residuals/coefficients via
// skt_flac_frame_parts).
//
// C ABI (see loader.py):
//   skt_flac_new/free          — streaming decoder handle
//   skt_flac_push              — append bytes
//   skt_flac_info              — stream parameters once known
//   skt_flac_pull              — drain decoded interleaved int32
//   skt_flac_md5               — STREAMINFO md5 (16 bytes)
//   skt_flac_frame_parts       — decode next frame but export
//                                residuals + coeffs (device-LPC mode)

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <deque>
#include <vector>
#include <stdexcept>

namespace {

struct OutOfData : std::exception {};
struct BadStream : std::exception {
    const char* msg;
    explicit BadStream(const char* m) : msg(m) {}
};

class BitReader {
  public:
    BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

    size_t byte_pos() const { return pos_; }
    size_t bit_offset() const { return bitpos_; }

    bool at_byte_boundary() const { return bitpos_ == 0; }

    void align_byte() {
        if (bitpos_) { bitpos_ = 0; ++pos_; }
    }

    uint32_t read_bits(unsigned n) {  // n <= 32
        if (n && pos_ + 8 <= len_) {  // hot path: one unaligned 64-bit load
            uint64_t w;
            memcpy(&w, data_ + pos_, 8);
            w = __builtin_bswap64(w);
            uint32_t v = (uint32_t)((w << bitpos_) >> (64 - n));
            bitpos_ += n;
            pos_ += bitpos_ >> 3;
            bitpos_ &= 7;
            return v;
        }
        uint32_t v = 0;
        while (n > 0) {
            if (pos_ >= len_) throw OutOfData{};
            unsigned avail = 8 - bitpos_;
            unsigned take = n < avail ? n : avail;
            unsigned shift = avail - take;
            uint32_t bits = (data_[pos_] >> shift) & ((1u << take) - 1u);
            v = (v << take) | bits;
            bitpos_ += take;
            if (bitpos_ == 8) { bitpos_ = 0; ++pos_; }
            n -= take;
        }
        return v;
    }

    uint64_t read_bits64(unsigned n) {  // n <= 64
        if (n <= 32) return read_bits(n);
        uint64_t hi = read_bits(n - 32);
        uint64_t lo = read_bits(32);
        return (hi << 32) | lo;
    }

    int32_t read_signed(unsigned n) {
        uint32_t v = read_bits(n);
        if (n == 0) return 0;
        if (n < 32 && (v & (1u << (n - 1)))) {
            return (int32_t)(v | (~0u << n));
        }
        return (int32_t)v;
    }

    uint32_t read_unary() {
        uint32_t q = 0;
        while (pos_ + 8 <= len_) {  // hot path: clz over a 64-bit window
            uint64_t w;
            memcpy(&w, data_ + pos_, 8);
            w = __builtin_bswap64(w);
            w <<= bitpos_;  // drop already-consumed bits (zero-fill)
            if (w) {
                unsigned lz = (unsigned)__builtin_clzll(w);
                q += lz;
                bitpos_ += lz + 1;  // zeros + terminating 1
                pos_ += bitpos_ >> 3;
                bitpos_ &= 7;
                return q;
            }
            q += 64 - bitpos_;  // whole window is zeros
            pos_ += 8;
            bitpos_ = 0;
        }
        for (;;) {
            if (pos_ >= len_) throw OutOfData{};
            uint8_t byte = data_[pos_];
            uint8_t rem = (uint8_t)(byte << bitpos_);
            if (rem == 0) {
                q += 8 - bitpos_;
                bitpos_ = 0;
                ++pos_;
                continue;
            }
            // count leading zeros within the remaining bits
            unsigned lz = 0;
            while (!(rem & 0x80)) { rem <<= 1; ++lz; }
            q += lz;
            bitpos_ += lz + 1;  // consume zeros + the terminating 1
            if (bitpos_ >= 8) { bitpos_ -= 8; ++pos_; }
            return q;
        }
    }

    void seek(size_t byte, unsigned bit) { pos_ = byte; bitpos_ = bit; }

  private:
    const uint8_t* data_;
    size_t len_;
    size_t pos_ = 0;
    unsigned bitpos_ = 0;
};

// CRC-8 poly 0x07 (frame header)
uint8_t crc8(const uint8_t* data, size_t len) {
    uint8_t crc = 0;
    for (size_t i = 0; i < len; ++i) {
        crc ^= data[i];
        for (int b = 0; b < 8; ++b)
            crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
    }
    return crc;
}

// CRC-16 poly 0x8005 (whole frame), table-driven (the bit-loop was
// ~15 us/frame on the 256-lane serving walk)
uint16_t crc16(const uint8_t* data, size_t len) {
    static uint16_t tab[256];
    static bool init = false;
    if (!init) {
        for (unsigned i = 0; i < 256; ++i) {
            uint16_t c = (uint16_t)(i << 8);
            for (int b = 0; b < 8; ++b)
                c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005)
                                 : (uint16_t)(c << 1);
            tab[i] = c;
        }
        init = true;
    }
    uint16_t crc = 0;
    for (size_t i = 0; i < len; ++i)
        crc = (uint16_t)((crc << 8) ^ tab[(crc >> 8) ^ data[i]]);
    return crc;
}

struct StreamInfo {
    uint32_t min_block = 0, max_block = 0;
    uint32_t sample_rate = 0;
    uint32_t channels = 0;
    uint32_t bits_per_sample = 0;
    uint64_t total_samples = 0;
    uint8_t md5[16] = {0};
    bool valid = false;
};

struct FrameInfo {
    uint32_t block_size = 0;
    uint32_t sample_rate = 0;
    uint32_t channels = 0;
    uint32_t channel_assignment = 0;  // 0..7 independent, 8 L/S, 9 R/S, 10 M/S
    uint32_t bits_per_sample = 0;
    uint64_t number = 0;
    size_t frame_bytes = 0;  // total encoded size incl. crc16
};

// one device-decodable bitstream span: `n` codes starting at frame-
// relative `bitoff`.  k >= 0 = Rice parameter; k < 0 = fixed-width
// signed reads of (-k - 1) bits (escape partitions, verbatim).
// `steps` = device scan iterations needed (n + one extra per 24-zero
// unary window skip, matching ops/flac_rice.py).
struct Seg {
    uint32_t bitoff;
    int32_t k;
    uint32_t n;
    uint32_t steps;
    uint32_t dest;  // sample index within the subframe plane
};

// decoded subframe structure for the device-export mode
struct SubframeParts {
    int type = 0;        // 0 const, 1 verbatim, 2 fixed, 3 lpc
    int order = 0;
    int shift = 0;
    int wasted = 0;
    std::vector<int32_t> coeffs;     // lpc only
    std::vector<int32_t> warmup;     // order entries (fixed/lpc)
    std::vector<int32_t> residual;   // block_size - order entries
    std::vector<int32_t> verbatim;   // const(1)/verbatim(block) raw
    std::vector<Seg> segs;           // device-Rice wire (segment mode)
};

// default span length cap for the device-Rice wire: segments longer
// than this are split so the device scan stays short (the scan length
// is the max `steps` across a batch)
constexpr uint32_t SEG_LEN_CAP = 144;

void read_residual(BitReader& br, uint32_t block_size, uint32_t order,
                   std::vector<int32_t>& out, SubframeParts* rec = nullptr) {
    uint32_t method = br.read_bits(2);
    if (method > 1) throw BadStream{"bad residual method"};
    unsigned plen = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 15 : 31;
    uint32_t porder = br.read_bits(4);
    uint32_t partitions = 1u << porder;
    if (block_size % partitions) throw BadStream{"bad partition order"};
    uint32_t psize = block_size >> porder;
    out.clear();
    out.reserve(block_size - order);
    for (uint32_t p = 0; p < partitions; ++p) {
        uint32_t count = psize - (p == 0 ? order : 0);
        uint32_t param = br.read_bits(plen);
        if (param == escape) {
            uint32_t raw = br.read_bits(5);
            uint32_t left = count;
            while (left) {
                uint32_t take = rec ? std::min(left, SEG_LEN_CAP) : left;
                uint32_t off = (uint32_t)(br.byte_pos() * 8 + br.bit_offset());
                uint32_t dest = order + (uint32_t)out.size();
                for (uint32_t i = 0; i < take; ++i)
                    out.push_back(raw ? br.read_signed(raw) : 0);
                if (rec)
                    rec->segs.push_back(
                        {off, -(int32_t)raw - 1, take, take, dest});
                left -= take;
            }
        } else {
            uint32_t left = count;
            while (left) {
                uint32_t take = rec ? std::min(left, SEG_LEN_CAP) : left;
                uint32_t off = (uint32_t)(br.byte_pos() * 8 + br.bit_offset());
                uint32_t dest = order + (uint32_t)out.size();
                uint32_t steps = take;
                for (uint32_t i = 0; i < take; ++i) {
                    uint32_t q = br.read_unary();
                    uint32_t r = param ? br.read_bits(param) : 0;
                    uint32_t zz = (q << param) | r;
                    out.push_back((int32_t)(zz >> 1) ^ -(int32_t)(zz & 1));
                    steps += q / 24;  // device 24-zero window skips
                }
                if (rec)
                    rec->segs.push_back(
                        {off, (int32_t)param, take, steps, dest});
                left -= take;
            }
        }
    }
}

void decode_subframe(BitReader& br, uint32_t block_size, uint32_t bps,
                     SubframeParts& sf, std::vector<int64_t>& samples,
                     bool reconstruct = true) {
    if (br.read_bits(1) != 0) throw BadStream{"subframe reserved bit"};
    uint32_t type = br.read_bits(6);
    uint32_t wasted = 0;
    if (br.read_bits(1)) wasted = br.read_unary() + 1;
    uint32_t ebps = bps - wasted;
    sf.wasted = (int)wasted;

    samples.assign(block_size, 0);

    if (type == 0) {  // CONSTANT
        int32_t v = br.read_signed(ebps);
        sf.type = 0;
        sf.verbatim.assign(1, v);
        if (reconstruct)
            for (uint32_t i = 0; i < block_size; ++i) samples[i] = v;
    } else if (type == 1) {  // VERBATIM
        sf.type = 1;
        sf.verbatim.resize(block_size);
        uint32_t done = 0;
        while (done < block_size) {
            uint32_t take = reconstruct ? block_size - done
                                        : std::min(block_size - done,
                                                   SEG_LEN_CAP);
            uint32_t off = (uint32_t)(br.byte_pos() * 8 + br.bit_offset());
            for (uint32_t i = done; i < done + take; ++i) {
                sf.verbatim[i] = br.read_signed(ebps);
                samples[i] = sf.verbatim[i];
            }
            if (!reconstruct)
                sf.segs.push_back(
                    {off, -(int32_t)ebps - 1, take, take, done});
            done += take;
        }
    } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
        uint32_t order = type - 8;
        sf.type = 2;
        sf.order = (int)order;
        sf.shift = 0;
        sf.warmup.resize(order);
        for (uint32_t i = 0; i < order; ++i) {
            sf.warmup[i] = br.read_signed(ebps);
            samples[i] = sf.warmup[i];
        }
        read_residual(br, block_size, order, sf.residual,
                      reconstruct ? nullptr : &sf);
        if (reconstruct) {
            const int64_t* s = samples.data();
            for (uint32_t i = order; i < block_size; ++i) {
                int64_t pred = 0;
                switch (order) {
                    case 0: pred = 0; break;
                    case 1: pred = s[i - 1]; break;
                    case 2: pred = 2 * s[i - 1] - s[i - 2]; break;
                    case 3: pred = 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]; break;
                    case 4: pred = 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4]; break;
                }
                samples[i] = pred + sf.residual[i - order];
            }
        }
    } else if (type >= 32) {  // LPC, order = (type & 31) + 1
        uint32_t order = (type & 31) + 1;
        sf.type = 3;
        sf.order = (int)order;
        sf.warmup.resize(order);
        for (uint32_t i = 0; i < order; ++i) {
            sf.warmup[i] = br.read_signed(ebps);
            samples[i] = sf.warmup[i];
        }
        uint32_t prec = br.read_bits(4);
        if (prec == 15) throw BadStream{"bad qlp precision"};
        prec += 1;
        int32_t shift = br.read_signed(5);
        if (shift < 0) throw BadStream{"negative qlp shift"};
        sf.shift = shift;
        sf.coeffs.resize(order);
        for (uint32_t i = 0; i < order; ++i) sf.coeffs[i] = br.read_signed(prec);
        read_residual(br, block_size, order, sf.residual,
                      reconstruct ? nullptr : &sf);
        if (reconstruct) {
            for (uint32_t i = order; i < block_size; ++i) {
                int64_t acc = 0;
                for (uint32_t k = 0; k < order; ++k)
                    acc += (int64_t)sf.coeffs[k] * samples[i - 1 - k];
                samples[i] = (acc >> shift) + sf.residual[i - order];
            }
        }
    } else {
        throw BadStream{"reserved subframe type"};
    }

    if (wasted && reconstruct) {
        for (uint32_t i = 0; i < block_size; ++i) samples[i] <<= wasted;
    }
}

uint64_t read_utf8_number(BitReader& br) {
    uint32_t b0 = br.read_bits(8);
    if (!(b0 & 0x80)) return b0;
    unsigned n = 0;
    for (uint32_t m = 0x80; b0 & m; m >>= 1) ++n;
    if (n < 2 || n > 7) throw BadStream{"bad utf8 number"};
    uint64_t v = b0 & (0x7Fu >> n);
    for (unsigned i = 1; i < n; ++i) {
        uint32_t b = br.read_bits(8);
        if ((b & 0xC0) != 0x80) throw BadStream{"bad utf8 continuation"};
        v = (v << 6) | (b & 0x3F);
    }
    return v;
}

// one frame queued for the batched serving export (round-5 host
// diet: skt_flac_drain walks frames once at push time and
// skt_flac_export_rounds scatters WHOLE collects into the device
// wire in one call — the per-frame ctypes next() + per-(round, lane)
// Python repack loop it replaced was a large host stage of the fleet)
struct QueuedExport {
    int kind = 0;  // 0 = segment wire, 1 = residual-plane fallback
    int32_t meta[12];
    int32_t coef[64];
    int32_t warm[64];
    int32_t xmeta[8];
    std::vector<int32_t> segs;    // kind 0: nseg*4
    std::vector<uint8_t> fbytes;  // kind 0: raw frame bytes
    std::vector<int32_t> resw;    // kind 1: [2*stride]
};

struct FlacDecoder {
    std::vector<uint8_t> buf;
    size_t consumed = 0;         // bytes of buf fully decoded
    StreamInfo info;
    bool header_done = false;
    std::vector<int32_t> out;    // decoded interleaved samples pending pull
    uint64_t samples_decoded = 0;
    char error[128] = {0};

    // scratch for device-export mode
    std::vector<SubframeParts> last_parts;
    FrameInfo last_frame;
    std::vector<uint8_t> last_bytes;  // raw frame bytes (segment wire)
    std::deque<QueuedExport> queued;  // skt_flac_drain output

    void compact() {
        if (consumed > (1u << 20)) {
            buf.erase(buf.begin(), buf.begin() + consumed);
            consumed = 0;
        }
    }

    bool parse_header() {
        // "fLaC" + metadata blocks; also accept headerless raw frame
        // streams (the reference's independently-framed FLAC packets,
        // soundkit-flac/src/frame_codec.rs) which start at a frame sync
        if (buf.size() < consumed + 4) return false;
        if (memcmp(buf.data() + consumed, "fLaC", 4) != 0) {
            if (buf[consumed] == 0xFF && (buf[consumed + 1] & 0xFC) == 0xF8) {
                header_done = true;  // raw frames; info filled from frame 1
                return true;
            }
            snprintf(error, sizeof error, "not a FLAC stream");
            throw BadStream{"not flac"};
        }
        size_t p = consumed + 4;
        for (;;) {
            if (buf.size() < p + 4) return false;
            uint8_t h = buf[p];
            uint32_t len = ((uint32_t)buf[p + 1] << 16) | ((uint32_t)buf[p + 2] << 8) | buf[p + 3];
            if (buf.size() < p + 4 + len) return false;
            if ((h & 0x7F) == 0) {  // STREAMINFO
                const uint8_t* d = buf.data() + p + 4;
                if (len < 34) throw BadStream{"short streaminfo"};
                info.min_block = ((uint32_t)d[0] << 8) | d[1];
                info.max_block = ((uint32_t)d[2] << 8) | d[3];
                info.sample_rate = ((uint32_t)d[10] << 12) | ((uint32_t)d[11] << 4) | (d[12] >> 4);
                info.channels = ((d[12] >> 1) & 0x7) + 1;
                info.bits_per_sample = (((d[12] & 1) << 4) | (d[13] >> 4)) + 1;
                info.total_samples = ((uint64_t)(d[13] & 0x0F) << 32) |
                                     ((uint64_t)d[14] << 24) | ((uint64_t)d[15] << 16) |
                                     ((uint64_t)d[16] << 8) | d[17];
                memcpy(info.md5, d + 18, 16);
                info.valid = true;
            }
            p += 4 + len;
            if (h & 0x80) break;  // last block
        }
        consumed = p;
        header_done = true;
        return true;
    }

    // attempt to decode one frame starting at `consumed`; returns false if
    // more data needed
    bool decode_frame(bool export_parts) {
        size_t avail = buf.size() - consumed;
        if (avail < 5) return false;
        BitReader br(buf.data() + consumed, avail);
        FrameInfo fi;
        try {
            uint32_t sync = br.read_bits(14);
            if (sync != 0x3FFE) throw BadStream{"lost sync"};
            if (br.read_bits(1) != 0) throw BadStream{"frame reserved bit"};
            br.read_bits(1);  // blocking strategy
            uint32_t bs_code = br.read_bits(4);
            uint32_t sr_code = br.read_bits(4);
            uint32_t ch_code = br.read_bits(4);
            uint32_t ss_code = br.read_bits(3);
            if (br.read_bits(1) != 0) throw BadStream{"frame reserved bit 2"};
            fi.number = read_utf8_number(br);

            switch (bs_code) {
                case 0: throw BadStream{"reserved block size"};
                case 1: fi.block_size = 192; break;
                case 6: fi.block_size = br.read_bits(8) + 1; break;
                case 7: fi.block_size = br.read_bits(16) + 1; break;
                default:
                    fi.block_size = bs_code <= 5 ? (576u << (bs_code - 2))
                                                 : (256u << (bs_code - 8));
            }
            static const uint32_t rates[] = {0, 88200, 176400, 192000, 8000, 16000,
                                             22050, 24000, 32000, 44100, 48000, 96000};
            if (sr_code == 0) fi.sample_rate = info.sample_rate;
            else if (sr_code <= 11) fi.sample_rate = rates[sr_code];
            else if (sr_code == 12) fi.sample_rate = br.read_bits(8) * 1000;
            else if (sr_code == 13) fi.sample_rate = br.read_bits(16);
            else if (sr_code == 14) fi.sample_rate = br.read_bits(16) * 10;
            else throw BadStream{"bad sample rate code"};

            fi.channel_assignment = ch_code;
            fi.channels = ch_code < 8 ? ch_code + 1 : 2;

            static const uint32_t sizes[] = {0, 8, 12, 0, 16, 20, 24, 32};
            fi.bits_per_sample = ss_code == 0 ? info.bits_per_sample : sizes[ss_code];
            if (fi.bits_per_sample == 0) throw BadStream{"bad sample size code"};

            // CRC-8 over header bytes
            size_t hdr_len = br.byte_pos() + (br.at_byte_boundary() ? 0 : 1);
            uint8_t expect = (uint8_t)br.read_bits(8);
            if (crc8(buf.data() + consumed, hdr_len) != expect)
                throw BadStream{"frame header crc"};

            if (export_parts) last_parts.assign(fi.channels, SubframeParts{});

            std::vector<std::vector<int64_t>> chan(fi.channels);
            std::vector<int64_t> tmp;
            SubframeParts dummy;
            for (uint32_t c = 0; c < fi.channels; ++c) {
                uint32_t bps = fi.bits_per_sample;
                // side channels carry one extra bit
                if ((fi.channel_assignment == 8 && c == 1) ||
                    (fi.channel_assignment == 9 && c == 0) ||
                    (fi.channel_assignment == 10 && c == 1))
                    bps += 1;
                SubframeParts& sf = export_parts ? last_parts[c] : dummy;
                // export mode: entropy decode only; LPC/fixed
                // reconstruction, wasted shift and decorrelation run on
                // the device (ops/flac_lpc.py)
                decode_subframe(br, fi.block_size, bps, sf, tmp,
                                /*reconstruct=*/!export_parts);
                if (!export_parts) chan[c] = tmp;
            }
            br.align_byte();
            size_t crc_pos = br.byte_pos();
            uint16_t expect16 = (uint16_t)br.read_bits(16);
            if (crc16(buf.data() + consumed, crc_pos) != expect16)
                throw BadStream{"frame crc16"};
            fi.frame_bytes = br.byte_pos();

            if (!export_parts) {
                // stereo decorrelation
                if (fi.channel_assignment == 8) {         // left/side
                    for (uint32_t i = 0; i < fi.block_size; ++i)
                        chan[1][i] = chan[0][i] - chan[1][i];
                } else if (fi.channel_assignment == 9) {  // right/side
                    for (uint32_t i = 0; i < fi.block_size; ++i)
                        chan[0][i] = chan[1][i] + chan[0][i];
                } else if (fi.channel_assignment == 10) { // mid/side
                    for (uint32_t i = 0; i < fi.block_size; ++i) {
                        int64_t side = chan[1][i];
                        int64_t mid = (chan[0][i] << 1) | (side & 1);
                        chan[0][i] = (mid + side) >> 1;
                        chan[1][i] = (mid - side) >> 1;
                    }
                }

                for (uint32_t i = 0; i < fi.block_size; ++i)
                    for (uint32_t c = 0; c < fi.channels; ++c)
                        out.push_back((int32_t)chan[c][i]);
            }

            if (export_parts)
                last_bytes.assign(buf.begin() + consumed,
                                  buf.begin() + consumed + fi.frame_bytes);
            consumed += fi.frame_bytes;
            samples_decoded += fi.block_size;
            last_frame = fi;
            if (!info.valid) {  // raw frame stream: adopt frame params
                info.sample_rate = fi.sample_rate;
                info.channels = fi.channels;
                info.bits_per_sample = fi.bits_per_sample;
                info.valid = true;
            }
            compact();
            return true;
        } catch (OutOfData&) {
            return false;
        }
    }
};

}  // namespace

extern "C" {

void* skt_flac_new() { return new FlacDecoder(); }
void skt_flac_free(void* h) { delete (FlacDecoder*)h; }

// returns: 0 ok, -1 bad stream
int skt_flac_push(void* h, const uint8_t* data, long len) {
    auto* d = (FlacDecoder*)h;
    d->buf.insert(d->buf.end(), data, data + len);
    try {
        if (!d->header_done && !d->parse_header()) return 0;
        while (d->decode_frame(false)) {}
        return 0;
    } catch (BadStream& e) {
        snprintf(d->error, sizeof d->error, "%s", e.msg);
        return -1;
    }
}

int skt_flac_info(void* h, int* channels, int* bits, long* rate, long long* total) {
    auto* d = (FlacDecoder*)h;
    if (!d->info.valid) return 0;
    *channels = (int)d->info.channels;
    *bits = (int)d->info.bits_per_sample;
    *rate = (long)d->info.sample_rate;
    *total = (long long)d->info.total_samples;
    return 1;
}

void skt_flac_md5(void* h, uint8_t* out16) {
    memcpy(out16, ((FlacDecoder*)h)->info.md5, 16);
}

// drain up to max_values interleaved int32s; returns count written
long skt_flac_pull(void* h, int32_t* dst, long max_values) {
    auto* d = (FlacDecoder*)h;
    long n = (long)d->out.size() < max_values ? (long)d->out.size() : max_values;
    memcpy(dst, d->out.data(), (size_t)n * sizeof(int32_t));
    d->out.erase(d->out.begin(), d->out.begin() + n);
    return n;
}

const char* skt_flac_error(void* h) { return ((FlacDecoder*)h)->error; }

// ---- device-LPC split: host entropy decode -> residual/coef wire ----
//
// The device kernel (ops/flac_lpc.py) runs the LPC recurrence, wasted
// shift and stereo decorrelation; the host only does bitstream work.
// Wire per frame (stride = max block size, from skt_flac_max_block):
//   meta int32[12]: block_size, channels, chan_assign, bps,
//                   then per channel c<2: order, shift, wasted
//   resw int32[2*stride]: n < order -> warmup[n], else residual[n-order]
//        (CONSTANT/VERBATIM are exported as order-0 lanes whose resw IS
//        the sample stream, so one unified kernel covers all types)
//   coef int32[2*32]: LPC coefficients; FIXED orders use the canonical
//        {1},{2,-1},{3,-3,1},{4,-6,4,-1} sets with shift 0

long skt_flac_max_block(void* h) {
    auto* d = (FlacDecoder*)h;
    return d->info.valid && d->info.max_block ? (long)d->info.max_block : 65535;
}

// buffer bytes + parse STREAMINFO only (no frame decode): 0 ok, -1 bad
int skt_flac_feed(void* h, const uint8_t* data, long len) {
    auto* d = (FlacDecoder*)h;
    d->buf.insert(d->buf.end(), data, data + len);
    try {
        if (!d->header_done) d->parse_header();
        return 0;
    } catch (BadStream& e) {
        snprintf(d->error, sizeof d->error, "%s", e.msg);
        return -1;
    }
}

// export the already-decoded last frame as the residual-plane wire:
// 1 ok, -2 = frame does not fit (block > stride or >2 channels)
static int export_parts_of_last(FlacDecoder* d, int32_t* meta, int32_t* resw,
                                int32_t* coef, long stride) {
    static const int32_t FIXED_COEFS[5][4] = {
        {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0},
        {3, -3, 1, 0}, {4, -6, 4, -1}};
    const FrameInfo& fi = d->last_frame;
    long bs = (long)fi.block_size;
    if (fi.channels > 2 || bs > stride) return -2;
    meta[0] = (int32_t)fi.block_size;
    meta[1] = (int32_t)fi.channels;
    meta[2] = (int32_t)fi.channel_assignment;
    meta[3] = (int32_t)fi.bits_per_sample;
    for (uint32_t c = 0; c < 2; ++c) {
        int32_t* rw = resw + (long)c * stride;
        int32_t* cf = coef + c * 32;
        memset(cf, 0, 32 * 4);
        int order = 0, shift = 0, wasted = 0;
        if (c < fi.channels) {
            const SubframeParts& sf = d->last_parts[c];
            wasted = sf.wasted;
            if (sf.type == 0) {
                for (long n = 0; n < bs; ++n) rw[n] = sf.verbatim[0];
            } else if (sf.type == 1) {
                memcpy(rw, sf.verbatim.data(), (size_t)bs * 4);
            } else {
                order = sf.order;
                shift = sf.type == 2 ? 0 : sf.shift;
                if (sf.type == 2)
                    for (int k = 0; k < order; ++k) cf[k] = FIXED_COEFS[order][k];
                else
                    for (int k = 0; k < order; ++k) cf[k] = sf.coeffs[k];
                for (int n = 0; n < order; ++n) rw[n] = sf.warmup[n];
                memcpy(rw + order, sf.residual.data(), (size_t)(bs - order) * 4);
            }
        }
        if (bs < stride || c >= fi.channels)
            memset(rw + (c < fi.channels ? bs : 0), 0,
                   (size_t)(stride - (c < fi.channels ? bs : 0)) * 4);
        meta[4 + (int)c * 3 + 0] = order;
        meta[4 + (int)c * 3 + 1] = shift;
        meta[4 + (int)c * 3 + 2] = wasted;
    }
    meta[10] = meta[11] = 0;
    return 1;
}

// 1 = frame exported, 0 = need more data, -1 = bad stream,
// -2 = frame does not fit (block > stride or >2 channels)
int skt_flac_next_parts(void* h, int32_t* meta, int32_t* resw,
                        int32_t* coef, long stride) {
    auto* d = (FlacDecoder*)h;
    try {
        if (!d->header_done && !d->parse_header()) return 0;
        if (!d->decode_frame(true)) return 0;
    } catch (BadStream& e) {
        snprintf(d->error, sizeof d->error, "%s", e.msg);
        return -1;
    }
    return export_parts_of_last(d, meta, resw, coef, stride);
}

// ---- device-Rice split: the segment wire ----
//
// The device decodes the Rice/fixed-width residual payloads itself
// (ops/flac_rice.py SIMD bitstream interpreter); the host walk only
// locates them.  Wire per frame:
//   meta int32[12]: as the parts wire (const/verbatim export order 0)
//   coef int32[2*32], warm int32[2*32]: LPC coefficients + warmup
//   xmeta int32[8]: c0_const, c0_val, c1_const, c1_val, n_segs,
//                   frame_bytes, max_steps, 0
//   segs int32[seg_cap*4]: per segment (bitoff, k, n, dest) with
//        k >= 0 Rice / k < 0 fixed-width (-k-1 bits); dest indexes the
//        [2*stride] residual plane (c*stride + position)
//   fbytes uint8[max_frame_bytes]: the raw frame
//
// 1 = exported, 0 = need data, -1 = bad stream, -2 = frame decoded but
// does not fit this wire (caller exports it via
// skt_flac_export_parts_last instead)
static int export_segs_of_last(FlacDecoder* d, int32_t* meta, int32_t* coef,
                               int32_t* warm, int32_t* xmeta, int32_t* segs,
                               uint8_t* fbytes, long stride, long seg_cap,
                               long max_frame_bytes) {
    static const int32_t FIXED_COEFS[5][4] = {
        {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0},
        {3, -3, 1, 0}, {4, -6, 4, -1}};
    const FrameInfo& fi = d->last_frame;
    long bs = (long)fi.block_size;
    if (fi.channels > 2 || bs > stride) return -2;
    if ((long)d->last_bytes.size() > max_frame_bytes) return -2;
    long total_segs = 0;
    for (uint32_t c = 0; c < fi.channels; ++c)
        total_segs += (long)d->last_parts[c].segs.size();
    if (total_segs > seg_cap) return -2;
    for (uint32_t c = 0; c < fi.channels; ++c)
        for (const Seg& s : d->last_parts[c].segs)
            if (s.k < 0 && -s.k - 1 > 32) return -2;  // >32-bit reads

    meta[0] = (int32_t)fi.block_size;
    meta[1] = (int32_t)fi.channels;
    meta[2] = (int32_t)fi.channel_assignment;
    meta[3] = (int32_t)fi.bits_per_sample;
    int32_t max_steps = 0;
    long si = 0;
    for (uint32_t c = 0; c < 2; ++c) {
        int32_t* cf = coef + c * 32;
        int32_t* wm = warm + c * 32;
        memset(cf, 0, 32 * 4);
        memset(wm, 0, 32 * 4);
        xmeta[2 * c] = 0;
        xmeta[2 * c + 1] = 0;
        int order = 0, shift = 0, wasted = 0;
        if (c < fi.channels) {
            const SubframeParts& sf = d->last_parts[c];
            wasted = sf.wasted;
            if (sf.type == 0) {  // constant: no segments, value in xmeta
                xmeta[2 * c] = 1;
                xmeta[2 * c + 1] = sf.verbatim[0];
            } else {
                if (sf.type >= 2) {
                    order = sf.order;
                    shift = sf.type == 2 ? 0 : sf.shift;
                    if (sf.type == 2)
                        for (int k = 0; k < order; ++k)
                            cf[k] = FIXED_COEFS[order][k];
                    else
                        for (int k = 0; k < order; ++k) cf[k] = sf.coeffs[k];
                    for (int n = 0; n < order; ++n) wm[n] = sf.warmup[n];
                }
                for (const Seg& s : sf.segs) {
                    segs[si * 4 + 0] = (int32_t)s.bitoff;
                    segs[si * 4 + 1] = s.k;
                    segs[si * 4 + 2] = (int32_t)s.n;
                    segs[si * 4 + 3] = (int32_t)((long)c * stride + s.dest);
                    if ((int32_t)s.steps > max_steps)
                        max_steps = (int32_t)s.steps;
                    ++si;
                }
            }
        }
        meta[4 + (int)c * 3 + 0] = order;
        meta[4 + (int)c * 3 + 1] = shift;
        meta[4 + (int)c * 3 + 2] = wasted;
    }
    meta[10] = meta[11] = 0;
    xmeta[4] = (int32_t)si;
    xmeta[5] = (int32_t)d->last_bytes.size();
    xmeta[6] = max_steps;
    xmeta[7] = 0;
    memcpy(fbytes, d->last_bytes.data(), d->last_bytes.size());
    return 1;
}

int skt_flac_next_segs(void* h, int32_t* meta, int32_t* coef, int32_t* warm,
                       int32_t* xmeta, int32_t* segs, uint8_t* fbytes,
                       long stride, long seg_cap, long max_frame_bytes) {
    auto* d = (FlacDecoder*)h;
    try {
        if (!d->header_done && !d->parse_header()) return 0;
        if (!d->decode_frame(true)) return 0;
    } catch (BadStream& e) {
        snprintf(d->error, sizeof d->error, "%s", e.msg);
        return -1;
    }
    return export_segs_of_last(d, meta, coef, warm, xmeta, segs, fbytes,
                               stride, seg_cap, max_frame_bytes);
}

// ---- round-5 batched serving path: drain at push, export per collect

// walk every complete frame now in the buffer into the export queue
// (segment wire, or the residual-plane fallback for frames the wire
// cannot carry); returns the queued count, -1 on a bad stream
long skt_flac_drain(void* h, long stride, long seg_cap,
                    long max_frame_bytes) {
    auto* d = (FlacDecoder*)h;
    try {
        if (!d->header_done && !d->parse_header())
            return (long)d->queued.size();
        static thread_local std::vector<int32_t> seg_scratch;
        static thread_local std::vector<uint8_t> byte_scratch;
        if ((long)seg_scratch.size() < seg_cap * 4)
            seg_scratch.resize((size_t)seg_cap * 4);
        if ((long)byte_scratch.size() < max_frame_bytes)
            byte_scratch.resize((size_t)max_frame_bytes);
        while (d->decode_frame(true)) {
            QueuedExport q;
            int r = export_segs_of_last(d, q.meta, q.coef, q.warm,
                                        q.xmeta, seg_scratch.data(),
                                        byte_scratch.data(), stride,
                                        seg_cap, max_frame_bytes);
            if (r == 1) {
                q.segs.assign(seg_scratch.begin(),
                              seg_scratch.begin() + (size_t)q.xmeta[4] * 4);
                q.fbytes.assign(byte_scratch.begin(),
                                byte_scratch.begin() + (size_t)q.xmeta[5]);
            } else {
                q.kind = 1;
                q.resw.assign((size_t)2 * stride, 0);
                if (export_parts_of_last(d, q.meta, q.resw.data(), q.coef,
                                         stride) != 1) {
                    snprintf(d->error, sizeof d->error,
                             "frame fits neither wire");
                    return -1;
                }
            }
            d->queued.push_back(std::move(q));
        }
    } catch (BadStream& e) {
        snprintf(d->error, sizeof d->error, "%s", e.msg);
        return -1;
    }
    return (long)d->queued.size();
}

long skt_flac_queued(void* h) {
    return (long)((FlacDecoder*)h)->queued.size();
}

void skt_flac_reset_queue(void* h) {
    ((FlacDecoder*)h)->queued.clear();
}

// stats over the first n queued frames of each of B lanes, for
// sizing the collect's wire: out[0] = max frame bytes, out[1] = max
// device scan steps, out[2] = total segment count, out[3] = count of
// residual-plane fallback frames
void skt_flac_queue_stats(void** handles, int B, long n, int64_t* out) {
    int64_t bmax = 0, smax = 0, totsegs = 0, nparts = 0;
    for (int b = 0; b < B; b++) {
        auto* d = (FlacDecoder*)handles[b];
        long k = (long)d->queued.size();
        if (k > n) k = n;
        for (long i = 0; i < k; i++) {
            const QueuedExport& q = d->queued[i];
            if (q.kind == 1) { nparts++; continue; }
            if ((int64_t)q.fbytes.size() > bmax) bmax = (int64_t)q.fbytes.size();
            if (q.xmeta[6] > smax) smax = q.xmeta[6];
            totsegs += (int64_t)(q.segs.size() / 4);
        }
    }
    out[0] = bmax; out[1] = smax; out[2] = totsegs; out[3] = nparts;
}

// consume up to n queued frames per lane and scatter the WHOLE
// collect's device wire in one call.  Slot j = i*B + b (round i,
// lane b) over L = n_pad*B slots:
//   words [L, W] u32 (big-endian packed frame bytes)
//   seg_* dense global segment arrays (caller-sized from queue_stats,
//     pad rows stay n=0 from np.zeros; dest offset j*2*stride)
//   warm [L,2,32], cflag/cval [L,2], coef [L,2,32], order/shift/
//   wasted [L,2], assign/bs [L] i32, valid [L] u8
//   meta_all [n, B, 12] i32 (parts frames included)
//   parts_*: residual-plane fallback frames appended in encounter
//     order (slot, meta[12], resw[2*stride], coef[2*32])
// returns segments written, or -1 if a frame exceeds the passed W.
long skt_flac_export_rounds(void** handles, int B, long n, long stride,
                            long W, uint32_t* words, int32_t* seg_lane,
                            int32_t* seg_bitoff, int32_t* seg_k,
                            int32_t* seg_n, int32_t* seg_dest,
                            int32_t* warm, int32_t* cflag, int32_t* cval,
                            int32_t* coef, int32_t* order, int32_t* shift,
                            int32_t* wasted, int32_t* assign, int32_t* bs,
                            uint8_t* valid, int32_t* meta_all,
                            int32_t* parts_slot, int32_t* parts_meta,
                            int32_t* parts_resw, int32_t* parts_coef) {
    long si = 0, pi = 0;
    for (int b = 0; b < B; b++) {
        auto* d = (FlacDecoder*)handles[b];
        long k = (long)d->queued.size();
        if (k > n) k = n;
        for (long i = 0; i < k; i++) {
            QueuedExport& q = d->queued.front();
            long j = i * B + b;
            memcpy(meta_all + ((size_t)i * B + b) * 12, q.meta, 12 * 4);
            if (q.kind == 1) {
                parts_slot[pi] = (int32_t)j;
                memcpy(parts_meta + (size_t)pi * 12, q.meta, 12 * 4);
                memcpy(parts_resw + (size_t)pi * 2 * stride, q.resw.data(),
                       (size_t)2 * stride * 4);
                memcpy(parts_coef + (size_t)pi * 64, q.coef, 64 * 4);
                pi++;
                d->queued.pop_front();
                continue;
            }
            long nb = (long)q.fbytes.size();
            if (nb > W * 4) return -1;
            const uint8_t* src = q.fbytes.data();
            uint32_t* dst = words + (size_t)j * W;
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
            long nseg = (long)(q.segs.size() / 4);
            const int32_t* sg = q.segs.data();
            for (long s = 0; s < nseg; s++) {
                seg_lane[si] = (int32_t)j;
                seg_bitoff[si] = sg[s * 4 + 0];
                seg_k[si] = sg[s * 4 + 1];
                seg_n[si] = sg[s * 4 + 2];
                seg_dest[si] = sg[s * 4 + 3] + (int32_t)(j * 2 * stride);
                si++;
            }
            memcpy(warm + (size_t)j * 64, q.warm, 64 * 4);
            memcpy(coef + (size_t)j * 64, q.coef, 64 * 4);
            cflag[j * 2] = q.xmeta[0];
            cval[j * 2] = q.xmeta[1];
            cflag[j * 2 + 1] = q.xmeta[2];
            cval[j * 2 + 1] = q.xmeta[3];
            bs[j] = q.meta[0];
            assign[j] = q.meta[2];
            for (int c = 0; c < 2; c++) {
                order[j * 2 + c] = q.meta[4 + c * 3 + 0];
                shift[j * 2 + c] = q.meta[4 + c * 3 + 1];
                wasted[j * 2 + c] = q.meta[4 + c * 3 + 2];
            }
            valid[j] = 1;
            d->queued.pop_front();
        }
    }
    return si;
}

// export the frame most recently decoded by skt_flac_next_segs via the
// residual-plane wire (the -2 fallback): 1 ok, -2 doesn't fit
int skt_flac_export_parts_last(void* h, int32_t* meta, int32_t* resw,
                               int32_t* coef, long stride) {
    return export_parts_of_last((FlacDecoder*)h, meta, resw, coef, stride);
}

}  // extern "C"
