// Byte-serial decoding for the port's texture loader
// (cge_tpu_torch/scene/image_io.py and the format modules beside it).
//
// The JAX package loads a texture through Pillow. This file holds the parts
// of decoding that run byte by byte, each giving the bytes Pillow 12's
// decoders give; headers, palettes, orientation and colour conversion stay
// in numpy.
//
// JPEG (scene/jpeg.py), as libjpeg-turbo decodes it with Pillow's defaults:
//
//   - baseline and extended sequential Huffman (SOF0, SOF1) and progressive
//     Huffman (SOF2: spectral selection and successive approximation), 8-bit
//     samples, one or three components, restart intervals;
//   - dequantisation and the accurate integer IDCT ("islow", jidctint.c);
//   - "fancy" upsampling of chroma at 4:2:2 (h2v1) and 4:2:0 (h2v2), the
//     triangle filters of jdsample.c with their alternating rounding
//     biases, and plain replication where the chroma is at most 2 samples
//     wide, as jdsample.c chooses;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c; the colour space
//     chosen as jdapimin.c chooses it (JFIF -> YCbCr, Adobe transform 0 ->
//     RGB, transform 1 -> YCbCr, otherwise by the component ids);
//   - grey replicated to RGB, as Pillow's convert("RGB") does.
//
// Anything else raises with the format named: arithmetic coding, lossless
// and hierarchical JPEG, 12-bit samples, two or four components (CMYK,
// YCCK), other samplings (4:4:0, 4:1:1, ...), and progressive files whose
// scans leave a low coefficient unrefined (libjpeg smooths those blocks).
//
// The others, each a loop over a stream that numpy cannot split:
//
//   - PNG row filters (cge_png_unfilter): None, Sub, Up, Average and Paeth;
//   - TGA run-length packets (cge_tga_rle), as Pillow's TgaRleDecode.c;
//   - GIF LZW with its sub-blocks and interlaced rows (cge_gif_lzw), as
//     Pillow's GifDecode.c;
//   - PackBits rows of PSD (cge_packbits), as Pillow's PackDecode.c, and
//     TIFF strips and tiles (one "row" of the whole chunk), as libtiff's
//     PackBitsDecode cuts them;
//   - TIFF LZW (cge_tiff_lzw), as libtiff's LZWDecode: MSB-first codes with
//     the early code-width change, or the old LSB-first codes with the late
//     one (LZWDecodeCompat), told apart by the first two bytes;
//   - TIFF predictors (cge_tiff_predict), as libtiff's tif_predict.c: the
//     horizontal differencing of 8-, 16-, 32- and 64-bit samples (2) and
//     the byte-plane floating point one (3), each row on its own; the
//     samples come out in little-endian order, as libtiff gives them on a
//     little-endian host.
//
// Entry points (C ABI, loaded with ctypes): cge_jpeg_info parses the
// headers and gives the size; cge_jpeg_decode writes [H][W][3] RGB bytes,
// row 0 the top; the others write the bytes their comments name. Each
// returns 0, or -1 with a message in err, and reads no byte past n.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct DecodeError {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
    bool defined = false;
    int32_t maxcode[18];  // largest code of each length, -1 if none
    int32_t valoffset[17];
    uint8_t vals[256];

    void build(const uint8_t* counts, const uint8_t* values, int n) {
        std::memcpy(vals, values, n);
        int32_t code = 0;
        int k = 0;
        for (int len = 1; len <= 16; ++len) {
            valoffset[len] = k - code;
            k += counts[len - 1];
            code += counts[len - 1];
            maxcode[len] = counts[len - 1] ? code - 1 : -1;
            if (code > (1 << len)) fail("corrupt JPEG data: bad Huffman table");
            code <<= 1;
        }
        maxcode[17] = 0x7FFFFFFF;
        defined = true;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int width = 0, height = 0;          // samples of this component
    int bw = 0, bh = 0;                 // blocks stored (whole MCUs)
    int dc_table = 0, ac_table = 0;
    int pred = 0;
    bool latched = false;
    uint16_t quant[64];                 // latched at its first scan
    std::vector<int16_t> coef;          // [bh][bw][64], natural order
    int coef_bits[64];                  // the last Al a coefficient got
};

class Decoder {
  public:
    Decoder(const uint8_t* data, size_t n) : data_(data), n_(n) {}

    void parse_headers();
    void decode(uint8_t* rgb);

    int width = 0, height = 0;

  private:
    const uint8_t* data_;
    size_t n_;
    size_t pos_ = 0;

    uint16_t quant_[4][64];            // natural order
    bool quant_defined_[4] = {false, false, false, false};
    Huffman dc_[4], ac_[4];
    std::vector<Component> comps_;
    int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
    bool progressive_ = false;
    int restart_interval_ = 0;
    bool jfif_ = false, adobe_ = false;
    int adobe_transform_ = -1;
    bool frame_seen_ = false;
    size_t first_scan_ = 0;            // the offset of the first SOS marker

    // entropy-coded segment reader
    uint32_t bitbuf_ = 0;
    int bitcnt_ = 0;
    bool at_marker_ = false;
    int eobrun_ = 0;

    uint8_t byte() {
        if (pos_ >= n_) fail("corrupt JPEG data: premature end of file");
        return data_[pos_++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    int next_marker();
    void read_segment(int marker);
    void read_sof(int marker, size_t end);
    void read_dht(size_t end);
    void read_dqt(size_t end);
    void read_sos(std::vector<Component*>& scomps, int& ss, int& se, int& ah,
                  int& al);
    void decode_scan(const std::vector<Component*>& scomps, int ss, int se,
                     int ah, int al);

    void fill(int need);
    int bits(int n);
    int bit();
    int huff(const Huffman& t);
    static int extend(int v, int s) {
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }
    void restart();

    void block_sequential(Component& c, int16_t* blk);
    void block_dc_first(Component& c, int16_t* blk, int al);
    void block_dc_refine(int16_t* blk, int al);
    void block_ac_first(Component& c, int16_t* blk, int ss, int se, int al);
    void block_ac_refine(Component& c, int16_t* blk, int ss, int se, int al);

    void idct_plane(const Component& c, std::vector<uint8_t>& plane) const;
};

int Decoder::next_marker() {
    // skip anything up to an 0xFF, then fill bytes
    while (true) {
        uint8_t c = byte();
        if (c != 0xFF) continue;
        do {
            c = byte();
        } while (c == 0xFF);
        if (c != 0) return c;
    }
}

void Decoder::parse_headers() {
    if (n_ < 4 || data_[0] != 0xFF || data_[1] != 0xD8)
        fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    while (true) {
        int m = next_marker();
        if (m == 0xDA) {                       // SOS
            if (!frame_seen_) fail("JPEG scan before its frame header");
            first_scan_ = pos_ - 2;
            return;
        }
        if (m == 0xD9) fail("JPEG without a scan (EOI before SOS)");
        read_segment(m);
    }
}

void Decoder::read_segment(int m) {
    if (m >= 0xD0 && m <= 0xD7) return;        // stray RSTn
    if (m == 0x01) return;                     // TEM
    int len = u16();
    if (len < 2 || pos_ + len - 2 > n_)
        fail("corrupt JPEG data: bad marker length");
    size_t end = pos_ + len - 2;
    switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
            read_sof(m, end);
            break;
        case 0xC3:
            fail("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7:
            fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
                 ") is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
            fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
                 ") is not supported");
        case 0xCC:
            fail("arithmetic-coded JPEG (DAC marker) is not supported");
        case 0xC4:
            read_dht(end);
            break;
        case 0xDB:
            read_dqt(end);
            break;
        case 0xDD:
            if (len != 4) fail("corrupt JPEG data: bad DRI length");
            restart_interval_ = u16();
            break;
        case 0xDC:
            fail("JPEG with a DNL marker is not supported");
        case 0xE0:
            if (len >= 7 && std::memcmp(data_ + pos_, "JFIF\0", 5) == 0)
                jfif_ = true;
            break;
        case 0xEE:
            if (len >= 14 && std::memcmp(data_ + pos_, "Adobe", 5) == 0) {
                adobe_ = true;
                adobe_transform_ = data_[pos_ + 11];
            }
            break;
        default:
            break;                             // APPn, COM, ...
    }
    pos_ = end;
}

void Decoder::read_sof(int m, size_t end) {
    if (frame_seen_) fail("corrupt JPEG data: two frame headers");
    frame_seen_ = true;
    progressive_ = m == 0xC2;
    int precision = byte();
    height = u16();
    width = u16();
    int nc = byte();
    if (precision != 8)
        fail(std::to_string(precision) + "-bit JPEG is not supported "
             "(8-bit samples only)");
    if (height == 0) fail("JPEG with height 0 (set by a DNL marker) is "
                          "not supported");
    if (width == 0) fail("corrupt JPEG data: width 0");
    if (nc == 4) fail("4-component JPEG (CMYK or YCCK) is not supported");
    if (nc != 1 && nc != 3)
        fail(std::to_string(nc) + "-component JPEG is not supported");
    if (pos_ + 3 * nc > end) fail("corrupt JPEG data: short SOF");
    comps_.resize(nc);
    for (auto& c : comps_) {
        c.id = byte();
        int hv = byte();
        c.h = hv >> 4;
        c.v = hv & 15;
        c.tq = byte();
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
            fail("corrupt JPEG data: bad component parameters");
    }
    if (nc == 1) comps_[0].h = comps_[0].v = 1;  // one block an MCU
    for (auto& c : comps_) {
        hmax_ = std::max(hmax_, c.h);
        vmax_ = std::max(vmax_, c.v);
    }
    if (nc == 3) {
        // the samplings Pillow writes: 4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2)
        for (auto& c : comps_) {
            int he = hmax_ / c.h, ve = vmax_ / c.v;
            bool ok = hmax_ % c.h == 0 && vmax_ % c.v == 0 &&
                      ((he == 1 && ve == 1) || (he == 2 && ve == 1) ||
                       (he == 2 && ve == 2));
            if (!ok) {
                std::string s;
                for (auto& d : comps_) {
                    if (!s.empty()) s += ",";
                    s += std::to_string(d.h) + "x" + std::to_string(d.v);
                }
                std::string name = (he == 1 && ve == 2) ? " (4:4:0)"
                                   : (he == 4 && ve == 1) ? " (4:1:1)"
                                                          : "";
                fail("JPEG sampling " + s + name + " is not supported "
                     "(4:4:4, 4:2:2 and 4:2:0 only)");
            }
        }
    }
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
        c.width = (width * c.h + hmax_ - 1) / hmax_;
        c.height = (height * c.v + vmax_ - 1) / vmax_;
        c.bw = mcux_ * c.h;
        c.bh = mcuy_ * c.v;
        for (int& b : c.coef_bits) b = -1;
    }
}

void Decoder::read_dht(size_t end) {
    while (pos_ < end) {
        int tc_th = byte();
        int tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) fail("corrupt JPEG data: bad DHT");
        if (pos_ + 16 > end) fail("corrupt JPEG data: short DHT");
        uint8_t counts[16];
        int total = 0;
        for (int i = 0; i < 16; ++i) total += counts[i] = byte();
        if (total > 256 || pos_ + total > end)
            fail("corrupt JPEG data: bad DHT");
        (tc ? ac_ : dc_)[th].build(counts, data_ + pos_, total);
        pos_ += total;
    }
}

void Decoder::read_dqt(size_t end) {
    while (pos_ < end) {
        int pq_tq = byte();
        int pq = pq_tq >> 4, tq = pq_tq & 15;
        if (pq > 1 || tq > 3) fail("corrupt JPEG data: bad DQT");
        for (int k = 0; k < 64; ++k)
            quant_[tq][kNatural[k]] = pq ? u16() : byte();
        quant_defined_[tq] = true;
    }
}

void Decoder::read_sos(std::vector<Component*>& scomps, int& ss, int& se,
                       int& ah, int& al) {
    int len = u16();
    size_t end = pos_ + len - 2;
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
        fail("corrupt JPEG data: bad SOS");
    scomps.clear();
    for (int i = 0; i < ns; ++i) {
        int id = byte(), tables = byte();
        Component* found = nullptr;
        for (auto& c : comps_)
            if (c.id == id) found = &c;
        if (!found) fail("corrupt JPEG data: SOS names no component");
        found->dc_table = tables >> 4;
        found->ac_table = tables & 15;
        if (found->dc_table > 3 || found->ac_table > 3)
            fail("corrupt JPEG data: bad SOS table");
        scomps.push_back(found);
    }
    ss = byte();
    se = byte();
    int a = byte();
    ah = a >> 4;
    al = a & 15;
    pos_ = end;
    if (progressive_) {
        bool bad = ss > se || se > 63 || ah > 13 || al > 13 ||
                   (ss == 0 && se != 0) || (ss > 0 && ns != 1);
        if (bad) fail("corrupt JPEG data: bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        fail("corrupt JPEG data: bad sequential scan parameters");
    }
}

void Decoder::fill(int need) {
    while (bitcnt_ < need) {
        uint32_t c = 0;
        if (!at_marker_ && pos_ < n_) {
            c = data_[pos_];
            if (c == 0xFF) {
                size_t q = pos_ + 1;
                while (q < n_ && data_[q] == 0xFF) ++q;
                if (q < n_ && data_[q] == 0) {
                    pos_ = q + 1;              // stuffed 0xFF
                } else {
                    at_marker_ = true;         // zeros from here on
                    c = 0;
                }
            } else {
                ++pos_;
            }
        }
        bitbuf_ = (bitbuf_ << 8) | c;
        bitcnt_ += 8;
    }
}

int Decoder::bits(int n) {
    if (n == 0) return 0;
    fill(n);
    bitcnt_ -= n;
    return static_cast<int>((bitbuf_ >> bitcnt_) & ((1u << n) - 1));
}

int Decoder::bit() { return bits(1); }

int Decoder::huff(const Huffman& t) {
    if (!t.defined) fail("corrupt JPEG data: a scan uses an undefined "
                         "Huffman table");
    int32_t code = bit();
    int len = 1;
    while (code > t.maxcode[len]) {
        code = (code << 1) | bit();
        if (++len > 16) fail("corrupt JPEG data: bad Huffman code");
    }
    return t.vals[(t.valoffset[len] + code) & 0xFF];
}

void Decoder::restart() {
    bitcnt_ = 0;
    bitbuf_ = 0;
    // on to the RSTn marker, past the segment's padding bits and any fill
    // bytes
    while (pos_ + 1 < n_ &&
           !(data_[pos_] == 0xFF && data_[pos_ + 1] >= 0xD0 &&
             data_[pos_ + 1] <= 0xD7))
        ++pos_;
    if (pos_ + 1 < n_ && data_[pos_] == 0xFF && data_[pos_ + 1] >= 0xD0 &&
        data_[pos_ + 1] <= 0xD7)
        pos_ += 2;
    else
        fail("corrupt JPEG data: a restart marker is missing");
    at_marker_ = false;
    eobrun_ = 0;
    for (auto& c : comps_) c.pred = 0;
}

void Decoder::block_sequential(Component& c, int16_t* blk) {
    int s = huff(dc_[c.dc_table]);
    if (s > 11) fail("corrupt JPEG data: bad DC difference");
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = static_cast<int16_t>(c.pred);
    const Huffman& t = ac_[c.ac_table];
    for (int k = 1; k < 64; ++k) {
        int rs = huff(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail("corrupt JPEG data: AC run past the block");
            blk[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

void Decoder::block_dc_first(Component& c, int16_t* blk, int al) {
    int s = huff(dc_[c.dc_table]);
    if (s > 11) fail("corrupt JPEG data: bad DC difference");
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
}

void Decoder::block_dc_refine(int16_t* blk, int al) {
    if (bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
}

void Decoder::block_ac_first(Component& c, int16_t* blk, int ss, int se,
                             int al) {
    if (eobrun_ > 0) {
        --eobrun_;
        return;
    }
    const Huffman& t = ac_[c.ac_table];
    for (int k = ss; k <= se; ++k) {
        int rs = huff(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail("corrupt JPEG data: AC run past the block");
            int v = extend(bits(s), s);
            blk[kNatural[k]] = static_cast<int16_t>(
                static_cast<int32_t>(static_cast<uint32_t>(v) << al));
        } else if (r == 15) {
            k += 15;
        } else {
            eobrun_ = 1 << r;
            if (r) eobrun_ += bits(r);
            --eobrun_;
            break;
        }
    }
}

// jdphuff.c decode_mcu_AC_refine
void Decoder::block_ac_refine(Component& c, int16_t* blk, int ss, int se,
                              int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    const Huffman& t = ac_[c.ac_table];
    int k = ss;
    if (eobrun_ == 0) {
        for (; k <= se; ++k) {
            int rs = huff(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                if (s != 1) fail("corrupt JPEG data: bad refinement value");
                s = bit() ? p1 : m1;
            } else if (r != 15) {
                eobrun_ = 1 << r;
                if (r) eobrun_ += bits(r);
                break;
            }
            do {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0) {
                    if (bit() && (*coef & p1) == 0)
                        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                                : *coef + m1);
                } else if (--r < 0) {
                    break;
                }
                ++k;
            } while (k <= se);
            if (s) {
                if (k > 63) fail("corrupt JPEG data: AC run past the block");
                blk[kNatural[k]] = static_cast<int16_t>(s);
            }
        }
    }
    if (eobrun_ > 0) {
        for (; k <= se; ++k) {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0 && bit() && (*coef & p1) == 0)
                *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                        : *coef + m1);
        }
        --eobrun_;
    }
}

void Decoder::decode_scan(const std::vector<Component*>& scomps, int ss,
                          int se, int ah, int al) {
    bitbuf_ = 0;
    bitcnt_ = 0;
    at_marker_ = false;
    eobrun_ = 0;
    for (auto& c : comps_) c.pred = 0;
    for (Component* c : scomps) {
        if (!c->latched) {               // as jdinput.c latch_quant_tables
            if (!quant_defined_[c->tq])
                fail("corrupt JPEG data: a component's quantisation table "
                     "is undefined");
            std::memcpy(c->quant, quant_[c->tq], sizeof c->quant);
            c->latched = true;
        }
        for (int k = ss; k <= se; ++k) {
            if (progressive_ && ah != c->coef_bits[k] &&
                !(ah == 0 && c->coef_bits[k] < 0))
                fail("corrupt JPEG data: bad successive approximation");
            c->coef_bits[k] = al;
        }
    }
    auto one = [&](Component& c, int by, int bx) {
        int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
        if (!progressive_) {
            block_sequential(c, blk);
        } else if (ss == 0) {
            if (ah == 0)
                block_dc_first(c, blk, al);
            else
                block_dc_refine(blk, al);
        } else if (ah == 0) {
            block_ac_first(c, blk, ss, se, al);
        } else {
            block_ac_refine(c, blk, ss, se, al);
        }
    };
    int done = 0;
    auto step = [&](int total) {
        ++done;
        if (restart_interval_ && done % restart_interval_ == 0 &&
            done < total)
            restart();
    };
    if (scomps.size() == 1) {
        // a non-interleaved scan covers the component's own blocks only
        Component& c = *scomps[0];
        int nbx = (c.width + 7) / 8, nby = (c.height + 7) / 8;
        for (int by = 0; by < nby; ++by)
            for (int bx = 0; bx < nbx; ++bx) {
                one(c, by, bx);
                step(nbx * nby);
            }
    } else {
        for (int my = 0; my < mcuy_; ++my)
            for (int mx = 0; mx < mcux_; ++mx) {
                for (Component* c : scomps)
                    for (int v = 0; v < c->v; ++v)
                        for (int h = 0; h < c->h; ++h)
                            one(*c, my * c->v + v, mx * c->h + h);
                step(mcux_ * mcuy_);
            }
    }
}

// jidctint.c jpeg_idct_islow, with its range limit table: the output is
// limit[x & 1023] of the descaled value x, where limit clamps x + 128 to
// [0, 255] for x in [-512, 511] and wraps beyond
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
    int i = static_cast<int>(x & 1023);
    if (i < 128) return static_cast<uint8_t>(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return static_cast<uint8_t>(i - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
    int ws[64];
    for (int col = 0; col < 8; ++col) {
        const int16_t* ip = in + col;
        const uint16_t* qp = q + col;
        int* wp = ws + col;
        bool ac_zero = true;
        for (int r = 1; r < 8; ++r) ac_zero = ac_zero && ip[8 * r] == 0;
        if (ac_zero) {
            int dc = static_cast<int>(ip[0] * qp[0]) * (1 << kPass1Bits);
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = int64_t(ip[0]) * qp[0];
        z3 = int64_t(ip[32]) * qp[32];
        int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int64_t(ip[56]) * qp[56];
        tmp1 = int64_t(ip[40]) * qp[40];
        tmp2 = int64_t(ip[24]) * qp[24];
        tmp3 = int64_t(ip[8]) * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = kConstBits - kPass1Bits;
        wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
        wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
        wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
        wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
        wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
        wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
        wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
        wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int row = 0; row < 8; ++row) {
        const int* wp = ws + 8 * row;
        uint8_t* op = out + static_cast<size_t>(row) * stride;
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
        int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        op[0] = idct_limit(descale(tmp10 + tmp3, sh));
        op[7] = idct_limit(descale(tmp10 - tmp3, sh));
        op[1] = idct_limit(descale(tmp11 + tmp2, sh));
        op[6] = idct_limit(descale(tmp11 - tmp2, sh));
        op[2] = idct_limit(descale(tmp12 + tmp1, sh));
        op[5] = idct_limit(descale(tmp12 - tmp1, sh));
        op[3] = idct_limit(descale(tmp13 + tmp0, sh));
        op[4] = idct_limit(descale(tmp13 - tmp0, sh));
    }
}

// The component's samples [height][width], cropped from its blocks.
void Decoder::idct_plane(const Component& c,
                         std::vector<uint8_t>& plane) const {
    const int pw = c.bw * 8;
    std::vector<uint8_t> full(static_cast<size_t>(pw) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64,
                       c.quant,
                       full.data() + static_cast<size_t>(by) * 8 * pw + bx * 8,
                       pw);
    plane.resize(static_cast<size_t>(c.width) * c.height);
    for (int y = 0; y < c.height; ++y)
        std::memcpy(plane.data() + static_cast<size_t>(y) * c.width,
                    full.data() + static_cast<size_t>(y) * pw, c.width);
}

// jdsample.c: a component's samples brought to [height][width] of the
// image. he, ve: 1 or 2 (the supported samplings).
void upsample(const std::vector<uint8_t>& in, int cw, int ch, int he, int ve,
              int width, int height, std::vector<uint8_t>& out) {
    out.resize(static_cast<size_t>(width) * height);
    auto at = [&](int y, int x) -> int {
        return in[static_cast<size_t>(y) * cw + x];
    };
    if (he == 1 && ve == 1) {
        for (int y = 0; y < height; ++y)
            std::memcpy(out.data() + static_cast<size_t>(y) * width,
                        in.data() + static_cast<size_t>(y) * cw, width);
        return;
    }
    // fancy upsampling needs a component more than 2 samples wide;
    // narrower ones are replicated (h2v1_upsample, h2v2_upsample)
    const bool fancy = cw > 2;
    for (int y = 0; y < height; ++y) {
        int iy = ve == 2 ? y / 2 : y;
        // h2v2: the row above for even output rows, below for odd ones,
        // the edge rows repeated
        int ny = iy;
        if (ve == 2) ny = (y % 2 == 0) ? std::max(iy - 1, 0)
                                       : std::min(iy + 1, ch - 1);
        uint8_t* op = out.data() + static_cast<size_t>(y) * width;
        for (int x = 0; x < width; ++x) {
            int ix = x / 2;
            int v;
            if (!fancy) {
                v = at(iy, ix);
            } else if (ve == 1) {               // h2v1_fancy_upsample
                int nx = (x % 2 == 0) ? std::max(ix - 1, 0)
                                      : std::min(ix + 1, cw - 1);
                v = (3 * at(iy, ix) + at(iy, nx) + (x % 2 == 0 ? 1 : 2)) >> 2;
            } else {                            // h2v2_fancy_upsample
                int nx = (x % 2 == 0) ? std::max(ix - 1, 0)
                                      : std::min(ix + 1, cw - 1);
                int thiscol = 3 * at(iy, ix) + at(ny, ix);
                int othercol = 3 * at(iy, nx) + at(ny, nx);
                v = (3 * thiscol + othercol + (x % 2 == 0 ? 8 : 7)) >> 4;
            }
            op[x] = static_cast<uint8_t>(v);
        }
    }
}

void Decoder::decode(uint8_t* rgb) {
    for (auto& c : comps_)
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    pos_ = first_scan_;
    bool scanned = false;
    while (pos_ < n_) {                         // a missing EOI ends it too
        int m = next_marker();
        if (m == 0xD9) break;                   // EOI
        if (m == 0xDA) {
            std::vector<Component*> scomps;
            int ss = 0, se = 0, ah = 0, al = 0;
            read_sos(scomps, ss, se, ah, al);
            decode_scan(scomps, ss, se, ah, al);
            scanned = true;
            // on to the next marker, past the scan's last bytes
            bitcnt_ = 0;
            continue;
        }
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC)
            fail("corrupt JPEG data: a second frame header");
        read_segment(m);
    }
    if (!scanned) fail("JPEG without a scan");
    for (auto& c : comps_) {
        if (c.coef_bits[0] < 0)
            fail("corrupt JPEG data: a component's DC was never coded");
        if (progressive_)
            for (int k = 1; k < 10; ++k)
                if (c.coef_bits[k] != 0)
                    fail("progressive JPEG whose scans leave a low "
                         "coefficient unrefined (libjpeg's block smoothing) "
                         "is not supported");
    }
    std::vector<std::vector<uint8_t>> planes(comps_.size());
    for (size_t i = 0; i < comps_.size(); ++i) {
        std::vector<uint8_t> plane;
        const Component& c = comps_[i];
        idct_plane(c, plane);
        upsample(plane, c.width, c.height, hmax_ / c.h, vmax_ / c.v, width,
                 height, planes[i]);
    }
    const size_t npx = static_cast<size_t>(width) * height;
    if (comps_.size() == 1) {
        for (size_t i = 0; i < npx; ++i)
            rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = planes[0][i];
        return;
    }
    bool ycc;
    if (jfif_) {
        ycc = true;
    } else if (adobe_) {
        ycc = adobe_transform_ != 0;
    } else {
        ycc = !(comps_[0].id == 'R' && comps_[1].id == 'G' &&
                comps_[2].id == 'B');
    }
    if (!ycc) {
        for (size_t i = 0; i < npx; ++i)
            for (int k = 0; k < 3; ++k) rgb[3 * i + k] = planes[k][i];
        return;
    }
    // jdcolor.c build_ycc_rgb_table and ycc_rgb_convert
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
        cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) {
        return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    for (size_t i = 0; i < npx; ++i) {
        int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
        rgb[3 * i] = clamp(y + cr_r[cr]);
        rgb[3 * i + 1] =
            clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
        rgb[3 * i + 2] = clamp(y + cb_b[cb]);
    }
}

// PNG spec section 9: rows [height][1 + stride] in, [height][stride] out.
void png_unfilter(const uint8_t* raw, size_t n, int height, size_t stride,
                  int bpp, uint8_t* out) {
    if (height < 0 || bpp < 1) fail("bad PNG row geometry");
    if (static_cast<size_t>(height) * (stride + 1) > n)
        fail("PNG image data is truncated");
    std::vector<uint8_t> zero(stride, 0);
    const uint8_t* prior = zero.data();
    const size_t b = static_cast<size_t>(bpp);
    for (int y = 0; y < height; ++y) {
        const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
        const int kind = line[0];
        ++line;
        uint8_t* cur = out + static_cast<size_t>(y) * stride;
        switch (kind) {
        case 0:
            std::memcpy(cur, line, stride);
            break;
        case 1:
            for (size_t x = 0; x < stride; ++x)
                cur[x] = static_cast<uint8_t>(line[x] +
                                              (x >= b ? cur[x - b] : 0));
            break;
        case 2:
            for (size_t x = 0; x < stride; ++x)
                cur[x] = static_cast<uint8_t>(line[x] + prior[x]);
            break;
        case 3:
            for (size_t x = 0; x < stride; ++x) {
                const int a = x >= b ? cur[x - b] : 0;
                cur[x] = static_cast<uint8_t>(line[x] + ((a + prior[x]) >> 1));
            }
            break;
        case 4:
            for (size_t x = 0; x < stride; ++x) {
                const int a = x >= b ? cur[x - b] : 0;
                const int up = prior[x];
                const int c = x >= b ? prior[x - b] : 0;
                const int p = a + up - c;
                const int pa = std::abs(p - a), pb = std::abs(p - up),
                          pc = std::abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : pb <= pc ? up : c;
                cur[x] = static_cast<uint8_t>(line[x] + pred);
            }
            break;
        default:
            fail("PNG row " + std::to_string(y) + " has unknown filter type " +
                 std::to_string(kind));
        }
        prior = cur;
    }
}

// Pillow's TgaRleDecode.c: rows of row_bytes in stream order. A run packet
// must end within its row (Pillow: buffer overrun); a literal packet flows
// on into the next rows. Bytes past the last row are not read.
void tga_rle(const uint8_t* data, size_t n, size_t pos, int depth,
             size_t row_bytes, int rows, uint8_t* out) {
    if (depth < 1 || depth > 4 || rows < 0 || row_bytes == 0)
        fail("bad TGA RLE geometry");
    const size_t total = row_bytes * static_cast<size_t>(rows);
    size_t done = 0;  // bytes written
    while (done < total) {
        if (pos >= n) fail("TGA image data is truncated");
        const size_t count =
            static_cast<size_t>((data[pos] & 0x7F) + 1) * depth;
        const size_t x = done % row_bytes;
        if (data[pos] & 0x80) {
            if (pos + 1 + depth > n) fail("TGA image data is truncated");
            if (x + count > row_bytes)
                fail("a TGA run-length packet runs past the end of its row");
            for (size_t i = 0; i < count; i += depth)
                std::memcpy(out + done + i, data + pos + 1, depth);
            done += count;
            pos += 1 + depth;
        } else {
            if (pos + 1 + count > n) fail("TGA image data is truncated");
            const size_t take = std::min(count, total - done);
            std::memcpy(out + done, data + pos + 1, take);
            done += take;
            pos += 1 + count;
        }
    }
}

// Pillow's PackDecode.c: rows of row_bytes in stream order; a packet that
// runs past its row's end is cut there, and 0x80 is a no-op.
void packbits(const uint8_t* data, size_t n, size_t pos, size_t row_bytes,
              int rows, uint8_t* out) {
    if (rows < 0 || row_bytes == 0) fail("bad PackBits geometry");
    for (int y = 0; y < rows; ++y) {
        uint8_t* row = out + static_cast<size_t>(y) * row_bytes;
        size_t x = 0;
        while (x < row_bytes) {
            if (pos >= n) fail("PackBits data is truncated");
            const int head = data[pos];
            if (head == 0x80) {
                ++pos;
            } else if (head & 0x80) {
                if (pos + 2 > n) fail("PackBits data is truncated");
                const size_t count =
                    std::min<size_t>(257 - head, row_bytes - x);
                std::memset(row + x, data[pos + 1], count);
                x += count;
                pos += 2;
            } else {
                const size_t count = head + 1;
                if (pos + 1 + count > n) fail("PackBits data is truncated");
                const size_t take = std::min(count, row_bytes - x);
                std::memcpy(row + x, data + pos + 1, take);
                x += take;
                pos += 1 + count;
            }
        }
    }
}

// Pillow's GifDecode.c: the LZW codes of the sub-blocks from pos (just past
// the minimum code size), written as indices (the code's low byte) into
// out [height][width] in row order, or in the four interlaced passes.
// Codes are read until the last row is full; an end code, a terminator or
// the end of the file before that is an error, as in Pillow.
void gif_lzw(const uint8_t* data, size_t n, size_t pos, int bits, int width,
             int height, bool interlace, uint8_t* out) {
    if (bits < 0 || bits > 12 || width <= 0 || height <= 0)
        fail("bad GIF image geometry");
    const int kTable = 4096;
    std::vector<uint16_t> prefix(kTable), length(kTable);
    std::vector<uint8_t> suffix(kTable), first(kTable), stack(kTable);
    const int clear = 1 << bits, end = clear + 1;
    for (int c = 0; c < clear && c < kTable; ++c) {
        suffix[c] = first[c] = static_cast<uint8_t>(c);
        length[c] = 1;
    }
    int width_bits = bits + 1, next = end + 1, prev = -1;
    // the output cursor
    int x = 0, y = 0, pass = 0, step = interlace ? 8 : 1;
    auto emit = [&](uint8_t v) -> bool {  // true once the last row is full
        out[static_cast<size_t>(y) * width + x] = v;
        if (++x < width) return false;
        x = 0;
        y += step;
        while (y >= height) {
            if (!interlace || pass == 3) return true;
            static const int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
            ++pass;
            y = kStart[pass];
            step = kStep[pass];
        }
        return false;
    };
    uint32_t acc = 0;
    int nbits = 0;
    size_t block_left = 0;
    for (;;) {
        // fill the bit buffer from the sub-blocks
        while (nbits < width_bits) {
            if (block_left == 0) {
                if (pos >= n) fail("GIF image data is truncated");
                block_left = data[pos++];
                // Pillow decodes a sub-block only once all of it is there
                if (block_left == 0 || block_left > n - pos)
                    fail("GIF image data is truncated");
            }
            acc |= static_cast<uint32_t>(data[pos++]) << nbits;
            nbits += 8;
            --block_left;
        }
        const int code = static_cast<int>(acc & ((1u << width_bits) - 1));
        acc >>= width_bits;
        nbits -= width_bits;
        if (code == clear) {
            width_bits = bits + 1;
            next = end + 1;
            prev = -1;
            continue;
        }
        if (code == end) fail("GIF image data ends before its last pixel");
        int top = 0;
        if (prev < 0) {
            if (code > clear) fail("broken GIF data stream");
            stack[top++] = static_cast<uint8_t>(code);
        } else {
            if (code > next || (code == next && next >= kTable))
                fail("broken GIF data stream");
            int c = code;
            if (code == next) {  // KwKwK: prev's string and its first byte
                stack[top++] = first[prev];
                c = prev;
            }
            while (c >= clear) {
                if (c >= kTable || top >= kTable)
                    fail("broken GIF data stream");
                stack[top++] = suffix[c];
                c = prefix[c];
            }
            if (top >= kTable) fail("broken GIF data stream");
            stack[top++] = static_cast<uint8_t>(c);
            if (next < kTable) {
                prefix[next] = static_cast<uint16_t>(prev);
                suffix[next] = static_cast<uint8_t>(c);
                first[next] = first[prev];
                ++next;
                if (next == (1 << width_bits) && width_bits < 12) ++width_bits;
            }
        }
        while (top > 0)
            if (emit(stack[--top])) return;
        prev = code;
    }
}

// libtiff's LZWDecode: the codes of data[0, n) until out holds out_n
// bytes. New-style streams (a Clear code first, MSB-first) widen their
// codes one entry early; old-style ones (first bytes 0x00 and an odd
// byte: a Clear code LSB-first) on the entry itself.
void tiff_lzw(const uint8_t* data, size_t n, uint8_t* out, size_t out_n) {
    const bool compat = n >= 2 && data[0] == 0 && (data[1] & 1);
    const int kClear = 256, kEnd = 257, kTable = 4096;
    std::vector<uint16_t> prefix(kTable), length(kTable);
    std::vector<uint8_t> suffix(kTable), first(kTable);
    for (int c = 0; c < 256; ++c) {
        suffix[c] = first[c] = static_cast<uint8_t>(c);
        length[c] = 1;
    }
    int width = 9, next = 258, prev = -1;
    const int late = compat ? 1 : 0;
    uint64_t acc = 0;
    int nbits = 0;
    size_t pos = 0, done = 0;
    while (done < out_n) {
        while (nbits < width) {
            if (pos >= n) fail("TIFF LZW data ends before its strip is full");
            if (compat)
                acc |= static_cast<uint64_t>(data[pos++]) << nbits;
            else
                acc = (acc << 8) | data[pos++];
            nbits += 8;
        }
        int code;
        if (compat) {
            code = static_cast<int>(acc & ((1u << width) - 1));
            acc >>= width;
        } else {
            code = static_cast<int>((acc >> (nbits - width)) &
                                    ((1u << width) - 1));
        }
        nbits -= width;
        if (!compat) acc &= (static_cast<uint64_t>(1) << nbits) - 1;
        if (code == kClear) {
            width = 9;
            next = 258;
            prev = -1;
            continue;
        }
        if (code == kEnd) fail("TIFF LZW data ends before its strip is full");
        int c = code;
        if (prev < 0) {
            if (code > 255) fail("TIFF LZW code not yet in its table");
        } else {
            if (code > next || next >= kTable)
                fail("TIFF LZW code not yet in its table");
            prefix[next] = static_cast<uint16_t>(prev);
            first[next] = first[prev];
            length[next] = static_cast<uint16_t>(length[prev] + 1);
            suffix[next] = code == next ? first[prev] : first[code];
            ++next;
            if (next + 1 - late >= (1 << width) && width < 12) ++width;
        }
        // write the string of c, cut where the strip is full
        const size_t len = length[c];
        const size_t take = std::min(len, out_n - done);
        for (size_t i = len; i-- > 0;) {
            if (i < take) out[done + i] = suffix[c];
            c = prefix[c];
        }
        done += take;
        prev = code;
    }
}

// libtiff's horizontal (2) and floating point (3) predictors, undone in
// place on rows of row_bytes; stride is in samples.
void tiff_predict(uint8_t* buf, int rows, size_t row_bytes, int bits,
                  int stride, int predictor, bool big_endian) {
    if (rows < 0 || stride < 1) fail("bad TIFF predictor geometry");
    const int bps = bits / 8;
    if (predictor == 2) {
        if (bits != 8 && bits != 16 && bits != 32 && bits != 64)
            fail("TIFF horizontal predictor on " + std::to_string(bits) +
                 "-bit samples: libtiff takes 8, 16, 32 and 64");
        const size_t wc = row_bytes / bps;
        for (int y = 0; y < rows; ++y) {
            uint8_t* row = buf + static_cast<size_t>(y) * row_bytes;
            std::vector<uint64_t> v(wc);
            for (size_t i = 0; i < wc; ++i) {
                uint64_t x = 0;
                for (int b = 0; b < bps; ++b) {
                    const int shift = big_endian ? 8 * (bps - 1 - b) : 8 * b;
                    x |= static_cast<uint64_t>(row[i * bps + b]) << shift;
                }
                v[i] = x;
            }
            const uint64_t mask =
                bits == 64 ? ~static_cast<uint64_t>(0)
                           : (static_cast<uint64_t>(1) << bits) - 1;
            for (size_t i = stride; i < wc; ++i) v[i] = (v[i] + v[i - stride]) & mask;
            for (size_t i = 0; i < wc; ++i)
                for (int b = 0; b < bps; ++b)
                    row[i * bps + b] = static_cast<uint8_t>(v[i] >> (8 * b));
        }
    } else if (predictor == 3) {
        if (bits != 16 && bits != 24 && bits != 32 && bits != 64)
            fail("TIFF floating point predictor on " + std::to_string(bits) +
                 "-bit samples");
        const size_t wc = row_bytes / bps;
        if (row_bytes % (static_cast<size_t>(bps) * stride))
            fail("TIFF floating point predictor on a row of " +
                 std::to_string(row_bytes) + " bytes");
        std::vector<uint8_t> tmp(row_bytes);
        for (int y = 0; y < rows; ++y) {
            uint8_t* row = buf + static_cast<size_t>(y) * row_bytes;
            for (size_t i = stride; i < row_bytes; ++i)
                row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
            std::memcpy(tmp.data(), row, row_bytes);
            for (size_t i = 0; i < wc; ++i)
                for (int b = 0; b < bps; ++b)
                    row[bps * i + b] = tmp[(bps - b - 1) * wc + i];
        }
    } else {
        fail("TIFF predictor " + std::to_string(predictor) +
             ": libtiff knows 1, 2 and 3");
    }
}

void copy_error(const std::string& what, char* err, int errlen) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", what.c_str());
}

// Runs body; 0, or -1 with the message of what it threw in err.
template <class Body>
int guarded(char* err, int errlen, Body body) {
    try {
        body();
        return 0;
    } catch (const DecodeError& e) {
        copy_error(e.what, err, errlen);
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
    }
    return -1;
}

}  // namespace

extern "C" {

int cge_jpeg_info(const unsigned char* data, long n, int* width, int* height,
                  char* err, int errlen) {
    return guarded(err, errlen, [&] {
        Decoder d(data, static_cast<size_t>(n));
        d.parse_headers();
        *width = d.width;
        *height = d.height;
    });
}

int cge_jpeg_decode(const unsigned char* data, long n, unsigned char* rgb,
                    long capacity, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        Decoder d(data, static_cast<size_t>(n));
        d.parse_headers();
        if (static_cast<long>(d.width) * d.height * 3 > capacity)
            fail("the output buffer is too small");
        d.decode(rgb);
    });
}

int cge_png_unfilter(const unsigned char* raw, long n, int height,
                     long stride, int bpp, unsigned char* out, char* err,
                     int errlen) {
    return guarded(err, errlen, [&] {
        png_unfilter(raw, static_cast<size_t>(n), height,
                     static_cast<size_t>(stride), bpp, out);
    });
}

int cge_tga_rle(const unsigned char* data, long n, long offset, int depth,
                long row_bytes, int rows, unsigned char* out, char* err,
                int errlen) {
    return guarded(err, errlen, [&] {
        tga_rle(data, static_cast<size_t>(n), static_cast<size_t>(offset),
                depth, static_cast<size_t>(row_bytes), rows, out);
    });
}

int cge_packbits(const unsigned char* data, long n, long offset,
                 long row_bytes, int rows, unsigned char* out, char* err,
                 int errlen) {
    return guarded(err, errlen, [&] {
        packbits(data, static_cast<size_t>(n), static_cast<size_t>(offset),
                 static_cast<size_t>(row_bytes), rows, out);
    });
}

int cge_gif_lzw(const unsigned char* data, long n, long offset, int bits,
                int width, int height, int interlace, unsigned char* out,
                char* err, int errlen) {
    return guarded(err, errlen, [&] {
        gif_lzw(data, static_cast<size_t>(n), static_cast<size_t>(offset),
                bits, width, height, interlace != 0, out);
    });
}

int cge_tiff_lzw(const unsigned char* data, long n, unsigned char* out,
                 long out_n, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        tiff_lzw(data, static_cast<size_t>(n), out, static_cast<size_t>(out_n));
    });
}

int cge_tiff_predict(unsigned char* buf, int rows, long row_bytes, int bits,
                     int stride, int predictor, int big_endian, char* err,
                     int errlen) {
    return guarded(err, errlen, [&] {
        tiff_predict(buf, rows, static_cast<size_t>(row_bytes), bits, stride,
                     predictor, big_endian != 0);
    });
}

}  // extern "C"
