// WebP decoding for the port's texture loader (cge_tpu_torch/scene/webp.py).
//
// The JAX package opens a WebP texture through Pillow, which decodes it with
// libwebp's animation decoder into RGBA (not premultiplied) and drops the
// alpha in convert("RGB"). This file gives the same bytes for the three
// bitstreams a WebP file carries; the RIFF chunks are walked in webp.py.
//
// VP8L, lossless (the WebP lossless bitstream specification):
//
//   - the 5-byte header, transforms (predictor with its 14 modes,
//     cross-colour, subtract-green, colour indexing with pixel bundling),
//     applied in reverse order;
//   - simple and normal prefix codes (a code must be complete, or have a
//     single symbol, which takes no bits), the meta prefix-code image, the
//     colour cache and LZ77 backward references with the 120-entry
//     distance map.
//
// VP8, lossy key frames (RFC 6386, as libwebp decodes them):
//
//   - libwebp's boolean decoder, segment and filter headers, token
//     partitions, token probabilities and their updates, skip flags;
//   - coefficient contexts and bands, dequantisation (the DC and AC
//     tables, the Y2 factors with their clamps), the inverse WHT and the
//     20091/35468 IDCT;
//   - 16x16, 4x4 (B_PRED, with the above-right rule) and chroma prediction
//     against libwebp's borders (127 above the frame, 129 left of it);
//   - the simple and normal loop filters over the whole frame after
//     reconstruction, in macroblock order, with their per-segment levels,
//     deltas and sharpness; inner edges are filtered where the macroblock
//     is 4x4-predicted or has a non-zero coefficient;
//   - libwebp's output to RGBA: the "fancy" 2x chroma upsampler and the
//     fixed-point YUV -> RGB of its dsp/yuv.h, on the cropped frame.
//
// ALPH (the alpha of a lossy image): raw or VP8L-coded (the green channel
// of a headerless VP8L image), filters none, horizontal, vertical and
// gradient.
//
// Entry points (C ABI): cge_webp_vp8 and cge_webp_vp8l write [h][w][4]
// RGBA bytes (alpha 255 for VP8), cge_webp_alph writes the alpha byte of
// each pixel of such a buffer. Each returns 0, or -1 with a message in err,
// reads no byte past n, and fails on a stream that ends early.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct WebpError {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw WebpError{what}; }

// ---------------------------------------------------------------- VP8L ----

// LSB-first bits; reading past the last byte fails (libwebp's decoder
// refuses a stream it has read past the end of).
class LBits {
 public:
    LBits(const uint8_t* d, size_t n) : d_(d), n_(n) {}

    uint32_t read(int k) {
        if (pos_ + static_cast<size_t>(k) > 8 * n_)
            fail("VP8L data is truncated");
        uint32_t v = 0;
        for (int i = 0; i < k;) {
            const int off = static_cast<int>(pos_ & 7);
            const int take = std::min(8 - off, k - i);
            v |= ((static_cast<uint32_t>(d_[pos_ >> 3]) >> off) &
                  ((1u << take) - 1))
                 << i;
            i += take;
            pos_ += take;
        }
        return v;
    }

 private:
    const uint8_t* d_;
    size_t n_;
    size_t pos_ = 0;
};

// A canonical prefix code, read MSB of the code first.
struct Prefix {
    int single = -1;  // the one symbol of a zero-bit code
    uint16_t count[16] = {0};
    std::vector<uint16_t> symbols;

    // False where libwebp's VP8LBuildHuffmanTable refuses the lengths: all
    // zero, over-subscribed, or incomplete with more than one symbol.
    bool build(const std::vector<int>& lengths) {
        std::fill(count, count + 16, 0);
        int used = 0;
        for (int l : lengths) {
            if (l > 15) return false;
            ++count[l];
            if (l) ++used;
        }
        if (used == 0) return false;
        symbols.clear();
        if (used == 1) {
            for (size_t s = 0; s < lengths.size(); ++s)
                if (lengths[s]) single = static_cast<int>(s);
            return true;
        }
        long open = 1;
        for (int len = 1; len < 16; ++len) {
            open = 2 * open - count[len];
            if (open < 0) return false;
        }
        if (open != 0) return false;
        for (int len = 1; len < 16; ++len)
            for (size_t s = 0; s < lengths.size(); ++s)
                if (lengths[s] == len) symbols.push_back(static_cast<uint16_t>(s));
        return true;
    }

    int decode(LBits& br) const {
        if (single >= 0) return single;
        int code = 0, first = 0, index = 0;
        for (int len = 1; len < 16; ++len) {
            code |= static_cast<int>(br.read(1));
            const int c = count[len];
            if (code - first < c) return symbols[index + code - first];
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        fail("broken VP8L prefix code");
    }
};

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

// distance code -> (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112
};

inline int subsample(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int channel(uint32_t v, int shift) { return (v >> shift) & 0xff; }

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
    int d = 0;  // sum |L - TL| - |T - TL|
    for (int s = 0; s < 32; s += 8)
        d += std::abs(channel(l, s) - channel(tl, s)) -
             std::abs(channel(t, s) - channel(tl, s));
    return d <= 0 ? t : l;
}

uint32_t clamped_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
        out |= static_cast<uint32_t>(
                   clip255(channel(a, s) + channel(b, s) - channel(c, s)))
               << s;
    return out;
}

uint32_t clamped_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int x = channel(a, s), y = channel(b, s);
        out |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
    }
    return out;
}

// The predictor of mode m for pixel p of a row (top = p - width).
uint32_t predict(int m, const uint32_t* p, int width) {
    const uint32_t l = p[-1], t = p[-width], tl = p[-width - 1],
                   tr = p[-width + 1];
    switch (m) {
        case 1: return l;
        case 2: return t;
        case 3: return tr;
        case 4: return tl;
        case 5: return average2(average2(l, tr), t);
        case 6: return average2(l, tl);
        case 7: return average2(l, t);
        case 8: return average2(tl, t);
        case 9: return average2(t, tr);
        case 10: return average2(average2(l, tl), average2(t, tr));
        case 11: return select_pred(t, l, tl);
        case 12: return clamped_full(l, t, tl);
        case 13: return clamped_half(average2(l, t), tl);
        default: return 0xff000000u;  // 0, 14 and 15: black
    }
}

struct Transform {
    int type;
    int bits;
    int xsize;  // the width the transform's output has
    std::vector<uint32_t> data;
};

class Lossless {
 public:
    Lossless(const uint8_t* d, size_t n) : br_(d, n) {}

    // The image of a headerless stream (level 0: transforms and a meta
    // prefix-code image allowed) of width x height pixels, as ARGB.
    std::vector<uint32_t> decode(int width, int height) {
        std::vector<Transform> transforms;
        int xsize = width;
        unsigned seen = 0;
        while (br_.read(1)) {
            Transform t;
            t.type = static_cast<int>(br_.read(2));
            if (seen & (1u << t.type)) fail("VP8L transform repeated");
            seen |= 1u << t.type;
            t.xsize = xsize;
            t.bits = 0;
            if (t.type == 0 || t.type == 1) {
                t.bits = static_cast<int>(br_.read(3)) + 2;
                t.data = stream(subsample(xsize, t.bits),
                                subsample(height, t.bits), false);
            } else if (t.type == 3) {
                const int colors = static_cast<int>(br_.read(8)) + 1;
                t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
                std::vector<uint32_t> pal = stream(colors, 1, false);
                t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
                t.data[0] = pal[0];
                for (int i = 1; i < colors; ++i)
                    t.data[i] = add_pixels(pal[i], t.data[i - 1]);
                xsize = subsample(xsize, t.bits);
            }
            transforms.push_back(std::move(t));
        }
        std::vector<uint32_t> px = stream(xsize, height, true);
        for (size_t k = transforms.size(); k-- > 0;)
            px = inverse(transforms[k], px, height);
        return px;
    }

 private:
    struct Group {
        Prefix code[5];  // green + lengths + cache, red, blue, alpha, distance
    };

    LBits br_;

    void read_code(Prefix& code, int alphabet) {
        std::vector<int> lengths(alphabet, 0);
        if (br_.read(1)) {  // simple code: one or two symbols of length 1
            const int n = static_cast<int>(br_.read(1)) + 1;
            const int first = static_cast<int>(br_.read(br_.read(1) ? 8 : 1));
            if (first < alphabet) lengths[first] = 1;
            if (n == 2) {
                const int second = static_cast<int>(br_.read(8));
                if (second < alphabet) lengths[second] = 1;
            }
        } else {
            std::vector<int> cl(19, 0);
            const int n = static_cast<int>(br_.read(4)) + 4;
            for (int i = 0; i < n; ++i)
                cl[kCodeLengthOrder[i]] = static_cast<int>(br_.read(3));
            Prefix lc;
            if (!lc.build(cl)) fail("broken VP8L code-length code");
            int max_symbol = alphabet;
            if (br_.read(1)) {
                const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
                max_symbol = 2 + static_cast<int>(br_.read(nbits));
                if (max_symbol > alphabet)
                    fail("VP8L code lengths past the alphabet");
            }
            int prev = 8, symbol = 0;
            while (symbol < alphabet) {
                if (max_symbol-- == 0) break;
                const int len = lc.decode(br_);
                if (len < 16) {
                    lengths[symbol++] = len;
                    if (len) prev = len;
                } else {
                    static const int kExtra[3] = {2, 3, 7},
                                     kOffset[3] = {3, 3, 11};
                    const int slot = len - 16;
                    const int repeat =
                        static_cast<int>(br_.read(kExtra[slot])) + kOffset[slot];
                    if (symbol + repeat > alphabet)
                        fail("VP8L code lengths past the alphabet");
                    const int v = len == 16 ? prev : 0;
                    for (int r = 0; r < repeat; ++r) lengths[symbol++] = v;
                }
            }
        }
        if (!code.build(lengths)) fail("broken VP8L prefix code");
    }

    int copy_distance(int symbol) {
        if (symbol < 4) return symbol + 1;
        const int extra = (symbol - 2) >> 1;
        const int offset = (2 + (symbol & 1)) << extra;
        return offset + static_cast<int>(br_.read(extra)) + 1;
    }

    // An entropy-coded image of xsize x ysize (a sub-image where !level0).
    std::vector<uint32_t> stream(int xsize, int ysize, bool level0) {
        int cache_bits = 0;
        if (br_.read(1)) {
            cache_bits = static_cast<int>(br_.read(4));
            if (cache_bits < 1 || cache_bits > 11)
                fail("VP8L colour cache of " + std::to_string(cache_bits) +
                     " bits");
        }
        int meta_bits = 0, meta_xsize = 1;
        std::vector<uint32_t> meta;
        int groups = 1;
        if (level0 && br_.read(1)) {
            meta_bits = static_cast<int>(br_.read(3)) + 2;
            meta_xsize = subsample(xsize, meta_bits);
            meta = stream(meta_xsize, subsample(ysize, meta_bits), false);
            for (uint32_t& m : meta) {
                m = (m >> 8) & 0xffff;
                groups = std::max(groups, static_cast<int>(m) + 1);
            }
        }
        const int cache_size = cache_bits ? 1 << cache_bits : 0;
        std::vector<Group> group(groups);
        for (Group& g : group) {
            static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
            for (int j = 0; j < 5; ++j)
                read_code(g.code[j], kAlphabet[j] + (j == 0 ? cache_size : 0));
        }
        const size_t total = static_cast<size_t>(xsize) * ysize;
        std::vector<uint32_t> px(total);
        std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
        size_t cached = 0, pos = 0;
        auto flush_cache = [&]() {
            if (!cache_size) return;
            for (; cached < pos; ++cached)
                cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] =
                    px[cached];
        };
        while (pos < total) {
            const int x = static_cast<int>(pos % xsize),
                      y = static_cast<int>(pos / xsize);
            const Group& g =
                group[meta.empty() ? 0
                                   : meta[static_cast<size_t>(y >> meta_bits) *
                                              meta_xsize +
                                          (x >> meta_bits)]];
            const int code = g.code[0].decode(br_);
            if (code < 256) {
                const uint32_t r = g.code[1].decode(br_);
                const uint32_t b = g.code[2].decode(br_);
                const uint32_t a = g.code[3].decode(br_);
                px[pos++] = (a << 24) | (r << 16) |
                            (static_cast<uint32_t>(code) << 8) | b;
            } else if (code < 256 + 24) {
                const int length = copy_distance(code - 256);
                const int dcode = copy_distance(g.code[4].decode(br_));
                int dist;
                if (dcode > 120) {
                    dist = dcode - 120;
                } else {
                    const int p = kCodeToPlane[dcode - 1];
                    dist = (p >> 4) * xsize + (8 - (p & 0xf));
                    if (dist < 1) dist = 1;
                }
                if (static_cast<size_t>(dist) > pos ||
                    total - pos < static_cast<size_t>(length))
                    fail("VP8L backward reference out of the image");
                for (int i = 0; i < length; ++i, ++pos) px[pos] = px[pos - dist];
            } else {
                if (code - 280 >= cache_size) fail("broken VP8L data");
                flush_cache();
                px[pos++] = cache[code - 280];
            }
            flush_cache();
        }
        return px;
    }

    std::vector<uint32_t> inverse(const Transform& t,
                                  const std::vector<uint32_t>& in,
                                  int height) {
        const int w = t.xsize;
        if (t.type == 2) {  // subtract green
            std::vector<uint32_t> out(in);
            for (uint32_t& v : out) {
                const uint32_t g = (v >> 8) & 0xff;
                const uint32_t rb = (v & 0x00ff00ffu) + ((g << 16) | g);
                v = (v & 0xff00ff00u) | (rb & 0x00ff00ffu);
            }
            return out;
        }
        if (t.type == 3) {  // colour indexing, bits pixels a byte
            const int in_w = subsample(w, t.bits);
            const int per_byte = 1 << t.bits, bpp = 8 >> t.bits;
            const uint32_t mask = (1u << bpp) - 1;
            std::vector<uint32_t> out(static_cast<size_t>(w) * height);
            for (int y = 0; y < height; ++y) {
                const uint32_t* src = in.data() + static_cast<size_t>(y) * in_w;
                uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
                uint32_t packed = 0;
                for (int x = 0; x < w; ++x) {
                    if ((x & (per_byte - 1)) == 0) packed = (*src++ >> 8) & 0xff;
                    dst[x] = t.data[packed & mask];
                    packed >>= bpp;
                }
            }
            return out;
        }
        const int tiles = subsample(w, t.bits);
        std::vector<uint32_t> out(in.size());
        if (t.type == 1) {  // cross colour
            for (int y = 0; y < height; ++y)
                for (int x = 0; x < w; ++x) {
                    const size_t i = static_cast<size_t>(y) * w + x;
                    const uint32_t m =
                        t.data[static_cast<size_t>(y >> t.bits) * tiles +
                               (x >> t.bits)];
                    const int8_t g2r = static_cast<int8_t>(m & 0xff);
                    const int8_t g2b = static_cast<int8_t>((m >> 8) & 0xff);
                    const int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
                    const uint32_t argb = in[i];
                    const int8_t g = static_cast<int8_t>((argb >> 8) & 0xff);
                    int r = static_cast<int>((argb >> 16) & 0xff);
                    int b = static_cast<int>(argb & 0xff);
                    r = (r + ((g2r * g) >> 5)) & 0xff;
                    b += (g2b * g) >> 5;
                    b += (r2b * static_cast<int8_t>(r)) >> 5;
                    b &= 0xff;
                    out[i] = (argb & 0xff00ff00u) |
                             (static_cast<uint32_t>(r) << 16) |
                             static_cast<uint32_t>(b);
                }
            return out;
        }
        // predictor: row 0 is black then left, column 0 is top
        uint32_t* o = out.data();
        for (int y = 0; y < height; ++y) {
            for (int x = 0; x < w; ++x) {
                const size_t i = static_cast<size_t>(y) * w + x;
                uint32_t pred;
                if (y == 0) {
                    pred = x == 0 ? 0xff000000u : o[i - 1];
                } else if (x == 0) {
                    pred = o[i - w];
                } else {
                    const int m = static_cast<int>(
                        (t.data[static_cast<size_t>(y >> t.bits) * tiles +
                                (x >> t.bits)] >>
                         8) &
                        0xf);
                    pred = predict(m, o + i, w);
                }
                o[i] = add_pixels(in[i], pred);
            }
        }
        return out;
    }
};

void decode_vp8l(const uint8_t* d, size_t n, int width, int height,
                 uint8_t* rgba) {
    if (n < 5 || d[0] != 0x2f) fail("not a VP8L bitstream (no 0x2f byte)");
    LBits hb(d + 1, 4);
    const int w = static_cast<int>(hb.read(14)) + 1;
    const int h = static_cast<int>(hb.read(14)) + 1;
    hb.read(1);  // alpha is used: the decoded alpha is written either way
    if (hb.read(3) != 0) fail("VP8L version is not 0");
    if (w != width || h != height) fail("VP8L size differs from its header");
    Lossless dec(d + 5, n - 5);
    const std::vector<uint32_t> px = dec.decode(w, h);
    for (size_t i = 0; i < px.size(); ++i) {
        rgba[4 * i + 0] = static_cast<uint8_t>(px[i] >> 16);
        rgba[4 * i + 1] = static_cast<uint8_t>(px[i] >> 8);
        rgba[4 * i + 2] = static_cast<uint8_t>(px[i]);
        rgba[4 * i + 3] = static_cast<uint8_t>(px[i] >> 24);
    }
}

// ---------------------------------------------------------------- ALPH ----

void decode_alph(const uint8_t* d, size_t n, int width, int height,
                 uint8_t* rgba) {
    if (n < 1) fail("empty ALPH chunk");
    const int method = d[0] & 3, filter = (d[0] >> 2) & 3,
              pre = (d[0] >> 4) & 3, reserved = d[0] >> 6;
    if (method > 1 || pre > 1 || reserved)
        fail("ALPH header " + std::to_string(d[0]) + " is not valid");
    const size_t total = static_cast<size_t>(width) * height;
    std::vector<uint8_t> a(total);
    if (method == 0) {
        if (n - 1 < total) fail("raw ALPH data is truncated");
        std::memcpy(a.data(), d + 1, total);
    } else {
        Lossless dec(d + 1, n - 1);
        const std::vector<uint32_t> px = dec.decode(width, height);
        for (size_t i = 0; i < total; ++i)
            a[i] = static_cast<uint8_t>(px[i] >> 8);
    }
    for (int y = 0; y < height; ++y) {
        uint8_t* row = a.data() + static_cast<size_t>(y) * width;
        const uint8_t* up = y ? row - width : nullptr;
        if (filter == 1 || (filter && !up)) {  // horizontal
            uint8_t pred = up ? up[0] : 0;
            for (int x = 0; x < width; ++x) pred = row[x] = pred + row[x];
        } else if (filter == 2) {  // vertical
            for (int x = 0; x < width; ++x) row[x] = up[x] + row[x];
        } else if (filter == 3) {  // gradient
            uint8_t left = up[0], top_left = up[0];
            for (int x = 0; x < width; ++x) {
                const int top = up[x];
                left = static_cast<uint8_t>(row[x] +
                                            clip255(left + top - top_left));
                top_left = static_cast<uint8_t>(top);
                row[x] = left;
            }
        }
    }
    for (size_t i = 0; i < total; ++i) rgba[4 * i + 3] = a[i];
}

// ----------------------------------------------------------------- VP8 ----

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284
};

// [type][band][context][11]
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128
};

// [above mode][left mode][9]
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24
};

const int8_t kYModesIntra4[18] = {0,  1, -1, 2,  -2, 3,  4,  6,  -3,
                                  5, -4, -5, -6, 7, -7, 8, -8, -9};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                             9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

// libwebp's VP8BitReader, one byte loaded at a time: the range is kept
// minus one, and eof is set the first time a byte past the end is needed
// (it reads as zero).
class BoolDecoder {
 public:
    void init(const uint8_t* b, size_t n) {
        buf_ = b;
        end_ = b + n;
        value_ = 0;
        bits_ = -8;
        range_ = 254;
        eof_ = false;
        load();
    }

    int bit(int prob) {
        uint32_t range = range_;
        if (bits_ < 0) load();
        const int pos = bits_;
        const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
        const uint32_t value = static_cast<uint32_t>(value_ >> pos);
        const int b = value > split;
        if (b) {
            range -= split;
            value_ -= static_cast<uint64_t>(split + 1) << pos;
        } else {
            range = split + 1;
        }
        int shift = 0;
        while ((range << shift) < 128) ++shift;
        bits_ -= shift;
        range_ = (range << shift) - 1;
        return b;
    }

    int value(int nbits) {
        int v = 0;
        while (nbits-- > 0) v |= bit(0x80) << nbits;
        return v;
    }

    int signed_value(int nbits) {
        const int v = value(nbits);
        return bit(0x80) ? -v : v;
    }

    bool eof() const { return eof_; }

 private:
    void load() {
        if (buf_ < end_) {
            bits_ += 8;
            value_ = (value_ << 8) | *buf_++;
        } else if (!eof_) {
            value_ <<= 8;
            bits_ += 8;
            eof_ = true;
        } else {
            bits_ = 0;
        }
    }

    const uint8_t* buf_ = nullptr;
    const uint8_t* end_ = nullptr;
    uint64_t value_ = 0;
    int bits_ = -8;
    uint32_t range_ = 254;
    bool eof_ = false;
};

constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}
inline uint8_t avg3(int a, int b, int c) {
    return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    for (int y = 0; y < size; ++y, dst += BPS)
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void predict4(int mode, uint8_t* dst) {
    const uint8_t* top = dst - BPS;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3],
              E = top[4], F = top[5], G = top[6], H = top[7];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
              L = dst[-1 + 3 * BPS];
    switch (mode) {
        case B_DC: {
            int dc = 4;
            for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
            for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, dc >> 3, 4);
            break;
        }
        case B_TM: true_motion(dst, 4); break;
        case B_VE: {
            const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                                  avg3(C, D, E)};
            for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
            break;
        }
        case B_HE: {
            const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                                  avg3(K, L, L)};
            for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, v[y], 4);
            break;
        }
        case B_RD:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HD:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:  // B_HU
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
                DST(3, 3) = static_cast<uint8_t>(L);
            break;
    }
}

#undef DST

void fill(uint8_t* dst, int size, int v) {
    for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 luma (size 16) or 8x8 chroma (size 8) prediction; DC has libwebp's
// variants without the top or the left samples at the frame's edges.
void predict_block(int mode, uint8_t* dst, int size, int mb_x, int mb_y) {
    const int shift = size == 16 ? 4 : 3;
    switch (mode) {
        case B_DC: {
            int sum = 0;
            if (mb_x > 0 && mb_y > 0) {
                for (int i = 0; i < size; ++i)
                    sum += dst[i - BPS] + dst[-1 + i * BPS];
                fill(dst, size, (sum + size) >> (shift + 1));
            } else if (mb_y > 0) {
                for (int i = 0; i < size; ++i) sum += dst[i - BPS];
                fill(dst, size, (sum + size / 2) >> shift);
            } else if (mb_x > 0) {
                for (int i = 0; i < size; ++i) sum += dst[-1 + i * BPS];
                fill(dst, size, (sum + size / 2) >> shift);
            } else {
                fill(dst, size, 0x80);
            }
            break;
        }
        case B_TM: true_motion(dst, size); break;
        case B_VE:
            for (int y = 0; y < size; ++y)
                std::memcpy(dst + y * BPS, dst - BPS, size);
            break;
        default:  // B_HE
            for (int y = 0; y < size; ++y)
                std::memset(dst + y * BPS, dst[-1 + y * BPS], size);
            break;
    }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT of in (row-major 4x4) added to dst.
void idct_add(const int16_t* in, uint8_t* dst) {
    int c[16];
    int* tmp = c;
    for (int i = 0; i < 4; ++i, ++in, tmp += 4) {  // vertical pass
        const int a = in[0] + in[8];
        const int b = in[0] - in[8];
        const int cc = mul2(in[4]) - mul1(in[12]);
        const int d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + cc;
        tmp[2] = b - cc;
        tmp[3] = a - d;
    }
    tmp = c;
    for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {  // horizontal pass
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8];
        const int b = dc - tmp[8];
        const int cc = mul2(tmp[4]) - mul1(tmp[12]);
        const int d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + cc) >> 3));
        dst[2] = clip8(dst[2] + ((b - cc) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
}

// The inverse WHT of the Y2 block into the DC of the 16 luma blocks.
void inverse_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = static_cast<int16_t>((a0 + a1) >> 3);
        out[16] = static_cast<int16_t>((a3 + a2) >> 3);
        out[32] = static_cast<int16_t>((a0 - a1) >> 3);
        out[48] = static_cast<int16_t>((a3 - a2) >> 3);
        out += 64;
    }
}

// ---- loop filter (libwebp's dsp/dec.c) ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

void filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

void filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

void filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// The simple filter across one edge of 16 pixels: hstride steps across the
// edge, vstride along it.
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

// The normal filter across one edge of size pixels (filter6 on macroblock
// edges, filter4 on inner ones).
void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride) {
        if (!needs_filter2(p, hstride, t2, ithresh)) continue;
        if (hev(p, hstride, hev_thresh))
            filter2(p, hstride);
        else if (mb_edge)
            filter6(p, hstride);
        else
            filter4(p, hstride);
    }
}

struct FilterInfo {
    int limit = 0;   // 0: not filtered
    int ilevel = 0;
    int hev_thresh = 0;
    bool inner = false;
};

struct Quant {
    int y1[2], y2[2], uv[2];
};

class Lossy {
 public:
    Lossy(const uint8_t* d, size_t n) : d_(d), n_(n) {}

    void decode(int width, int height, uint8_t* rgba) {
        headers();
        if (width_ != width || height_ != height)
            fail("VP8 size differs from its header");
        frame();
        filter_frame();
        emit(rgba);
    }

 private:
    const uint8_t* d_;
    size_t n_;
    int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
    BoolDecoder br_;
    std::vector<BoolDecoder> parts_;
    // segment header
    bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
    int quantizer_[4] = {0}, filter_strength_[4] = {0};
    int seg_proba_[3] = {255, 255, 255};
    // filter header
    bool simple_ = false, use_lf_delta_ = false;
    int level_ = 0, sharpness_ = 0, filter_type_ = 0;
    int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
    Quant dqm_[4];
    uint8_t proba_[4][8][3][11];
    bool use_skip_ = false;
    int skip_p_ = 0;
    FilterInfo fstrengths_[4][2];
    // planes, padded to whole macroblocks
    int ystride_ = 0, uvstride_ = 0;
    std::vector<uint8_t> y_, u_, v_;
    std::vector<FilterInfo> finfo_;

    void headers() {
        if (n_ < 10) fail("VP8 header is truncated");
        const uint32_t bits = d_[0] | (d_[1] << 8) | (d_[2] << 16);
        if (bits & 1) fail("VP8 frame is not a key frame");
        if (((bits >> 1) & 7) > 3) fail("VP8 profile past 3");
        if (!((bits >> 4) & 1)) fail("VP8 frame is not shown");
        const size_t part0 = bits >> 5;
        if (d_[3] != 0x9d || d_[4] != 0x01 || d_[5] != 0x2a)
            fail("VP8 start code missing");
        width_ = ((d_[7] << 8) | d_[6]) & 0x3fff;
        height_ = ((d_[9] << 8) | d_[8]) & 0x3fff;
        if (width_ == 0 || height_ == 0) fail("VP8 frame of size 0");
        mb_w_ = (width_ + 15) >> 4;
        mb_h_ = (height_ + 15) >> 4;
        const uint8_t* buf = d_ + 10;
        size_t size = n_ - 10;
        if (part0 > size) fail("VP8 first partition is truncated");
        br_.init(buf, part0);
        buf += part0;
        size -= part0;
        br_.value(1);  // colour space
        br_.value(1);  // clamping type: libwebp always clamps
        // segment header
        use_segment_ = br_.value(1);
        if (use_segment_) {
            update_map_ = br_.value(1);
            if (br_.value(1)) {  // update data
                absolute_delta_ = br_.value(1);
                for (int& q : quantizer_) q = br_.value(1) ? br_.signed_value(7) : 0;
                for (int& f : filter_strength_)
                    f = br_.value(1) ? br_.signed_value(6) : 0;
            }
            if (update_map_)
                for (int& p : seg_proba_) p = br_.value(1) ? br_.value(8) : 255;
        }
        if (br_.eof()) fail("VP8 segment header is truncated");
        // filter header
        simple_ = br_.value(1);
        level_ = br_.value(6);
        sharpness_ = br_.value(3);
        use_lf_delta_ = br_.value(1);
        if (use_lf_delta_ && br_.value(1)) {
            for (int& r : ref_lf_delta_)
                if (br_.value(1)) r = br_.signed_value(6);
            for (int& m : mode_lf_delta_)
                if (br_.value(1)) m = br_.signed_value(6);
        }
        filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
        if (br_.eof()) fail("VP8 filter header is truncated");
        // partitions
        const size_t last = (1u << br_.value(2)) - 1;
        if (size < 3 * last) fail("VP8 partition sizes are truncated");
        const uint8_t* start = buf + 3 * last;
        size_t left = size - 3 * last;
        parts_.resize(last + 1);
        for (size_t p = 0; p < last; ++p) {
            size_t psize = buf[3 * p] | (buf[3 * p + 1] << 8) |
                           (buf[3 * p + 2] << 16);
            if (psize > left) psize = left;
            parts_[p].init(start, psize);
            start += psize;
            left -= psize;
        }
        parts_[last].init(start, left);
        if (start >= buf + size) fail("VP8 token partitions are truncated");
        // quantisers
        const int base_q = br_.value(7);
        auto delta = [&]() { return br_.value(1) ? br_.signed_value(4) : 0; };
        const int dqy1_dc = delta(), dqy2_dc = delta(), dqy2_ac = delta(),
                  dquv_dc = delta(), dquv_ac = delta();
        auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
        for (int s = 0; s < 4; ++s) {
            int q = base_q;
            if (use_segment_) {
                q = quantizer_[s] + (absolute_delta_ ? 0 : base_q);
            } else if (s > 0) {
                dqm_[s] = dqm_[0];
                continue;
            }
            Quant& m = dqm_[s];
            m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
            m.y1[1] = kAcTable[clip(q, 127)];
            m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
            m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m.y2[1] < 8) m.y2[1] = 8;
            m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
            m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
        }
        br_.value(1);  // refresh entropy probabilities: ignored
        for (int t = 0; t < 4; ++t)
            for (int b = 0; b < 8; ++b)
                for (int c = 0; c < 3; ++c)
                    for (int p = 0; p < 11; ++p)
                        proba_[t][b][c][p] = static_cast<uint8_t>(
                            br_.bit(kCoeffsUpdateProba[t][b][c][p])
                                ? br_.value(8)
                                : kCoeffsProba0[t][b][c][p]);
        use_skip_ = br_.value(1);
        if (use_skip_) skip_p_ = br_.value(8);
        strengths();
    }

    void strengths() {
        for (int s = 0; s < 4; ++s) {
            int base = level_;
            if (use_segment_)
                base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
            for (int i4 = 0; i4 <= 1; ++i4) {
                FilterInfo& f = fstrengths_[s][i4];
                int level = base;
                if (use_lf_delta_) {
                    level += ref_lf_delta_[0];
                    if (i4) level += mode_lf_delta_[0];
                }
                level = level < 0 ? 0 : level > 63 ? 63 : level;
                if (level > 0) {
                    int ilevel = level;
                    if (sharpness_ > 0) {
                        ilevel >>= sharpness_ > 4 ? 2 : 1;
                        if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
                    }
                    if (ilevel < 1) ilevel = 1;
                    f.ilevel = ilevel;
                    f.limit = 2 * level + ilevel;
                    f.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
                } else {
                    f.limit = 0;
                }
                f.inner = i4;
            }
        }
    }

    // Coefficients of one block from index n, dequantised by dq (DC,
    // AC) into out (natural order); the index past the last non-zero one.
    int coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n,
               int16_t* out) {
        const uint8_t* p = proba_[type][kBands[n]][ctx];
        for (; n < 16; ++n) {
            if (!br.bit(p[0])) return n;
            while (!br.bit(p[1])) {
                p = proba_[type][kBands[++n]][0];
                if (n == 16) return 16;
            }
            int v;
            const uint8_t* const next = proba_[type][kBands[n + 1]][0];
            if (!br.bit(p[2])) {
                v = 1;
                p = next + 11;  // context 1
            } else {
                v = large_value(br, p);
                p = next + 22;  // context 2
            }
            out[kZigzag[n]] =
                static_cast<int16_t>((br.bit(0x80) ? -v : v) * dq[n > 0]);
        }
        return 16;
    }

    static int large_value(BoolDecoder& br, const uint8_t* p) {
        int v;
        if (!br.bit(p[3])) {
            v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
        } else if (!br.bit(p[6])) {
            if (!br.bit(p[7])) {
                v = 5 + br.bit(159);
            } else {
                v = 7 + 2 * br.bit(165);
                v += br.bit(145);
            }
        } else {
            const int bit1 = br.bit(p[8]);
            const int bit0 = br.bit(p[9 + bit1]);
            const int cat = 2 * bit1 + bit0;
            v = 0;
            for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
                v += v + br.bit(*tab);
            v += 3 + (8 << cat);
        }
        return v;
    }

    static uint32_t nz_bits(uint32_t acc, int nz, bool dc_nz) {
        return (acc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz ? 1 : 0);
    }

    void frame() {
        ystride_ = mb_w_ * 16;
        uvstride_ = mb_w_ * 8;
        y_.assign(static_cast<size_t>(ystride_) * mb_h_ * 16, 0);
        u_.assign(static_cast<size_t>(uvstride_) * mb_h_ * 8, 0);
        v_.assign(static_cast<size_t>(uvstride_) * mb_h_ * 8, 0);
        finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo());
        std::vector<uint8_t> intra_t(4 * mb_w_, B_DC);
        std::vector<uint8_t> top_nz(mb_w_, 0), top_nz_dc(mb_w_, 0);
        // unfiltered bottom rows of the row above, per macroblock
        std::vector<uint8_t> top_y(16 * mb_w_), top_u(8 * mb_w_),
            top_v(8 * mb_w_);
        struct Block {
            int segment, skip, is_i4;
            uint8_t imodes[16];
            int uvmode;
        };
        std::vector<Block> blocks(mb_w_);
        std::vector<uint8_t> work(YUV_SIZE);
        std::vector<int16_t> coeffs_buf(384);
        for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
            // intra modes of the row (first partition)
            uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
            for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
                Block& b = blocks[mb_x];
                uint8_t* top = intra_t.data() + 4 * mb_x;
                b.segment = 0;
                if (update_map_)
                    b.segment = !br_.bit(seg_proba_[0])
                                    ? br_.bit(seg_proba_[1])
                                    : br_.bit(seg_proba_[2]) + 2;
                b.skip = use_skip_ ? br_.bit(skip_p_) : 0;
                b.is_i4 = !br_.bit(145);
                if (!b.is_i4) {
                    const int ymode = br_.bit(156)
                                          ? (br_.bit(128) ? B_TM : B_HE)
                                          : (br_.bit(163) ? B_VE : B_DC);
                    b.imodes[0] = static_cast<uint8_t>(ymode);
                    std::memset(top, ymode, 4);
                    std::memset(intra_l, ymode, 4);
                } else {
                    for (int y = 0; y < 4; ++y) {
                        int ymode = intra_l[y];
                        for (int x = 0; x < 4; ++x) {
                            const uint8_t* prob = kBModesProba[top[x]][ymode];
                            int i = kYModesIntra4[br_.bit(prob[0])];
                            while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
                            ymode = -i;
                            top[x] = static_cast<uint8_t>(ymode);
                        }
                        std::memcpy(b.imodes + 4 * y, top, 4);
                        intra_l[y] = static_cast<uint8_t>(ymode);
                    }
                }
                b.uvmode = !br_.bit(142)   ? B_DC
                           : !br_.bit(114) ? B_VE
                           : br_.bit(183)  ? B_TM
                                           : B_HE;
            }
            if (br_.eof()) fail("VP8 first partition ends early");
            // residuals and reconstruction
            BoolDecoder& tbr = parts_[mb_y & (parts_.size() - 1)];
            uint8_t left_nz = 0, left_nz_dc = 0;
            uint8_t* ydst = work.data() + Y_OFF;
            uint8_t* udst = work.data() + U_OFF;
            uint8_t* vdst = work.data() + V_OFF;
            for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
            for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
            if (mb_y > 0) {
                ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
            } else {
                std::memset(ydst - BPS - 1, 127, 16 + 4 + 1);
                std::memset(udst - BPS - 1, 127, 8 + 1);
                std::memset(vdst - BPS - 1, 127, 8 + 1);
            }
            for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
                Block& b = blocks[mb_x];
                int16_t* c = coeffs_buf.data();
                uint32_t non_zero_y = 0, non_zero_uv = 0;
                bool skip = b.skip;
                if (!skip) {
                    std::fill(coeffs_buf.begin(), coeffs_buf.end(), 0);
                    const Quant& q = dqm_[b.segment];
                    int first, type;
                    if (!b.is_i4) {
                        int16_t dc[16] = {0};
                        const int ctx = top_nz_dc[mb_x] + left_nz_dc;
                        const int nz = coeffs(tbr, 1, ctx, q.y2, 0, dc);
                        top_nz_dc[mb_x] = left_nz_dc = nz > 0;
                        if (nz > 1) {
                            inverse_wht(dc, c);
                        } else {
                            const int dc0 = (dc[0] + 3) >> 3;
                            for (int i = 0; i < 256; i += 16)
                                c[i] = static_cast<int16_t>(dc0);
                        }
                        first = 1;
                        type = 0;
                    } else {
                        first = 0;
                        type = 3;
                    }
                    uint32_t tnz = top_nz[mb_x] & 0x0f;
                    uint32_t lnz = left_nz & 0x0f;
                    int16_t* dst = c;
                    for (int y = 0; y < 4; ++y) {
                        uint32_t l = lnz & 1, nzc = 0;
                        for (int x = 0; x < 4; ++x, dst += 16) {
                            const int ctx = static_cast<int>(l + (tnz & 1));
                            const int nz = coeffs(tbr, type, ctx, q.y1, first, dst);
                            l = nz > first;
                            tnz = (tnz >> 1) | (l << 7);
                            nzc = nz_bits(nzc, nz, dst[0] != 0);
                        }
                        tnz >>= 4;
                        lnz = (lnz >> 1) | (l << 7);
                        non_zero_y = (non_zero_y << 8) | nzc;
                    }
                    uint32_t out_t = tnz, out_l = lnz >> 4;
                    for (int ch = 0; ch < 4; ch += 2) {
                        uint32_t nzc = 0;
                        tnz = top_nz[mb_x] >> (4 + ch);
                        lnz = left_nz >> (4 + ch);
                        for (int y = 0; y < 2; ++y) {
                            uint32_t l = lnz & 1;
                            for (int x = 0; x < 2; ++x, dst += 16) {
                                const int ctx = static_cast<int>(l + (tnz & 1));
                                const int nz = coeffs(tbr, 2, ctx, q.uv, 0, dst);
                                l = nz > 0;
                                tnz = (tnz >> 1) | (l << 3);
                                nzc = nz_bits(nzc, nz, dst[0] != 0);
                            }
                            tnz >>= 2;
                            lnz = (lnz >> 1) | (l << 5);
                        }
                        non_zero_uv |= nzc << (4 * ch);
                        out_t |= (tnz << 4) << ch;
                        out_l |= (lnz & 0xf0) << ch;
                    }
                    top_nz[mb_x] = static_cast<uint8_t>(out_t);
                    left_nz = static_cast<uint8_t>(out_l);
                    skip = !(non_zero_y | non_zero_uv);
                } else {
                    left_nz = top_nz[mb_x] = 0;
                    if (!b.is_i4) left_nz_dc = top_nz_dc[mb_x] = 0;
                }
                if (tbr.eof()) fail("VP8 token partition ends early");
                if (filter_type_ > 0) {
                    FilterInfo f = fstrengths_[b.segment][b.is_i4];
                    f.inner = f.inner || !skip;
                    finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x] = f;
                }
                // reconstruct into the work buffer
                if (mb_x > 0) {
                    for (int j = -1; j < 16; ++j)
                        std::memcpy(ydst + j * BPS - 4, ydst + j * BPS + 12, 4);
                    for (int j = -1; j < 8; ++j) {
                        std::memcpy(udst + j * BPS - 4, udst + j * BPS + 4, 4);
                        std::memcpy(vdst + j * BPS - 4, vdst + j * BPS + 4, 4);
                    }
                }
                if (mb_y > 0) {
                    std::memcpy(ydst - BPS, top_y.data() + 16 * mb_x, 16);
                    std::memcpy(udst - BPS, top_u.data() + 8 * mb_x, 8);
                    std::memcpy(vdst - BPS, top_v.data() + 8 * mb_x, 8);
                }
                uint32_t bits = skip ? 0 : non_zero_y;
                if (b.is_i4) {
                    uint8_t* top_right = ydst - BPS + 16;
                    if (mb_y > 0) {
                        if (mb_x >= mb_w_ - 1)
                            std::memset(top_right, top_y[16 * mb_x + 15], 4);
                        else
                            std::memcpy(top_right, top_y.data() + 16 * (mb_x + 1), 4);
                    }
                    for (int r = 1; r <= 3; ++r)
                        std::memcpy(top_right + 4 * r * BPS, top_right, 4);
                    for (int n = 0; n < 16; ++n, bits <<= 2) {
                        uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                        predict4(b.imodes[n], dst);
                        if (bits >> 30) idct_add(c + n * 16, dst);
                    }
                } else {
                    predict_block(b.imodes[0], ydst, 16, mb_x, mb_y);
                    for (int n = 0; n < 16; ++n, bits <<= 2)
                        if (bits >> 30)
                            idct_add(c + n * 16,
                                     ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
                }
                const uint32_t bits_uv = skip ? 0 : non_zero_uv;
                predict_block(b.uvmode, udst, 8, mb_x, mb_y);
                predict_block(b.uvmode, vdst, 8, mb_x, mb_y);
                for (int k = 0; k < 2; ++k) {
                    uint8_t* dst = k ? vdst : udst;
                    if ((bits_uv >> (8 * k)) & 0xff)
                        for (int n = 0; n < 4; ++n)
                            idct_add(c + (16 + 4 * k + n) * 16,
                                     dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
                }
                if (mb_y < mb_h_ - 1) {
                    std::memcpy(top_y.data() + 16 * mb_x, ydst + 15 * BPS, 16);
                    std::memcpy(top_u.data() + 8 * mb_x, udst + 7 * BPS, 8);
                    std::memcpy(top_v.data() + 8 * mb_x, vdst + 7 * BPS, 8);
                }
                for (int j = 0; j < 16; ++j)
                    std::memcpy(y_.data() + static_cast<size_t>(mb_y * 16 + j) *
                                                ystride_ + mb_x * 16,
                                ydst + j * BPS, 16);
                for (int j = 0; j < 8; ++j) {
                    const size_t o = static_cast<size_t>(mb_y * 8 + j) * uvstride_ +
                                     mb_x * 8;
                    std::memcpy(u_.data() + o, udst + j * BPS, 8);
                    std::memcpy(v_.data() + o, vdst + j * BPS, 8);
                }
            }
        }
    }

    void filter_frame() {
        if (filter_type_ == 0) return;
        for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
                const FilterInfo& f =
                    finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
                if (f.limit == 0) continue;
                const int ys = ystride_, uvs = uvstride_;
                uint8_t* yd = y_.data() + static_cast<size_t>(mb_y) * 16 * ys +
                              mb_x * 16;
                const size_t uvo =
                    static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
                uint8_t* ud = u_.data() + uvo;
                uint8_t* vd = v_.data() + uvo;
                const int lim = f.limit, il = f.ilevel, ht = f.hev_thresh;
                if (filter_type_ == 1) {
                    if (mb_x > 0) simple_edge(yd, 1, ys, lim + 4);
                    if (f.inner)
                        for (int k = 1; k <= 3; ++k)
                            simple_edge(yd + 4 * k, 1, ys, lim);
                    if (mb_y > 0) simple_edge(yd, ys, 1, lim + 4);
                    if (f.inner)
                        for (int k = 1; k <= 3; ++k)
                            simple_edge(yd + 4 * k * ys, ys, 1, lim);
                    continue;
                }
                if (mb_x > 0) {
                    normal_edge(yd, 1, ys, 16, lim + 4, il, ht, true);
                    normal_edge(ud, 1, uvs, 8, lim + 4, il, ht, true);
                    normal_edge(vd, 1, uvs, 8, lim + 4, il, ht, true);
                }
                if (f.inner) {
                    for (int k = 1; k <= 3; ++k)
                        normal_edge(yd + 4 * k, 1, ys, 16, lim, il, ht, false);
                    normal_edge(ud + 4, 1, uvs, 8, lim, il, ht, false);
                    normal_edge(vd + 4, 1, uvs, 8, lim, il, ht, false);
                }
                if (mb_y > 0) {
                    normal_edge(yd, ys, 1, 16, lim + 4, il, ht, true);
                    normal_edge(ud, uvs, 1, 8, lim + 4, il, ht, true);
                    normal_edge(vd, uvs, 1, 8, lim + 4, il, ht, true);
                }
                if (f.inner) {
                    for (int k = 1; k <= 3; ++k)
                        normal_edge(yd + 4 * k * ys, ys, 1, 16, lim, il, ht,
                                    false);
                    normal_edge(ud + 4 * uvs, uvs, 1, 8, lim, il, ht, false);
                    normal_edge(vd + 4 * uvs, uvs, 1, 8, lim, il, ht, false);
                }
            }
    }

    // libwebp's dsp/yuv.h
    static int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
    static uint8_t yuv_clip(int v) {
        return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6
                                    : v < 0          ? 0
                                                     : 255);
    }
    static void yuv_to_rgba(int y, int u, int v, uint8_t* out) {
        out[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
        out[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) -
                          mult_hi(v, 13320) + 8708);
        out[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
        out[3] = 0xff;
    }

    // libwebp's UPSAMPLE_FUNC: two output rows from two chroma rows.
    static void upsample(const uint8_t* top_y, const uint8_t* bottom_y,
                         const uint8_t* top_u, const uint8_t* top_v,
                         const uint8_t* cur_u, const uint8_t* cur_v,
                         uint8_t* top_dst, uint8_t* bottom_dst, int len) {
        auto load = [](int u, int v) {
            return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16);
        };
        auto put = [](int y, uint32_t uv, uint8_t* dst) {
            yuv_to_rgba(y, uv & 0xff, uv >> 16, dst);
        };
        const int last_pair = (len - 1) >> 1;
        uint32_t tl_uv = load(top_u[0], top_v[0]);
        uint32_t l_uv = load(cur_u[0], cur_v[0]);
        put(top_y[0], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst);
        if (bottom_y)
            put(bottom_y[0], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst);
        for (int x = 1; x <= last_pair; ++x) {
            const uint32_t t_uv = load(top_u[x], top_v[x]);
            const uint32_t uv = load(cur_u[x], cur_v[x]);
            const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
            const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
            const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
            put(top_y[2 * x - 1], (diag_12 + tl_uv) >> 1,
                top_dst + (2 * x - 1) * 4);
            put(top_y[2 * x], (diag_03 + t_uv) >> 1, top_dst + 2 * x * 4);
            if (bottom_y) {
                put(bottom_y[2 * x - 1], (diag_03 + l_uv) >> 1,
                    bottom_dst + (2 * x - 1) * 4);
                put(bottom_y[2 * x], (diag_12 + uv) >> 1,
                    bottom_dst + 2 * x * 4);
            }
            tl_uv = t_uv;
            l_uv = uv;
        }
        if (!(len & 1)) {
            put(top_y[len - 1], (3 * tl_uv + l_uv + 0x00020002u) >> 2,
                top_dst + (len - 1) * 4);
            if (bottom_y)
                put(bottom_y[len - 1], (3 * l_uv + tl_uv + 0x00020002u) >> 2,
                    bottom_dst + (len - 1) * 4);
        }
    }

    // libwebp's EmitFancyRGB over the whole cropped frame.
    void emit(uint8_t* rgba) {
        const int w = width_, h = height_;
        const size_t stride = static_cast<size_t>(w) * 4;
        auto yrow = [&](int r) { return y_.data() + static_cast<size_t>(r) * ystride_; };
        auto urow = [&](int r) { return u_.data() + static_cast<size_t>(r) * uvstride_; };
        auto vrow = [&](int r) { return v_.data() + static_cast<size_t>(r) * uvstride_; };
        upsample(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgba,
                 nullptr, w);
        int y = 0;
        for (; y + 2 < h; y += 2) {
            const int k = y / 2;
            upsample(yrow(y + 1), yrow(y + 2), urow(k), vrow(k), urow(k + 1),
                     vrow(k + 1), rgba + (y + 1) * stride,
                     rgba + (y + 2) * stride, w);
        }
        if (!(h & 1)) {
            const int k = y / 2;
            upsample(yrow(h - 1), nullptr, urow(k), vrow(k), urow(k), vrow(k),
                     rgba + static_cast<size_t>(h - 1) * stride, nullptr, w);
        }
    }
};

void copy_error(const std::string& what, char* err, int errlen) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", what.c_str());
}

template <class Body>
int guarded(char* err, int errlen, Body body) {
    try {
        body();
        return 0;
    } catch (const WebpError& e) {
        copy_error(e.what, err, errlen);
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
    }
    return -1;
}

void check_size(int width, int height) {
    if (width <= 0 || height <= 0 || width > 16384 || height > 16384)
        fail("WebP frame of " + std::to_string(width) + "x" +
             std::to_string(height) + " pixels");
}

}  // namespace

extern "C" {

int cge_webp_vp8(const unsigned char* data, long n, int width, int height,
                 unsigned char* rgba, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        check_size(width, height);
        Lossy(data, static_cast<size_t>(n)).decode(width, height, rgba);
    });
}

int cge_webp_vp8l(const unsigned char* data, long n, int width, int height,
                  unsigned char* rgba, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        check_size(width, height);
        decode_vp8l(data, static_cast<size_t>(n), width, height, rgba);
    });
}

int cge_webp_alph(const unsigned char* data, long n, int width, int height,
                  unsigned char* rgba, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        check_size(width, height);
        decode_alph(data, static_cast<size_t>(n), width, height, rgba);
    });
}

}  // extern "C"
