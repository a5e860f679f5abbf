// Block-compressed (BCn) texture decoding for the port's DDS loader
// (cge_tpu_torch/scene/dds.py).
//
// The JAX package loads a DDS texture through Pillow. This file decodes a
// grid of 4x4 blocks to the RGBA bytes Pillow 12's BCn decoder gives:
//
//   - BC1 (DXT1): the 5-6-5 endpoints widened by bit replication; four
//     colours when c0 > c1 (the thirds truncated), else three (the half
//     truncated) and transparent black;
//   - BC2 (DXT3) and BC3 (DXT5): a BC1 colour block always read in its
//     four-colour mode, with BC2's explicit 4-bit alpha (widened x 17) or
//     BC3's interpolated alpha;
//   - BC4: one BC3-style block as grey, written to R, G and B;
//   - BC5: two such blocks as red and green, blue 0; signed (BC5S), each
//     byte s read as s + 128 before the interpolation, and blue 128;
//   - BC6H, unsigned (UF16) and signed (SF16): the 14 modes of the format
//     with their endpoint bit layouts, sign extension and deltas (as
//     Pillow does it: a signed endpoint made from a delta is kept to the
//     endpoint's bits, not sign-extended, and every endpoint is then read
//     as a 16-bit two's complement number), unquantisation, the 32
//     two-region partitions with their anchors, 3- and 4-bit weights
//     without rounding, the finishing multiply (x 31/64 unsigned, x 31/32
//     signed), then the half float as u8: negative -> 0, above 1 -> 255,
//     else truncated x 255 in single precision; the four reserved modes
//     decode to black;
//   - BC7: modes 0-7 with their subset counts, the 64 two- and 64
//     three-subset partitions and anchors, p-bits, colour and alpha
//     precisions, rotation and index selection (modes 4 and 5), and the
//     2-, 3- and 4-bit weights (rounded); a block with no mode bit is opaque
//     black.
//
// Entry point (C ABI, loaded with ctypes): cge_bcn_decode writes
// [4 * blocks_h][4 * blocks_w][4] RGBA bytes, row 0 the top, the blocks in
// row-major order. It returns 0, or -1 with a message in err when the data
// holds fewer bytes than the grid's blocks, and reads no byte past n.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct Rgba {
    uint8_t r, g, b, a;
};

// n bits (n <= 16) of a 16-byte block from bit pos on, least significant
// first; bits past the block read as 0
unsigned get_bits(const uint8_t* s, int pos, int n) {
    unsigned v = 0;
    for (int i = 0; i < n && pos < 128; ++i, ++pos)
        v |= ((s[pos >> 3] >> (pos & 7)) & 1u) << i;
    return v;
}

// ------------------------------------------------------------- BC1 - BC5

Rgba rgb565(unsigned c) {
    unsigned r = (c >> 11) & 31, g = (c >> 5) & 63, b = c & 31;
    return {uint8_t(r << 3 | r >> 2), uint8_t(g << 2 | g >> 4),
            uint8_t(b << 3 | b >> 2), 255};
}

// (wp * p + wq * q) / d, truncated, opaque
Rgba mix(const Rgba& p, const Rgba& q, int wp, int wq, int d) {
    return {uint8_t((wp * p.r + wq * q.r) / d),
            uint8_t((wp * p.g + wq * q.g) / d),
            uint8_t((wp * p.b + wq * q.b) / d), 255};
}

// an 8-byte BC1 colour block; `four` forces the four-colour mode
void bc1_colour(const uint8_t* s, bool four, Rgba* out) {
    unsigned c0 = s[0] | s[1] << 8, c1 = s[2] | s[3] << 8;
    Rgba p[4] = {rgb565(c0), rgb565(c1), {}, {}};
    if (c0 > c1 || four) {
        p[2] = mix(p[0], p[1], 2, 1, 3);
        p[3] = mix(p[0], p[1], 1, 2, 3);
    } else {
        p[2] = mix(p[0], p[1], 1, 1, 2);
        p[3] = {0, 0, 0, 0};
    }
    for (int i = 0; i < 16; ++i)
        out[i] = p[(s[4 + i / 4] >> (2 * (i % 4))) & 3];
}

// the 16 values of an 8-byte BC3 alpha / BC4 block; signed: each
// endpoint byte s (two's complement) read as s + 128
void bc4_values(const uint8_t* s, bool is_signed, uint8_t* out) {
    int a0 = is_signed ? s[0] ^ 0x80 : s[0];
    int a1 = is_signed ? s[1] ^ 0x80 : s[1];
    int a[8] = {a0, a1, 0, 0, 0, 0, 0, 255};
    if (a0 > a1) {
        for (int j = 1; j < 7; ++j) a[j + 1] = ((7 - j) * a0 + j * a1) / 7;
    } else {
        for (int j = 1; j < 5; ++j) a[j + 1] = ((5 - j) * a0 + j * a1) / 5;
    }
    uint64_t lut = 0;
    for (int j = 0; j < 6; ++j) lut |= uint64_t(s[2 + j]) << (8 * j);
    for (int i = 0; i < 16; ++i) out[i] = uint8_t(a[(lut >> (3 * i)) & 7]);
}

// --------------------------------------------------------------------- BC7

// the subsets of each pixel (bit i, or bits 2i and 2i + 1, for pixel i)
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// the anchor pixel of subset 1 of two, and of subsets 1 and 2 of three
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                               34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
    return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset_of(int subsets, int partition, int i) {
    if (subsets == 2) return (kPartition2[partition] >> i) & 1;
    if (subsets == 3) return (kPartition3[partition] >> (2 * i)) & 3;
    return 0;
}

// whether pixel i holds its subset's anchor index (one bit shorter)
bool anchor(int subsets, int partition, int subset, int i) {
    if (subset == 0) return i == 0;
    if (subsets == 2) return i == kAnchor2[partition];
    return i == (subset == 1 ? kAnchor3a : kAnchor3b)[partition];
}

struct Bc7Mode {
    int subsets, partition_bits, rotation_bits, selector_bits;
    int colour_bits, alpha_bits, endpoint_pbits, subset_pbits;
    int index_bits, index2_bits;
};

const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

int widen(int v, int bits) {
    v <<= 8 - bits;
    return (v | v >> bits) & 255;
}

int lerp7(int e0, int e1, int w) {
    return ((64 - w) * e0 + w * e1 + 32) >> 6;
}

void bc7_block(const uint8_t* s, Rgba* out) {
    int mode = 0;
    while (mode < 8 && !((s[0] >> mode) & 1)) ++mode;
    if (mode == 8) {
        for (int i = 0; i < 16; ++i) out[i] = {0, 0, 0, 255};
        return;
    }
    const Bc7Mode& m = kBc7Modes[mode];
    int pos = mode + 1;
    auto read = [&](int n) {
        unsigned v = get_bits(s, pos, n);
        pos += n;
        return int(v);
    };
    int partition = read(m.partition_bits);
    int rotation = read(m.rotation_bits);
    int selector = read(m.selector_bits);
    int n_ep = 2 * m.subsets;
    int ep[6][4];                       // [endpoint][r, g, b, a]
    for (int c = 0; c < 3; ++c)
        for (int e = 0; e < n_ep; ++e) ep[e][c] = read(m.colour_bits);
    for (int e = 0; e < n_ep; ++e)
        ep[e][3] = m.alpha_bits ? read(m.alpha_bits) : 255;
    int cbits = m.colour_bits, abits = m.alpha_bits;
    if (m.endpoint_pbits || m.subset_pbits) {
        ++cbits;
        if (abits) ++abits;
        int p = 0;                      // one bit an endpoint or a subset
        for (int e = 0; e < n_ep; ++e) {
            if (m.endpoint_pbits || e % 2 == 0) p = read(1);
            for (int c = 0; c < (m.alpha_bits ? 4 : 3); ++c)
                ep[e][c] = ep[e][c] << 1 | p;
        }
    }
    for (int e = 0; e < n_ep; ++e) {
        for (int c = 0; c < 3; ++c) ep[e][c] = widen(ep[e][c], cbits);
        if (abits) ep[e][3] = widen(ep[e][3], abits);
    }
    const uint8_t* cw = weights(m.index_bits);
    const uint8_t* aw = weights(m.index2_bits ? m.index2_bits : m.index_bits);
    int cpos = pos;
    int apos = cpos + 16 * m.index_bits - m.subsets;
    for (int i = 0; i < 16; ++i) {
        int sub = subset_of(m.subsets, partition, i);
        int ib = m.index_bits - (anchor(m.subsets, partition, sub, i) ? 1 : 0);
        int i0 = int(get_bits(s, cpos, ib));
        cpos += ib;
        int wc = cw[i0], wa = cw[i0];
        if (m.index2_bits) {
            int ib2 = m.index2_bits - (i == 0 ? 1 : 0);
            int i1 = int(get_bits(s, apos, ib2));
            apos += ib2;
            if (selector) {
                wc = aw[i1];
            } else {
                wa = aw[i1];
            }
        }
        const int* e0 = ep[2 * sub];
        const int* e1 = ep[2 * sub + 1];
        uint8_t px[4] = {uint8_t(lerp7(e0[0], e1[0], wc)),
                         uint8_t(lerp7(e0[1], e1[1], wc)),
                         uint8_t(lerp7(e0[2], e1[2], wc)),
                         uint8_t(lerp7(e0[3], e1[3], wa))};
        if (rotation) {                 // swap alpha with r, g or b
            uint8_t t = px[rotation - 1];
            px[rotation - 1] = px[3];
            px[3] = t;
        }
        out[i] = {px[0], px[1], px[2], px[3]};
    }
}

// -------------------------------------------------------------------- BC6H

struct Bc6Mode {
    int regions, transformed, endpoint_bits, delta_bits[3];
};

// Pillow's mode order: the 2-bit modes 0b00 and 0b01, then the 5-bit
// modes 0b00010, 0b00110, ..., 0b11110 (two regions) and 0b00011, 0b00111,
// 0b01011, 0b01111 (one region)
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 10, {5, 5, 5}}, {2, 1, 7, {6, 6, 6}},   {2, 1, 11, {5, 4, 4}},
    {2, 1, 11, {4, 5, 4}}, {2, 1, 11, {4, 4, 5}},  {2, 1, 9, {5, 5, 5}},
    {2, 1, 8, {6, 5, 5}},  {2, 1, 8, {5, 6, 5}},   {2, 1, 8, {5, 5, 6}},
    {2, 0, 6, {6, 6, 6}},  {1, 0, 10, {10, 10, 10}}, {1, 1, 11, {9, 9, 9}},
    {1, 1, 12, {8, 8, 8}}, {1, 1, 16, {4, 4, 4}}};

// A run of endpoint bits in a mode's layout: `count` bits read in order
// into bits lo.. of value `ep` (0-2: r, g, b of w; 3-5 of x; 6-8 of y;
// 9-11 of z), or, reversed, into bits lo + count - 1 down to lo.
struct Run {
    uint8_t ep, lo, count, reversed;
};

enum : uint8_t { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ };

// The BC6H format's endpoint layouts, mode by mode after the mode bits, as
// the format's specification lists them ({BZ, 4, 1} is bz[4]); each ends
// at bit 77 (two regions, then 5 partition bits) or 65 (one region).
const Run kRuns0[] = {
    {GY, 4, 1, 0}, {BY, 4, 1, 0}, {BZ, 4, 1, 0}, {RW, 0, 10, 0},
    {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0},
    {GY, 0, 4, 0}, {GX, 0, 5, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0},
    {BX, 0, 5, 0}, {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 5, 0},
    {BZ, 2, 1, 0}, {RZ, 0, 5, 0}, {BZ, 3, 1, 0}};
const Run kRuns1[] = {
    {GY, 5, 1, 0}, {GZ, 4, 1, 0}, {GZ, 5, 1, 0}, {RW, 0, 7, 0},
    {BZ, 0, 1, 0}, {BZ, 1, 1, 0}, {BY, 4, 1, 0}, {GW, 0, 7, 0},
    {BY, 5, 1, 0}, {BZ, 2, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 7, 0},
    {BZ, 3, 1, 0}, {BZ, 5, 1, 0}, {BZ, 4, 1, 0}, {RX, 0, 6, 0},
    {GY, 0, 4, 0}, {GX, 0, 6, 0}, {GZ, 0, 4, 0}, {BX, 0, 6, 0},
    {BY, 0, 4, 0}, {RY, 0, 6, 0}, {RZ, 0, 6, 0}};
const Run kRuns2[] = {
    {RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 5, 0},
    {RW, 10, 1, 0}, {GY, 0, 4, 0}, {GX, 0, 4, 0}, {GW, 10, 1, 0},
    {BZ, 0, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 4, 0}, {BW, 10, 1, 0},
    {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 5, 0}, {BZ, 2, 1, 0},
    {RZ, 0, 5, 0}, {BZ, 3, 1, 0}};
const Run kRuns3[] = {
    {RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 4, 0},
    {RW, 10, 1, 0}, {GZ, 4, 1, 0}, {GY, 0, 4, 0}, {GX, 0, 5, 0},
    {GW, 10, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 4, 0}, {BW, 10, 1, 0},
    {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 4, 0}, {BZ, 0, 1, 0},
    {BZ, 2, 1, 0}, {RZ, 0, 4, 0}, {GY, 4, 1, 0}, {BZ, 3, 1, 0}};
const Run kRuns4[] = {
    {RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 4, 0},
    {RW, 10, 1, 0}, {BY, 4, 1, 0}, {GY, 0, 4, 0}, {GX, 0, 4, 0},
    {GW, 10, 1, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 5, 0},
    {BW, 10, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 4, 0}, {BZ, 1, 1, 0},
    {BZ, 2, 1, 0}, {RZ, 0, 4, 0}, {BZ, 4, 1, 0}, {BZ, 3, 1, 0}};
const Run kRuns5[] = {
    {RW, 0, 9, 0}, {BY, 4, 1, 0}, {GW, 0, 9, 0}, {GY, 4, 1, 0},
    {BW, 0, 9, 0}, {BZ, 4, 1, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0},
    {GY, 0, 4, 0}, {GX, 0, 5, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0},
    {BX, 0, 5, 0}, {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 5, 0},
    {BZ, 2, 1, 0}, {RZ, 0, 5, 0}, {BZ, 3, 1, 0}};
const Run kRuns6[] = {
    {RW, 0, 8, 0}, {GZ, 4, 1, 0}, {BY, 4, 1, 0}, {GW, 0, 8, 0},
    {BZ, 2, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 8, 0}, {BZ, 3, 1, 0},
    {BZ, 4, 1, 0}, {RX, 0, 6, 0}, {GY, 0, 4, 0}, {GX, 0, 5, 0},
    {BZ, 0, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 5, 0}, {BZ, 1, 1, 0},
    {BY, 0, 4, 0}, {RY, 0, 6, 0}, {RZ, 0, 6, 0}};
const Run kRuns7[] = {
    {RW, 0, 8, 0}, {BZ, 0, 1, 0}, {BY, 4, 1, 0}, {GW, 0, 8, 0},
    {GY, 5, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 8, 0}, {GZ, 5, 1, 0},
    {BZ, 4, 1, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0}, {GY, 0, 4, 0},
    {GX, 0, 6, 0}, {GZ, 0, 4, 0}, {BX, 0, 5, 0}, {BZ, 1, 1, 0},
    {BY, 0, 4, 0}, {RY, 0, 5, 0}, {BZ, 2, 1, 0}, {RZ, 0, 5, 0},
    {BZ, 3, 1, 0}};
const Run kRuns8[] = {
    {RW, 0, 8, 0}, {BZ, 1, 1, 0}, {BY, 4, 1, 0}, {GW, 0, 8, 0},
    {BY, 5, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 8, 0}, {BZ, 5, 1, 0},
    {BZ, 4, 1, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0}, {GY, 0, 4, 0},
    {GX, 0, 5, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 6, 0},
    {BY, 0, 4, 0}, {RY, 0, 5, 0}, {BZ, 2, 1, 0}, {RZ, 0, 5, 0},
    {BZ, 3, 1, 0}};
const Run kRuns9[] = {
    {RW, 0, 6, 0}, {GZ, 4, 1, 0}, {BZ, 0, 1, 0}, {BZ, 1, 1, 0},
    {BY, 4, 1, 0}, {GW, 0, 6, 0}, {GY, 5, 1, 0}, {BY, 5, 1, 0},
    {BZ, 2, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 6, 0}, {GZ, 5, 1, 0},
    {BZ, 3, 1, 0}, {BZ, 5, 1, 0}, {BZ, 4, 1, 0}, {RX, 0, 6, 0},
    {GY, 0, 4, 0}, {GX, 0, 6, 0}, {GZ, 0, 4, 0}, {BX, 0, 6, 0},
    {BY, 0, 4, 0}, {RY, 0, 6, 0}, {RZ, 0, 6, 0}};
const Run kRuns10[] = {
    {RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0},
    {RX, 0, 10, 0}, {GX, 0, 10, 0}, {BX, 0, 10, 0}};
const Run kRuns11[] = {
    {RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 9, 0},
    {RW, 10, 1, 0}, {GX, 0, 9, 0}, {GW, 10, 1, 0}, {BX, 0, 9, 0},
    {BW, 10, 1, 0}};
const Run kRuns12[] = {
    {RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 8, 0},
    {RW, 10, 2, 1}, {GX, 0, 8, 0}, {GW, 10, 2, 1}, {BX, 0, 8, 0},
    {BW, 10, 2, 1}};
const Run kRuns13[] = {
    {RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 4, 0},
    {RW, 10, 6, 1}, {GX, 0, 4, 0}, {GW, 10, 6, 1}, {BX, 0, 4, 0},
    {BW, 10, 6, 1}};

struct Layout {
    const Run* runs;
    int count;
};

#define LAYOUT(r) {r, int(sizeof(r) / sizeof(r[0]))}
const Layout kLayouts[14] = {
    LAYOUT(kRuns0), LAYOUT(kRuns1),  LAYOUT(kRuns2),  LAYOUT(kRuns3),
    LAYOUT(kRuns4), LAYOUT(kRuns5),  LAYOUT(kRuns6),  LAYOUT(kRuns7),
    LAYOUT(kRuns8), LAYOUT(kRuns9),  LAYOUT(kRuns10), LAYOUT(kRuns11),
    LAYOUT(kRuns12), LAYOUT(kRuns13)};
#undef LAYOUT

// the low `bits` bits of v as a two's complement number
int sign_extend(int v, int bits) {
    v &= (1 << bits) - 1;
    return v & (1 << (bits - 1)) ? v - (1 << bits) : v;
}

int unquantize(int v, int bits, bool is_signed) {
    if (!is_signed) {
        if (bits >= 15 || v == 0) return v;
        if (v == (1 << bits) - 1) return 0xffff;
        return ((v << 15) + 0x4000) >> (bits - 1);
    }
    v = sign_extend(v, 16);             // Pillow keeps endpoints as int16
    if (bits >= 16) return v;
    int neg = v < 0, x = neg ? -v : v;
    if (x >= (1 << (bits - 1)) - 1) {
        x = 0x7fff;
    } else if (x) {
        x = ((x << 15) + 0x4000) >> (bits - 1);
    }
    return neg ? -x : x;
}

float half_to_float(unsigned h) {
    uint32_t bits = (h & 0x7fffu) << 13;
    float f;
    std::memcpy(&f, &bits, 4);
    f *= 5.192296858534828e+33f;        // 2^112: the exponent's bias
    if (f >= 65536.0f) {                // infinity and NaN stay so
        std::memcpy(&bits, &f, 4);
        bits |= 255u << 23;
        std::memcpy(&f, &bits, 4);
    }
    if (h & 0x8000u) f = -f;
    return f;
}

// a lerped channel: the finishing multiply, then the half as u8
uint8_t bc6_channel(int v, bool is_signed) {
    unsigned h;
    if (!is_signed) {
        h = unsigned(v * 31 / 64);
    } else if (v < 0) {
        h = 0x8000u | unsigned(-v * 31 / 32);
    } else {
        h = unsigned(v * 31 / 32);
    }
    float f = half_to_float(h & 0xffff);
    if (f < 0.0f) return 0;
    if (f > 1.0f) return 255;
    return uint8_t(f * 255.0f);
}

void bc6_block(const uint8_t* s, bool is_signed, Rgba* out) {
    int low = s[0] & 31, mode, pos;
    if ((low & 3) < 2) {
        mode = low & 3;
        pos = 2;
    } else {
        mode = ((low & 3) == 2 ? 2 : 10) + (low >> 2);
        pos = 5;
    }
    if (mode >= 14) {                   // a reserved mode
        for (int i = 0; i < 16; ++i) out[i] = {0, 0, 0, 0};
        return;
    }
    const Bc6Mode& m = kBc6Modes[mode];
    int ep[12] = {};
    const Layout& lay = kLayouts[mode];
    for (int k = 0; k < lay.count; ++k) {
        const Run& run = lay.runs[k];
        for (int j = 0; j < run.count; ++j, ++pos) {
            int bit = int(get_bits(s, pos, 1));
            int at = run.reversed ? run.lo + run.count - 1 - j : run.lo + j;
            ep[run.ep] |= bit << at;
        }
    }
    int partition = m.regions == 2 ? int(get_bits(s, pos, 5)) : 0;
    pos += m.regions == 2 ? 5 : 0;
    int n_ep = 6 * m.regions, eb = m.endpoint_bits;
    if (is_signed)
        for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], eb);
    if (is_signed || m.transformed)
        for (int e = 3; e < n_ep; ++e)
            ep[e] = sign_extend(ep[e], m.delta_bits[e % 3]);
    if (m.transformed)                  // signed too: not sign-extended
        for (int e = 3; e < n_ep; ++e)
            ep[e] = (ep[e] + ep[e % 3]) & ((1 << eb) - 1);
    int unq[12];
    for (int e = 0; e < n_ep; ++e) unq[e] = unquantize(ep[e], eb, is_signed);
    int ib = m.regions == 2 ? 3 : 4;
    const uint8_t* w = weights(ib);
    for (int i = 0; i < 16; ++i) {
        int sub = subset_of(m.regions, partition, i);
        int bits = ib - (anchor(m.regions, partition, sub, i) ? 1 : 0);
        int wi = w[get_bits(s, pos, bits)];
        pos += bits;
        const int* e0 = &unq[6 * sub];
        const int* e1 = e0 + 3;
        uint8_t c[3];
        for (int k = 0; k < 3; ++k)
            c[k] = bc6_channel((e0[k] * (64 - wi) + e1[k] * wi) >> 6,
                               is_signed);
        out[i] = {c[0], c[1], c[2], 255};
    }
}

void decode_block(const uint8_t* s, int kind, bool is_signed, Rgba* px) {
    uint8_t v[16], u[16];
    switch (kind) {
        case 1:
            bc1_colour(s, false, px);
            break;
        case 2:
            bc1_colour(s + 8, true, px);
            for (int i = 0; i < 16; ++i)
                px[i].a = uint8_t(((s[i / 2] >> (4 * (i % 2))) & 15) * 17);
            break;
        case 3:
            bc1_colour(s + 8, true, px);
            bc4_values(s, false, v);
            for (int i = 0; i < 16; ++i) px[i].a = v[i];
            break;
        case 4:
            bc4_values(s, false, v);
            for (int i = 0; i < 16; ++i) px[i] = {v[i], v[i], v[i], 255};
            break;
        case 5:
            bc4_values(s, is_signed, v);
            bc4_values(s + 8, is_signed, u);
            for (int i = 0; i < 16; ++i)
                px[i] = {v[i], u[i], uint8_t(is_signed ? 128 : 0), 255};
            break;
        case 6:
            bc6_block(s, is_signed, px);
            break;
        default:
            bc7_block(s, px);
    }
}

}  // namespace

extern "C" {

int cge_bcn_decode(const unsigned char* data, long n, int kind, int is_signed,
                   int blocks_w, int blocks_h, unsigned char* rgba, char* err,
                   int errlen) {
    const char* names[8] = {"", "BC1", "BC2", "BC3", "BC4", "BC5", "BC6H",
                            "BC7"};
    if (kind < 1 || kind > 7 || blocks_w < 0 || blocks_h < 0) {
        std::snprintf(err, size_t(errlen), "BC%d with a %dx%d block grid: "
                      "only BC1 to BC7 exist", kind, blocks_w, blocks_h);
        return -1;
    }
    long long size = kind == 1 || kind == 4 ? 8 : 16;
    long long need = size * blocks_w * blocks_h;
    if (n < need) {
        std::snprintf(err, size_t(errlen), "%s block data is truncated: %ld "
                      "of its %lld bytes (%lld missing)", names[kind], n,
                      need, need - n);
        return -1;
    }
    long long row = 16LL * blocks_w;    // bytes in a row of pixels
    for (int by = 0; by < blocks_h; ++by) {
        for (int bx = 0; bx < blocks_w; ++bx) {
            Rgba px[16];
            decode_block(data + size * (by * (long long)blocks_w + bx), kind,
                         is_signed != 0, px);
            for (int y = 0; y < 4; ++y)
                std::memcpy(rgba + (4LL * by + y) * row + 16LL * bx,
                            &px[4 * y], 16);
        }
    }
    return 0;
}

}  // extern "C"
