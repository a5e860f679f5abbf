// JPEG 2000 codestream decoding (ITU-T T.800 Part 1) for the port's texture
// loader (cge_tpu_torch/scene/jpeg2000.py), as OpenJPEG 2.5.4 computes it
// under Pillow 12, whose Jpeg2KDecode.c drives it tile by tile
// (opj_read_tile_header / opj_decode_tile_data) in OpenJPEG's default,
// strict mode, at full resolution with every quality layer.
//
// What runs here, in OpenJPEG's order and arithmetic:
//
//   - the main header (SIZ first, then COD, COC, QCD, QCC, RGN, POC, PPM,
//     TLM, PLM, CRG, COM, unknown markers skipped two bytes at a time as
//     opj_j2k_read_unk does) and the tile-part headers (COD, COC, QCD, QCC,
//     RGN, POC, PPT, PLT, COM), each marker's checks as OpenJPEG makes them;
//     a later COD or QCD copies its values over every component, as
//     opj_j2k_copy_tile_component_parameters does;
//   - the tile loop of Pillow over OpenJPEG's decoder state: tile-parts in
//     order, Psot 0 (the tile-part runs to two bytes before the end of the
//     stream), a tile decoded when its last tile-part (TNsot) is read or at
//     the end of the stream, no tile-part count correction (Pillow's
//     stream cannot seek); a stream cut short is an error,
//     as OpenJPEG's strict mode makes it, but where the cut falls between
//     packets (the packets after it read as empty);
//   - the packet iterator (opj_pi_next_lrcp, _rlcp, _rpcl, _pcrl, _cprl)
//     over the progression order or the POC volumes, each packet read once
//     (OpenJPEG's include array), precincts, tag trees, packet headers from
//     the stream, from PPT or from PPM, SOP markers (optional) and EPH
//     markers (a missing one is an error);
//   - the code-blocks: the MQ decoder with OpenJPEG's artificial 0xFF 0xFF
//     at each segment's end, the raw (bypass) segments, the significance,
//     refinement and cleanup passes, the six code-block style bits, the
//     reconstruction at the middle of each coefficient's interval (one
//     extra fractional bit, as opj_t1_decode_cblk keeps it), ROI max-shift;
//   - dequantisation: reversible (the extra bit dropped by C division),
//     irreversible as float32 products by half the step size of E.1 with
//     OpenJPEG's decoder-side gain of 0 (its BUG_WEIRD_TWO_INVK);
//   - the inverse 5/3 (integer lifting, a lone odd sample halved) and 9/7
//     (float32 lifting in opj_v8dwt_decode's order: low band times K, high
//     band times 1.625732422, then the four steps, each (left + right) * c
//     added; a lone sample left alone) transforms, rows before columns;
//   - RCT and ICT (float32, opj_mct_decode_real's order), the DC level
//     shift, lrintf rounding and the clamp to each component's range.
//
// HTJ2K (Part 15: a CAP or CPF marker, or code-block style bit 6 or 7) and
// Part 2 (MCT / MCC / MCO / CBD / ATK / ADS markers, transforms past 5/3
// and 9/7, an MCT of 2) are refused by name; Rsiz's Part 2 and Part 15 bits
// alone are not, as OpenJPEG decodes such a stream as Part 1. The file is
// built with -ffp-contract=off (no fused multiply-add) and -fwrapv, as
// OpenJPEG's float and integer paths compute.
//
// Entry points (C ABI, loaded with ctypes): cge_j2k_open parses the main
// header into a handle, cge_j2k_info and cge_j2k_comp read it,
// cge_j2k_decode runs the tile loop, cge_j2k_tile reads a decoded tile's
// box and each component's samples, cge_j2k_free releases the handle;
// cge_j2k_idwt53 runs one inverse 5/3 level and the RCT on given
// coefficients (the tests hold it to a numpy twin). Each returns 0, or -1
// with a message in err.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <string>
#include <vector>

namespace {

struct DecodeError {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

std::string hex4(uint32_t v) {
    char buf[16];
    std::snprintf(buf, sizeof buf, "0x%04X", v);
    return buf;
}

// ------------------------------------------------------------ arithmetic

int32_t int_ceildiv(int64_t a, int64_t b) {
    return static_cast<int32_t>((a + b - 1) / b);
}
uint32_t uint_ceildiv(uint64_t a, uint64_t b) {
    return static_cast<uint32_t>((a + b - 1) / b);
}
int32_t int_ceildivpow2(int64_t a, int b) {
    return static_cast<int32_t>((a + (int64_t(1) << b) - 1) >> b);
}
int32_t int_floordivpow2(int32_t a, int b) { return a >> b; }
uint32_t uint_floordivpow2(uint32_t a, uint32_t b) { return a >> b; }

// ------------------------------------------------------------ coding state

enum Marker : uint32_t {
    kSOC = 0xFF4F, kCAP = 0xFF50, kSIZ = 0xFF51, kCOD = 0xFF52, kCOC = 0xFF53,
    kTLM = 0xFF55, kPLM = 0xFF57, kPLT = 0xFF58, kCPF = 0xFF59, kQCD = 0xFF5C,
    kQCC = 0xFF5D, kRGN = 0xFF5E, kPOC = 0xFF5F, kPPM = 0xFF60, kPPT = 0xFF61,
    kCRG = 0xFF63, kCOM = 0xFF64, kADS = 0xFF73, kMCT = 0xFF74,
    kMCC = 0xFF75, kMCO = 0xFF77, kCBD = 0xFF78, kATK = 0xFF79,
    kSOT = 0xFF90, kSOP = 0xFF91, kEPH = 0xFF92, kSOD = 0xFF93, kEOC = 0xFFD9,
};

// OpenJPEG's decoder states (j2k.h)
enum State : uint32_t {
    kMHSIZ = 0x0002, kMH = 0x0004, kTPHSOT = 0x0008, kTPH = 0x0010,
    kNEOC = 0x0040, kEOCState = 0x0100,
};

constexpr int kMaxRes = 33;
constexpr int kMaxBands = 3 * kMaxRes - 2;
// code-block styles
constexpr uint32_t kLazy = 0x01, kReset = 0x02, kTermAll = 0x04,
                   kVsc = 0x08, kSegSym = 0x20, kHT = 0x40;

struct StepSize {
    int expn = 0, mant = 0;
};

struct CompCoding {                 // opj_tccp_t
    uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0;
    uint32_t qmfbid = 0, qntsty = 0, numgbits = 0, roishift = 0;
    uint32_t prcw[kMaxRes] = {}, prch[kMaxRes] = {};
    StepSize steps[kMaxBands];
};

struct Poc {
    uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
    uint32_t prg = 0;
};

struct TileCoding {                 // opj_tcp_t
    uint32_t csty = 0, prg = 0, numlayers = 0, mct = 0;
    std::vector<CompCoding> comps;
    bool poc = false;
    uint32_t numpocs = 0;
    std::vector<Poc> pocs;
    int part = -1;                  // m_current_tile_part_number
    uint32_t nb_parts = 0;
    bool has_data = false;
    std::vector<uint8_t> data;      // the tile-parts' bodies, in order
    std::vector<std::vector<uint8_t>> ppt_markers;
    std::vector<bool> ppt_seen;
    bool ppt = false;
    std::vector<uint8_t> ppt_data;
    size_t ppt_pos = 0;
    bool decoded = false;
};

struct Comp {
    uint32_t dx = 1, dy = 1, prec = 8;
    bool sgnd = false;
};

// ------------------------------------------------------------ MQ decoder

struct QeRow {
    uint32_t qe;
    uint8_t nmps, nlps, sw;
};

const QeRow kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// contexts (t1.h): 9 zero coding, 5 sign, 3 magnitude, aggregation, uniform
constexpr int kCtxZC = 0, kCtxSC = 9, kCtxMag = 14, kCtxAgg = 17,
              kCtxUni = 18, kNumCtx = 19;

struct Mq {
    // the segment's bytes followed by OpenJPEG's artificial 0xFF 0xFF
    std::vector<uint8_t> buf;
    size_t bp = 0;
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t index[kNumCtx] = {}, mps[kNumCtx] = {};

    void reset_states() {
        std::memset(index, 0, sizeof index);
        std::memset(mps, 0, sizeof mps);
        index[kCtxUni] = 46;
        index[kCtxAgg] = 3;
        index[kCtxZC] = 4;
    }
    void set(const uint8_t* p, uint32_t len) {
        buf.assign(p, p + len);
        buf.push_back(0xFF);
        buf.push_back(0xFF);
        bp = 0;
    }
    void bytein() {
        if (buf[bp] == 0xFF) {
            if (buf[bp + 1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                ++bp;
                c += static_cast<uint32_t>(buf[bp]) << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += static_cast<uint32_t>(buf[bp]) << 8;
            ct = 8;
        }
    }
    void init_mq(const uint8_t* p, uint32_t len) {
        set(p, len);
        c = len ? static_cast<uint32_t>(buf[0]) << 16 : 0xFFu << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void init_raw(const uint8_t* p, uint32_t len) {
        set(p, len);
        c = 0;
        ct = 0;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while ((a & 0x8000) == 0);
    }
    int decode(int cx) {
        const QeRow& q = kQe[index[cx]];
        int d;
        a -= q.qe;
        if ((c >> 16) < q.qe) {
            if (a < q.qe) {
                d = mps[cx];
                index[cx] = q.nmps;
            } else {
                d = !mps[cx];
                if (q.sw) mps[cx] = !mps[cx];
                index[cx] = q.nlps;
            }
            a = q.qe;
            renorm();
        } else {
            c -= q.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < q.qe) {
                    d = !mps[cx];
                    if (q.sw) mps[cx] = !mps[cx];
                    index[cx] = q.nlps;
                } else {
                    d = mps[cx];
                    index[cx] = q.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (buf[bp] > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = buf[bp++];
                    ct = 7;
                }
            } else {
                c = buf[bp++];
                ct = 8;
            }
        }
        --ct;
        return (c >> ct) & 1;
    }
};

// ------------------------------------------------------------ tier 1

// per sample state
constexpr uint8_t kSig = 1, kNeg = 2, kVisited = 4, kRefined = 8;

struct T1 {
    int w = 0, h = 0, sw = 0;       // sw: state row stride (w + 2)
    std::vector<int32_t> data;
    std::vector<uint8_t> st;        // (h + 2) x (w + 2), a border of zeros
    Mq mq;
    int orient = 0;
    bool vsc = false;

    uint8_t& at(int x, int y) { return st[(y + 1) * sw + x + 1]; }
    // the neighbour below, hidden for a stripe's last row under VSC
    bool below_hidden(int y) const { return vsc && (y & 3) == 3; }
    bool sig(int x, int y) { return at(x, y) & kSig; }

    int zc_context(int x, int y) {
        const bool hide = below_hidden(y);
        int h = sig(x - 1, y) + sig(x + 1, y);
        int v = sig(x, y - 1) + (hide ? 0 : sig(x, y + 1));
        int d = sig(x - 1, y - 1) + sig(x + 1, y - 1) +
                (hide ? 0 : sig(x - 1, y + 1) + sig(x + 1, y + 1));
        int n = 0;
        if (orient == 3) {
            const int hv = h + v;
            if (!d) n = !hv ? 0 : hv == 1 ? 1 : 2;
            else if (d == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
            else if (d == 2) n = !hv ? 6 : 7;
            else n = 8;
        } else {
            if (orient == 1) std::swap(h, v);
            if (!h) n = !v ? (!d ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
            else if (h == 1) n = !v ? (!d ? 5 : 6) : 7;
            else n = 8;
        }
        return kCtxZC + n;
    }
    int contribution(int x, int y) {
        const uint8_t s = at(x, y);
        return (s & kSig) ? ((s & kNeg) ? -1 : 1) : 0;
    }
    // sign coding: the context and the bit XORed with the decoded one
    void sc_context(int x, int y, int* cx, int* xorbit) {
        int h = contribution(x - 1, y) + contribution(x + 1, y);
        int v = contribution(x, y - 1) +
                (below_hidden(y) ? 0 : contribution(x, y + 1));
        h = h < -1 ? -1 : h > 1 ? 1 : h;
        v = v < -1 ? -1 : v > 1 ? 1 : v;
        if (h < 0 || (h == 0 && v < 0)) {
            h = -h;
            v = -v;
            *xorbit = 1;
        } else {
            *xorbit = 0;
        }
        // (h, v) with h >= 0: (1,1) 13, (1,0) 12, (1,-1) 11, (0,1) 10, (0,0) 9
        *cx = kCtxSC + (h ? 3 + v : v ? 1 : 0);
    }
    bool any_neighbour(int x, int y) {
        const bool hide = below_hidden(y);
        return sig(x - 1, y) || sig(x + 1, y) || sig(x, y - 1) ||
               sig(x - 1, y - 1) || sig(x + 1, y - 1) ||
               (!hide && (sig(x, y + 1) || sig(x - 1, y + 1) ||
                          sig(x + 1, y + 1)));
    }

    void become_significant(int x, int y, int neg, int32_t oneplushalf) {
        data[y * w + x] = neg ? -oneplushalf : oneplushalf;
        at(x, y) |= kSig | (neg ? kNeg : 0);
    }

    void decode_sign(int x, int y, int32_t oneplushalf) {
        int cx, xorbit;
        sc_context(x, y, &cx, &xorbit);
        become_significant(x, y, mq.decode(cx) ^ xorbit, oneplushalf);
    }

    template <typename Fn>
    void each_in_stripes(Fn fn) {
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < k + 4 && y < h; ++y) fn(x, y);
    }

    void sigpass(int bpno, bool raw) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        each_in_stripes([&](int x, int y) {
            uint8_t& s = at(x, y);
            if ((s & (kSig | kVisited)) || !any_neighbour(x, y)) return;
            if (raw) {
                if (mq.raw()) become_significant(x, y, mq.raw(), oneplushalf);
            } else if (mq.decode(zc_context(x, y))) {
                decode_sign(x, y, oneplushalf);
            }
            at(x, y) |= kVisited;
        });
    }

    void refpass(int bpno, bool raw) {
        const int32_t poshalf = (1 << bpno) >> 1;
        each_in_stripes([&](int x, int y) {
            uint8_t& s = at(x, y);
            if ((s & (kSig | kVisited)) != kSig) return;
            int v;
            if (raw) {
                v = mq.raw();
            } else {
                const int cx = (s & kRefined) ? kCtxMag + 2
                               : any_neighbour(x, y) ? kCtxMag + 1 : kCtxMag;
                v = mq.decode(cx);
            }
            int32_t& d = data[y * w + x];
            d += (v ^ (d < 0)) ? poshalf : -poshalf;
            s |= kRefined;
        });
    }

    // a full stripe's column in run mode: all four insignificant, unvisited
    // and with no significant neighbour
    bool run_mode(int x, int k) {
        for (int y = k; y < k + 4; ++y)
            if ((at(x, y) & (kSig | kVisited)) || any_neighbour(x, y))
                return false;
        return true;
    }

    void clnpass(int bpno, bool segsym) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4) {
            for (int x = 0; x < w; ++x) {
                int y = k;
                if (k + 4 <= h && run_mode(x, k)) {
                    if (!mq.decode(kCtxAgg)) goto column_done;
                    int runlen = mq.decode(kCtxUni);
                    runlen = (runlen << 1) | mq.decode(kCtxUni);
                    y = k + runlen;
                    decode_sign(x, y, oneplushalf);
                    ++y;
                }
                for (; y < k + 4 && y < h; ++y) {
                    if (at(x, y) & (kSig | kVisited)) continue;
                    if (mq.decode(zc_context(x, y)))
                        decode_sign(x, y, oneplushalf);
                }
            column_done:
                for (int yy = k; yy < k + 4 && yy < h; ++yy)
                    at(x, yy) &= static_cast<uint8_t>(~kVisited);
            }
        }
        if (segsym)
            for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
    }
};

// ------------------------------------------------------------ tier 2

struct Seg {
    uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0;
    uint32_t numnewpasses = 0, newlen = 0;
};

struct Cblk {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0;
    uint32_t numsegs = 0;
    std::vector<Seg> segs;
    std::vector<uint8_t> data;      // the chunks, concatenated
};

struct TagTree {                    // opj_tgt_tree_t
    struct Node {
        int32_t value = 999, low = 0;
        int32_t parent = -1;
    };
    std::vector<Node> nodes;

    void build(uint32_t leafsh, uint32_t leafsv) {
        nodes.clear();
        if (!leafsh || !leafsv) return;
        std::vector<uint32_t> ws{leafsh}, hs{leafsv}, offs{0};
        uint32_t total = 0;
        for (;;) {
            const uint32_t n = ws.back() * hs.back();
            total += n;
            if (n <= 1) break;
            offs.push_back(total);
            ws.push_back((ws.back() + 1) / 2);
            hs.push_back((hs.back() + 1) / 2);
        }
        nodes.assign(total, Node());
        for (size_t l = 0; l + 1 < ws.size(); ++l)
            for (uint32_t y = 0; y < hs[l]; ++y)
                for (uint32_t x = 0; x < ws[l]; ++x)
                    nodes[offs[l] + y * ws[l] + x].parent = static_cast<int32_t>(
                        offs[l + 1] + (y / 2) * ws[l + 1] + x / 2);
    }
};

// OpenJPEG's bit reader (bio.c) over a packet header
struct Bio {
    const uint8_t* start = nullptr;
    const uint8_t* bp = nullptr;
    const uint8_t* end = nullptr;
    uint32_t buf = 0, ct = 0;

    Bio(const uint8_t* p, size_t len) : start(p), bp(p), end(p + len) {}
    void bytein() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        if (bp >= end) return;
        buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (int i = static_cast<int>(n) - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xFF) == 0xFF) bytein();
        ct = 0;
    }
    size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leafno,
                    int32_t threshold) {
    int32_t stk[32];
    int depth = 0;
    int32_t node = static_cast<int32_t>(leafno);
    while (tree.nodes[node].parent >= 0) {
        stk[depth++] = node;
        node = tree.nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
        TagTree::Node& n = tree.nodes[node];
        if (low > n.low) n.low = low;
        else low = n.low;
        while (low < threshold && low < n.value) {
            if (bio.read(1)) n.value = low;
            else ++low;
        }
        n.low = low;
        if (!depth) break;
        node = stk[--depth];
    }
    return tree.nodes[node].value < threshold ? 1 : 0;
}

struct Precinct {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t cw = 0, ch = 0;
    TagTree incl, imsb;
    std::vector<Cblk> cblks;
};

struct Band {
    int bandno = 0;
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    float stepsize = 0.0f;
    int32_t numbps = 0;
    std::vector<Precinct> precs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0;
    int numbands = 0;
    Band bands[3];
};

struct TileComp {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numres = 0;
    std::vector<Res> res;
    std::vector<int32_t> idata;     // reversible samples, or float bits
    int32_t w() const { return x1 - x0; }
    int32_t h() const { return y1 - y0; }
    float* fdata() { return reinterpret_cast<float*>(idata.data()); }
};

struct DecodedTile {
    uint32_t index = 0;
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<int32_t> box;       // per component: x0, y0, x1, y1
    std::vector<std::vector<int32_t>> samples;
};

// ------------------------------------------------------------ the decoder

struct Decoder {
    const uint8_t* data = nullptr;
    size_t len = 0, pos = 0;        // the stream: data[start:len]
    // image
    uint32_t rsiz = 0, x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    std::vector<Comp> comps;
    // per component, the highest resolution any decoded packet belonged to
    // (opj_image_comp_t's resno_decoded: kept across tiles, 0 at first);
    // the inverse transform stops there and the tile's samples are that
    // resolution's
    std::vector<uint32_t> resno_decoded;
    TileCoding defaults;
    // each tile's coding, a copy of the main header's made at the tile's
    // first tile-part (OpenJPEG copies it into every tile when the main
    // header ends; no marker changes the defaults after that)
    std::vector<std::unique_ptr<TileCoding>> tiles;
    size_t ntiles = 0;
    TileCoding& tile(size_t t) {
        if (!tiles[t]) tiles[t] = std::make_unique<TileCoding>(defaults);
        return *tiles[t];
    }
    // a tile's state without making its coding
    int tile_part(size_t t) const { return tiles[t] ? tiles[t]->part : -1; }
    uint32_t tile_parts(size_t t) const { return tiles[t] ? tiles[t]->nb_parts : 0; }
    bool tile_pending(size_t t) const {
        return tiles[t] && tiles[t]->has_data && !tiles[t]->decoded;
    }
    // PPM
    bool ppm = false;
    std::vector<std::vector<uint8_t>> ppm_markers;
    std::vector<bool> ppm_seen;
    std::vector<uint8_t> ppm_data;
    size_t ppm_pos = 0;
    // tile loop state (j2k.c's m_decoder)
    uint32_t state = 0;
    uint32_t current_tile = 0;
    uint32_t sot_length = 0;
    bool last_tile_part = false, can_decode = false;
    std::vector<DecodedTile> out;

    size_t left() const { return len - pos; }
    bool read(uint8_t* dst, size_t n) {
        if (left() < n) {
            pos = len;
            return false;
        }
        std::memcpy(dst, data + pos, n);
        pos += n;
        return true;
    }
    bool read16(uint32_t* v) {
        uint8_t b[2];
        if (!read(b, 2)) return false;
        *v = (static_cast<uint32_t>(b[0]) << 8) | b[1];
        return true;
    }

    TileCoding& coding() {
        return (state & kTPH) ? tile(current_tile) : defaults;
    }

    // -------------------------------------------------- marker segments

    void read_siz(const uint8_t* p, uint32_t n) {
        if (n < 36) fail("JPEG 2000 SIZ marker of " + std::to_string(n + 2) +
                         " bytes: too short");
        auto r32 = [&](int at) {
            return (static_cast<uint32_t>(p[at]) << 24) |
                   (static_cast<uint32_t>(p[at + 1]) << 16) |
                   (static_cast<uint32_t>(p[at + 2]) << 8) | p[at + 3];
        };
        rsiz = (static_cast<uint32_t>(p[0]) << 8) | p[1];
        x1 = r32(2); y1 = r32(6); x0 = r32(10); y0 = r32(14);
        tdx = r32(18); tdy = r32(22); tx0 = r32(26); ty0 = r32(30);
        const uint32_t csiz = (static_cast<uint32_t>(p[34]) << 8) | p[35];
        if ((n - 36) % 3 || (n - 36) / 3 != csiz)
            fail("JPEG 2000 SIZ marker: its size does not hold " +
                 std::to_string(csiz) + " components");
        if (x0 >= x1 || y0 >= y1)
            fail("JPEG 2000 SIZ marker: an empty image");
        if (!tdx || !tdy) fail("JPEG 2000 SIZ marker: a tile of size 0");
        if (!csiz || csiz > 16384)
            fail("JPEG 2000 SIZ marker: " + std::to_string(csiz) +
                 " components");
        if (csiz > 4)                   // Pillow refuses these after the header
            fail("JPEG 2000 image of " + std::to_string(csiz) +
                 " components: Pillow decodes 1 to 4");
        if (tx0 > x0 || ty0 > y0)
            fail("JPEG 2000 SIZ marker: the tile origin lies past the image "
                 "origin");
        if (static_cast<uint64_t>(tx0) + tdx <= x0 ||
            static_cast<uint64_t>(ty0) + tdy <= y0)
            fail("JPEG 2000 SIZ marker: the first tile holds no image");
        comps.resize(csiz);
        for (uint32_t i = 0; i < csiz; ++i) {
            const uint8_t* c = p + 36 + 3 * i;
            comps[i].prec = (c[0] & 0x7F) + 1;
            comps[i].sgnd = c[0] >> 7;
            comps[i].dx = c[1];
            comps[i].dy = c[2];
            if (comps[i].dx < 1 || comps[i].dy < 1)
                fail("JPEG 2000 SIZ marker: component " + std::to_string(i) +
                     " has a subsampling of 0");
            if (comps[i].prec > 31)
                fail("JPEG 2000 component of " +
                     std::to_string(comps[i].prec) + " bits: OpenJPEG reads "
                     "up to 31");
        }
        tw = uint_ceildiv(x1 - tx0, tdx);
        th = uint_ceildiv(y1 - ty0, tdy);
        if (!tw || !th || tw > 65535 / th)
            fail("JPEG 2000 SIZ marker: an invalid number of tiles");
        defaults.comps.assign(csiz, CompCoding());
        resno_decoded.assign(csiz, 0);
        state = kMH;
    }

    void read_spcod(CompCoding& t, const uint8_t*& p, uint32_t& n,
                    const char* what) {
        if (n < 5) fail(std::string("JPEG 2000 ") + what + " marker: too short");
        t.numres = p[0] + 1u;
        if (t.numres > kMaxRes)
            fail(std::string("JPEG 2000 ") + what + " marker: " +
                 std::to_string(t.numres) + " resolution levels");
        t.cblkw = p[1] + 2u;
        t.cblkh = p[2] + 2u;
        if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
            fail(std::string("JPEG 2000 ") + what + " marker: an invalid "
                 "code-block size");
        t.cblksty = p[3];
        if (t.cblksty & 0xC0)
            fail("JPEG 2000 HTJ2K (Part 15) code-blocks (style " +
                 hex4(t.cblksty) + "): high-throughput code-blocks are not "
                 "supported");
        t.qmfbid = p[4];
        if (t.qmfbid > 1)
            fail(std::string("JPEG 2000 ") + what + " marker: transform " +
                 std::to_string(t.qmfbid) + " (Part 2 kernels are not "
                 "supported)");
        p += 5;
        n -= 5;
        if (t.csty & 1) {
            if (n < t.numres)
                fail(std::string("JPEG 2000 ") + what + " marker: too short "
                     "for its precinct sizes");
            for (uint32_t i = 0; i < t.numres; ++i) {
                const uint32_t v = p[i];
                if (i && ((v & 0xF) == 0 || (v >> 4) == 0))
                    fail("JPEG 2000: an invalid precinct size");
                t.prcw[i] = v & 0xF;
                t.prch[i] = v >> 4;
            }
            p += t.numres;
            n -= t.numres;
        } else {
            for (uint32_t i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
        }
    }

    void read_cod(const uint8_t* p, uint32_t n) {
        TileCoding& tcp = coding();
        if (n < 5) fail("JPEG 2000 COD marker: too short");
        tcp.csty = p[0];
        if (tcp.csty & ~7u)
            fail("JPEG 2000 COD marker: an unknown Scod " + hex4(tcp.csty));
        tcp.prg = p[1];
        tcp.numlayers = (static_cast<uint32_t>(p[2]) << 8) | p[3];
        if (tcp.numlayers < 1)
            fail("JPEG 2000 COD marker: 0 quality layers");
        tcp.mct = p[4];
        if (tcp.mct > 1)
            fail("JPEG 2000 COD marker: multiple component transform " +
                 std::to_string(tcp.mct) + " (Part 2) is not supported");
        p += 5;
        n -= 5;
        for (auto& c : tcp.comps) c.csty = tcp.csty & 1;
        read_spcod(tcp.comps[0], p, n, "COD");
        if (n) fail("JPEG 2000 COD marker: its size does not match");
        for (size_t i = 1; i < tcp.comps.size(); ++i) {
            CompCoding& c = tcp.comps[i];
            c.numres = tcp.comps[0].numres;
            c.cblkw = tcp.comps[0].cblkw;
            c.cblkh = tcp.comps[0].cblkh;
            c.cblksty = tcp.comps[0].cblksty;
            c.qmfbid = tcp.comps[0].qmfbid;
            std::memcpy(c.prcw, tcp.comps[0].prcw, sizeof c.prcw);
            std::memcpy(c.prch, tcp.comps[0].prch, sizeof c.prch);
        }
    }

    uint32_t read_compno(const uint8_t*& p, uint32_t& n, const char* what) {
        const uint32_t room = comps.size() <= 256 ? 1 : 2;
        if (n < room) fail(std::string("JPEG 2000 ") + what + " marker: too short");
        const uint32_t c = room == 1 ? p[0] : (static_cast<uint32_t>(p[0]) << 8) | p[1];
        p += room;
        n -= room;
        if (c >= comps.size())
            fail(std::string("JPEG 2000 ") + what + " marker: component " +
                 std::to_string(c) + " of " + std::to_string(comps.size()));
        return c;
    }

    void read_coc(const uint8_t* p, uint32_t n) {
        TileCoding& tcp = coding();
        const uint32_t room = comps.size() <= 256 ? 1 : 2;
        if (n < room + 1) fail("JPEG 2000 COC marker: too short");
        const uint32_t c = read_compno(p, n, "COC");
        tcp.comps[c].csty = p[0];
        ++p;
        --n;
        read_spcod(tcp.comps[c], p, n, "COC");
        if (n) fail("JPEG 2000 COC marker: its size does not match");
    }

    void read_sqcd(CompCoding& t, const uint8_t*& p, uint32_t& n,
                   const char* what) {
        if (n < 1) fail(std::string("JPEG 2000 ") + what + " marker: too short");
        t.qntsty = p[0] & 0x1F;
        t.numgbits = p[0] >> 5;
        ++p;
        --n;
        uint32_t bands;
        if (t.qntsty == 1) bands = 1;
        else bands = t.qntsty == 0 ? n : n / 2;
        if (t.qntsty == 0) {
            for (uint32_t b = 0; b < bands; ++b)
                if (b < kMaxBands) {
                    t.steps[b].expn = p[b] >> 3;
                    t.steps[b].mant = 0;
                }
            if (n < bands) fail(std::string("JPEG 2000 ") + what + " marker: too short");
            p += bands;
            n -= bands;
        } else {
            if (n < 2 * bands) fail(std::string("JPEG 2000 ") + what + " marker: too short");
            for (uint32_t b = 0; b < bands; ++b) {
                const uint32_t v = (static_cast<uint32_t>(p[2 * b]) << 8) | p[2 * b + 1];
                if (b < kMaxBands) {
                    t.steps[b].expn = static_cast<int>(v >> 11);
                    t.steps[b].mant = static_cast<int>(v & 0x7FF);
                }
            }
            p += 2 * bands;
            n -= 2 * bands;
        }
        if (t.qntsty == 1)
            for (int b = 1; b < kMaxBands; ++b) {
                const int e = t.steps[0].expn - (b - 1) / 3;
                t.steps[b].expn = e > 0 ? e : 0;
                t.steps[b].mant = t.steps[0].mant;
            }
    }

    void read_qcd(const uint8_t* p, uint32_t n) {
        TileCoding& tcp = coding();
        read_sqcd(tcp.comps[0], p, n, "QCD");
        if (n) fail("JPEG 2000 QCD marker: its size does not match");
        for (size_t i = 1; i < tcp.comps.size(); ++i) {
            tcp.comps[i].qntsty = tcp.comps[0].qntsty;
            tcp.comps[i].numgbits = tcp.comps[0].numgbits;
            std::memcpy(tcp.comps[i].steps, tcp.comps[0].steps,
                        sizeof tcp.comps[0].steps);
        }
    }

    void read_qcc(const uint8_t* p, uint32_t n) {
        TileCoding& tcp = coding();
        const uint32_t c = read_compno(p, n, "QCC");
        read_sqcd(tcp.comps[c], p, n, "QCC");
        if (n) fail("JPEG 2000 QCC marker: its size does not match");
    }

    void read_rgn(const uint8_t* p, uint32_t n) {
        const uint32_t room = comps.size() <= 256 ? 1 : 2;
        if (n != 2 + room) fail("JPEG 2000 RGN marker: its size does not match");
        TileCoding& tcp = coding();
        const uint32_t c = read_compno(p, n, "RGN");
        tcp.comps[c].roishift = p[1];
    }

    void read_poc(const uint8_t* p, uint32_t n) {
        const uint32_t room = comps.size() <= 256 ? 1 : 2;
        const uint32_t chunk = 5 + 2 * room;
        uint32_t count = n / chunk;
        if (!count || n % chunk)
            fail("JPEG 2000 POC marker: its size does not match");
        TileCoding& tcp = coding();
        const uint32_t old = tcp.poc ? tcp.numpocs + 1 : 0;
        count += old;
        if (count >= 32) fail("JPEG 2000 POC marker: too many progressions");
        tcp.poc = true;
        tcp.pocs.resize(count);
        for (uint32_t i = old; i < count; ++i) {
            Poc& q = tcp.pocs[i];
            auto comp = [&]() {
                const uint32_t v = room == 1 ? p[0] : (static_cast<uint32_t>(p[0]) << 8) | p[1];
                p += room;
                return v;
            };
            q.resno0 = *p++;
            q.compno0 = comp();
            q.layno1 = (static_cast<uint32_t>(p[0]) << 8) | p[1];
            p += 2;
            if (q.layno1 > tcp.numlayers) q.layno1 = tcp.numlayers;
            q.resno1 = *p++;
            q.compno1 = comp();
            q.prg = *p++;
            if (q.compno1 > comps.size()) q.compno1 = static_cast<uint32_t>(comps.size());
        }
        tcp.numpocs = count - 1;
    }

    void read_ppm(const uint8_t* p, uint32_t n) {
        if (n < 2) fail("JPEG 2000 PPM marker: too short");
        ppm = true;
        const uint32_t z = p[0];
        if (ppm_markers.size() <= z) {
            ppm_markers.resize(z + 1);
            ppm_seen.resize(z + 1, false);
        }
        if (ppm_seen[z]) fail("JPEG 2000 PPM marker: Zppm " + std::to_string(z) +
                              " read twice");
        ppm_seen[z] = true;
        ppm_markers[z].assign(p + 1, p + n);
    }

    void merge_ppm() {
        if (!ppm) return;
        uint32_t remaining = 0;
        for (size_t i = 0; i < ppm_markers.size(); ++i) {
            if (!ppm_seen[i]) continue;
            const std::vector<uint8_t>& m = ppm_markers[i];
            size_t at = 0;
            while (at < m.size()) {
                if (!remaining) {
                    if (m.size() - at < 4)
                        fail("JPEG 2000 PPM marker: not enough bytes for Nppm");
                    const uint32_t nppm =
                        (static_cast<uint32_t>(m[at]) << 24) |
                        (static_cast<uint32_t>(m[at + 1]) << 16) |
                        (static_cast<uint32_t>(m[at + 2]) << 8) | m[at + 3];
                    at += 4;
                    const size_t take = std::min<size_t>(nppm, m.size() - at);
                    ppm_data.insert(ppm_data.end(), m.begin() + at,
                                    m.begin() + at + take);
                    at += take;
                    remaining = static_cast<uint32_t>(nppm - take);
                } else {
                    const size_t take = std::min<size_t>(remaining, m.size() - at);
                    ppm_data.insert(ppm_data.end(), m.begin() + at,
                                    m.begin() + at + take);
                    at += take;
                    remaining -= static_cast<uint32_t>(take);
                }
            }
        }
        if (remaining) fail("JPEG 2000 PPM markers: corrupted (Nppm runs past "
                            "the last marker)");
    }

    void read_ppt(const uint8_t* p, uint32_t n) {
        if (n < 2) fail("JPEG 2000 PPT marker: too short");
        if (ppm) fail("JPEG 2000 PPT marker after a PPM marker");
        TileCoding& tcp = tile(current_tile);
        tcp.ppt = true;
        const uint32_t z = p[0];
        if (tcp.ppt_markers.size() <= z) {
            tcp.ppt_markers.resize(z + 1);
            tcp.ppt_seen.resize(z + 1, false);
        }
        if (tcp.ppt_seen[z]) fail("JPEG 2000 PPT marker: Zppt " + std::to_string(z) +
                                  " read twice");
        tcp.ppt_seen[z] = true;
        tcp.ppt_markers[z].assign(p + 1, p + n);
    }

    void read_tlm(const uint8_t* p, uint32_t n) {
        if (n < 2) fail("JPEG 2000 TLM marker: too short");
        const uint32_t st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
        if (st == 3) fail("JPEG 2000 TLM marker: ST of 3");
        if ((n - 2) % ((sp + 1) * 2 + st))
            fail("JPEG 2000 TLM marker: its size does not match");
    }

    void read_plt(const uint8_t* p, uint32_t n) {
        if (n < 1) fail("JPEG 2000 PLT marker: too short");
        uint32_t packet = 0;
        for (uint32_t i = 1; i < n; ++i) {
            packet |= p[i] & 0x7F;
            if (p[i] & 0x80) packet <<= 7;
            else packet = 0;
        }
        if (packet) fail("JPEG 2000 PLT marker: a packet length cut short");
    }

    // the handler of a marker and the states it may come in; false for one
    // OpenJPEG does not know
    bool handler(uint32_t m, uint32_t* states) {
        switch (m) {
        case kSOT: *states = kMH | kTPHSOT; return true;
        case kCOD: case kCOC: case kRGN: case kQCD: case kQCC: case kPOC:
        case kCOM: case kMCT: case kMCC: case kMCO:
            *states = kMH | kTPH; return true;
        case kSIZ: *states = kMHSIZ; return true;
        case kTLM: case kPLM: case kPPM: case kCRG: case kCBD: case kCAP:
        case kCPF:
            *states = kMH; return true;
        case kPLT: case kPPT: *states = kTPH; return true;
        case kSOP: *states = 0; return true;
        default: *states = kMH | kTPH; return false;
        }
    }

    void apply(uint32_t m, const uint8_t* p, uint32_t n) {
        switch (m) {
        case kSIZ: read_siz(p, n); break;
        case kCOD: read_cod(p, n); break;
        case kCOC: read_coc(p, n); break;
        case kQCD: read_qcd(p, n); break;
        case kQCC: read_qcc(p, n); break;
        case kRGN: read_rgn(p, n); break;
        case kPOC: read_poc(p, n); break;
        case kPPM: read_ppm(p, n); break;
        case kPPT: read_ppt(p, n); break;
        case kTLM: read_tlm(p, n); break;
        case kPLM:
            if (n < 1) fail("JPEG 2000 PLM marker: too short");
            break;
        case kPLT: read_plt(p, n); break;
        case kCRG:
            if (n != comps.size() * 4)
                fail("JPEG 2000 CRG marker: its size does not match");
            break;
        case kCOM: break;
        case kCAP: case kCPF:
            fail("JPEG 2000 HTJ2K (Part 15) codestream (a " +
                 std::string(m == kCAP ? "CAP" : "CPF") + " marker): "
                 "high-throughput code-blocks are not supported");
        case kMCT: case kMCC: case kMCO: case kCBD:
            fail("JPEG 2000 Part 2 codestream (an " +
                 std::string(m == kMCT ? "MCT" : m == kMCC ? "MCC"
                             : m == kMCO ? "MCO" : "CBD") +
                 " marker): Part 2 extensions are not supported");
        case kSOT: read_sot(p, n); break;
        default: fail("JPEG 2000 marker " + hex4(m) + " has no reader");
        }
    }

    // opj_j2k_read_unk: two bytes at a time to the next known marker
    uint32_t skip_unknown() {
        for (;;) {
            uint32_t m;
            if (!read16(&m)) fail("JPEG 2000: the stream is cut short in an "
                                  "unknown marker segment");
            if (m == kATK || m == kADS)
                fail(std::string("JPEG 2000 Part 2 codestream (an ") +
                     (m == kATK ? "ATK" : "ADS") + " marker): Part 2 "
                     "extensions are not supported");
            if (m >= 0xFF00) {
                uint32_t states;
                const bool known = handler(m, &states);
                if (!(state & states))
                    fail("JPEG 2000 marker " + hex4(m) + " out of place");
                if (known) return m;
            }
        }
    }

    void read_main_header() {
        uint32_t m;
        if (!read16(&m) || m != kSOC) fail("JPEG 2000: no SOC marker");
        state = kMHSIZ;
        if (!read16(&m)) fail("JPEG 2000: the stream is cut short after SOC");
        bool has_siz = false, has_cod = false, has_qcd = false;
        while (m != kSOT) {
            if (m < 0xFF00)
                fail("JPEG 2000: a marker was expected, not " + hex4(m));
            uint32_t states;
            if (m == kATK || m == kADS)
                fail(std::string("JPEG 2000 Part 2 codestream (an ") +
                     (m == kATK ? "ATK" : "ADS") + " marker): Part 2 "
                     "extensions are not supported");
            if (!handler(m, &states)) {
                m = skip_unknown();
                if (m == kSOT) break;
                handler(m, &states);
            }
            has_siz |= m == kSIZ;
            has_cod |= m == kCOD;
            has_qcd |= m == kQCD;
            if (!(state & states))
                fail("JPEG 2000 marker " + hex4(m) + " out of place");
            uint32_t size;
            if (!read16(&size)) fail("JPEG 2000: the main header is cut short");
            if (size < 2) fail("JPEG 2000: a marker segment of size < 2");
            size -= 2;
            if (left() < size) {
                pos = len;
                fail("JPEG 2000: the main header is cut short");
            }
            const uint8_t* p = data + pos;
            pos += size;
            apply(m, p, size);
            if (!read16(&m)) fail("JPEG 2000: the main header is cut short");
        }
        if (!has_siz) fail("JPEG 2000: no SIZ marker in the main header");
        if (!has_cod) fail("JPEG 2000: no COD marker in the main header");
        if (!has_qcd) fail("JPEG 2000: no QCD marker in the main header");
        merge_ppm();
        ntiles = static_cast<size_t>(tw) * th;
        tiles.clear();
        tiles.resize(ntiles);
        state = kTPHSOT;
    }

    // -------------------------------------------------- tile-parts

    void read_sot(const uint8_t* p, uint32_t n) {
        if (n != 8) fail("JPEG 2000 SOT marker: its size does not match");
        const uint32_t tile = (static_cast<uint32_t>(p[0]) << 8) | p[1];
        const uint32_t psot = (static_cast<uint32_t>(p[2]) << 24) |
                              (static_cast<uint32_t>(p[3]) << 16) |
                              (static_cast<uint32_t>(p[4]) << 8) | p[5];
        const uint32_t part = p[6], parts = p[7];
        current_tile = tile;
        if (tile >= ntiles)
            fail("JPEG 2000 SOT marker: tile " + std::to_string(tile) + " of " +
                 std::to_string(ntiles));
        TileCoding& tcp = this->tile(tile);
        if (tcp.part + 1 != static_cast<int>(part))
            fail("JPEG 2000 SOT marker: tile-part " + std::to_string(part) +
                 " of tile " + std::to_string(tile) + " out of order");
        tcp.part = static_cast<int>(part);
        if (psot && psot < 14 && psot != 12)
            fail("JPEG 2000 SOT marker: Psot " + std::to_string(psot));
        if (!psot) last_tile_part = true;
        if (tcp.nb_parts && part >= tcp.nb_parts) {
            last_tile_part = true;
            fail("JPEG 2000 SOT marker: TPsot past the tile's TNsot");
        }
        if (parts) {
            if (part >= parts) {
                last_tile_part = true;
                fail("JPEG 2000 SOT marker: TPsot past its TNsot");
            }
            tcp.nb_parts = parts;
        }
        if (tcp.nb_parts && tcp.nb_parts == part + 1) can_decode = true;
        sot_length = last_tile_part ? 0 : psot - 12;
        state = kTPH;
    }

    void read_sod() {
        if (last_tile_part) {
            sot_length = static_cast<uint32_t>(left() - 2);
        } else {
            sot_length = sot_length >= 2 ? sot_length - 2 : 0;
        }
        TileCoding& tcp = tile(current_tile);
        if (sot_length) {
            if (sot_length > left())
                fail("JPEG 2000: the stream is cut short (tile " +
                     std::to_string(current_tile) + "'s tile-part runs " +
                     std::to_string(sot_length - left()) +
                     " bytes past its end)");
            tcp.data.insert(tcp.data.end(), data + pos, data + pos + sot_length);
            pos += sot_length;
            tcp.has_data = true;
        }
        state = kTPHSOT;
    }

    // opj_j2k_read_tile_header: the next tile to decode, or false when the
    // stream has no more
    bool next_tile() {
        uint32_t m = kSOT;
        if (state == kEOCState) m = kEOC;
        else if (state != kTPHSOT)
            fail("JPEG 2000: the stream does not end with EOC (it is cut "
                 "short)");
        while (!can_decode && m != kEOC) {
            while (m != kSOD) {
                if (left() == 0) {
                    state = kNEOC;
                    break;
                }
                uint32_t size;
                if (!read16(&size)) fail("JPEG 2000: the stream is cut short");
                if (size < 2) fail("JPEG 2000: a marker segment of size < 2");
                if (m == 0x8080 && left() == 0) {
                    state = kNEOC;
                    break;
                }
                if ((state & kTPH) && sot_length) {
                    if (sot_length < size + 2)
                        fail("JPEG 2000: a tile-part header longer than Psot");
                    sot_length -= size + 2;
                }
                size -= 2;
                uint32_t states;
                const bool known = handler(m, &states);
                if (m == kATK || m == kADS)
                    fail(std::string("JPEG 2000 Part 2 codestream (an ") +
                         (m == kATK ? "ATK" : "ADS") + " marker): Part 2 "
                         "extensions are not supported");
                if (!(state & states))
                    fail("JPEG 2000 marker " + hex4(m) + " out of place");
                if (left() < size) {
                    pos = len;
                    fail("JPEG 2000: the stream is cut short in a tile-part "
                         "header");
                }
                const uint8_t* p = data + pos;
                pos += size;
                if (!known)
                    fail("JPEG 2000: an unknown marker " + hex4(m) +
                         " in a tile-part header");
                apply(m, p, size);
                if (!read16(&m)) fail("JPEG 2000: the stream is cut short");
            }
            if (left() == 0 && state == kNEOC) break;
            read_sod();
            if (!can_decode) {
                if (!read16(&m)) {
                    if (current_tile + 1 == ntiles) {
                        size_t t = 0;
                        for (; t < ntiles; ++t)
                            if (tile_part(t) == 0 && tile_parts(t) == 0)
                                break;
                        if (t < ntiles) {
                            current_tile = static_cast<uint32_t>(t);
                            m = kEOC;
                            state = kEOCState;
                            break;
                        }
                    }
                    fail("JPEG 2000: the stream is cut short after a "
                         "tile-part");
                }
            }
        }
        if (m == kEOC && state != kEOCState) {
            current_tile = 0;
            state = kEOCState;
        }
        if (!can_decode) {
            while (current_tile < ntiles && !tile_pending(current_tile))
                ++current_tile;
            if (current_tile == ntiles) return false;
        }
        return true;
    }

    void after_tile() {
        can_decode = false;
        if (left() == 0 && state == kNEOC) return;
        if (state != kEOCState) {
            uint32_t m;
            if (!read16(&m))
                fail("JPEG 2000: the stream is cut short (no EOC)");
            if (m == kEOC) {
                current_tile = 0;
                state = kEOCState;
            } else if (m != kSOT) {
                if (left() == 0) {
                    state = kNEOC;
                    return;
                }
                fail("JPEG 2000: " + hex4(m) + " where a SOT or EOC marker "
                     "was expected");
            }
        }
    }

    void run() {
        while (next_tile()) {
            TileCoding& tcp = tile(current_tile);
            if (!tcp.has_data)
                fail("JPEG 2000: tile " + std::to_string(current_tile) +
                     " has no data");
            if (tcp.ppt) {
                for (size_t i = 0; i < tcp.ppt_markers.size(); ++i)
                    if (tcp.ppt_seen[i])
                        tcp.ppt_data.insert(tcp.ppt_data.end(),
                                            tcp.ppt_markers[i].begin(),
                                            tcp.ppt_markers[i].end());
            }
            decode_tile(current_tile);
            tcp.decoded = true;
            tcp.data.clear();
            tcp.data.shrink_to_fit();
            after_tile();
        }
    }

    // -------------------------------------------------- one tile

    void tile_box(uint32_t t, int32_t* bx0, int32_t* by0, int32_t* bx1,
                  int32_t* by1) const {
        const uint32_t p = t % tw, q = t / tw;
        const uint64_t lx0 = static_cast<uint64_t>(tx0) + p * static_cast<uint64_t>(tdx);
        const uint64_t ly0 = static_cast<uint64_t>(ty0) + q * static_cast<uint64_t>(tdy);
        *bx0 = static_cast<int32_t>(std::max<uint64_t>(lx0, x0));
        *by0 = static_cast<int32_t>(std::max<uint64_t>(ly0, y0));
        *bx1 = static_cast<int32_t>(std::min<uint64_t>(lx0 + tdx, x1));
        *by1 = static_cast<int32_t>(std::min<uint64_t>(ly0 + tdy, y1));
    }

    void init_tile(uint32_t t, const TileCoding& tcp,
                   std::vector<TileComp>& tcs) {
        int32_t bx0, by0, bx1, by1;
        tile_box(t, &bx0, &by0, &bx1, &by1);
        tcs.resize(comps.size());
        for (size_t c = 0; c < comps.size(); ++c) {
            const CompCoding& cc = tcp.comps[c];
            TileComp& tc = tcs[c];
            tc.x0 = int_ceildiv(bx0, comps[c].dx);
            tc.y0 = int_ceildiv(by0, comps[c].dy);
            tc.x1 = int_ceildiv(bx1, comps[c].dx);
            tc.y1 = int_ceildiv(by1, comps[c].dy);
            tc.numres = cc.numres;
            tc.res.assign(cc.numres, Res());
            tc.idata.assign(static_cast<size_t>(tc.w()) * tc.h(), 0);
            for (uint32_t r = 0; r < cc.numres; ++r) {
                Res& res = tc.res[r];
                const int level = static_cast<int>(cc.numres - 1 - r);
                res.x0 = int_ceildivpow2(tc.x0, level);
                res.y0 = int_ceildivpow2(tc.y0, level);
                res.x1 = int_ceildivpow2(tc.x1, level);
                res.y1 = int_ceildivpow2(tc.y1, level);
                res.pdx = cc.prcw[r];
                res.pdy = cc.prch[r];
                const int32_t px0 = int_floordivpow2(res.x0, res.pdx) << res.pdx;
                const int32_t py0 = int_floordivpow2(res.y0, res.pdy) << res.pdy;
                const int32_t px1 = int_ceildivpow2(res.x1, res.pdx) << res.pdx;
                const int32_t py1 = int_ceildivpow2(res.y1, res.pdy) << res.pdy;
                res.pw = res.x0 == res.x1 ? 0u : static_cast<uint32_t>((px1 - px0) >> res.pdx);
                res.ph = res.y0 == res.y1 ? 0u : static_cast<uint32_t>((py1 - py0) >> res.pdy);
                if (static_cast<uint64_t>(res.pw) * res.ph > (1u << 22))
                    fail("JPEG 2000: too many precincts");
                int32_t cbgx0, cbgy0;
                uint32_t cbgw, cbgh;
                if (r == 0) {
                    cbgx0 = px0;
                    cbgy0 = py0;
                    cbgw = res.pdx;
                    cbgh = res.pdy;
                    res.numbands = 1;
                } else {
                    cbgx0 = int_ceildivpow2(px0, 1);
                    cbgy0 = int_ceildivpow2(py0, 1);
                    cbgw = res.pdx - 1;
                    cbgh = res.pdy - 1;
                    res.numbands = 3;
                }
                const uint32_t cbw = std::min(cc.cblkw, cbgw);
                const uint32_t cbh = std::min(cc.cblkh, cbgh);
                for (int b = 0; b < res.numbands; ++b) {
                    Band& band = res.bands[b];
                    if (r == 0) {
                        band.bandno = 0;
                        band.x0 = int_ceildivpow2(tc.x0, level);
                        band.y0 = int_ceildivpow2(tc.y0, level);
                        band.x1 = int_ceildivpow2(tc.x1, level);
                        band.y1 = int_ceildivpow2(tc.y1, level);
                    } else {
                        band.bandno = b + 1;
                        const int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
                        band.x0 = int_ceildivpow2(tc.x0 - (xob << level), level + 1);
                        band.y0 = int_ceildivpow2(tc.y0 - (yob << level), level + 1);
                        band.x1 = int_ceildivpow2(tc.x1 - (xob << level), level + 1);
                        band.y1 = int_ceildivpow2(tc.y1 - (yob << level), level + 1);
                    }
                    const StepSize& ss = cc.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
                    const int log2_gain = cc.qmfbid == 0 ? 0
                        : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
                    const int rb = static_cast<int>(comps[c].prec) + log2_gain;
                    band.stepsize = static_cast<float>(
                        (1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
                    band.numbps = ss.expn + static_cast<int32_t>(cc.numgbits) - 1;
                    band.precs.assign(static_cast<size_t>(res.pw) * res.ph, Precinct());
                    for (uint32_t pn = 0; pn < res.pw * res.ph; ++pn) {
                        Precinct& pr = band.precs[pn];
                        const int32_t gx0 = cbgx0 + static_cast<int32_t>(pn % res.pw) * (1 << cbgw);
                        const int32_t gy0 = cbgy0 + static_cast<int32_t>(pn / res.pw) * (1 << cbgh);
                        pr.x0 = std::max(gx0, band.x0);
                        pr.y0 = std::max(gy0, band.y0);
                        pr.x1 = std::min(gx0 + (1 << cbgw), band.x1);
                        pr.y1 = std::min(gy0 + (1 << cbgh), band.y1);
                        const int32_t bx = int_floordivpow2(pr.x0, cbw) << cbw;
                        const int32_t by = int_floordivpow2(pr.y0, cbh) << cbh;
                        const int32_t ex = int_ceildivpow2(pr.x1, cbw) << cbw;
                        const int32_t ey = int_ceildivpow2(pr.y1, cbh) << cbh;
                        pr.cw = ex > bx ? static_cast<uint32_t>((ex - bx) >> cbw) : 0;
                        pr.ch = ey > by ? static_cast<uint32_t>((ey - by) >> cbh) : 0;
                        if (pr.x0 >= pr.x1 || pr.y0 >= pr.y1) pr.cw = pr.ch = 0;
                        pr.cblks.assign(static_cast<size_t>(pr.cw) * pr.ch, Cblk());
                        for (uint32_t k = 0; k < pr.cw * pr.ch; ++k) {
                            Cblk& cb = pr.cblks[k];
                            const int32_t sx = bx + static_cast<int32_t>(k % pr.cw) * (1 << cbw);
                            const int32_t sy = by + static_cast<int32_t>(k / pr.cw) * (1 << cbh);
                            cb.x0 = std::max(sx, pr.x0);
                            cb.y0 = std::max(sy, pr.y0);
                            cb.x1 = std::min(sx + (1 << cbw), pr.x1);
                            cb.y1 = std::min(sy + (1 << cbh), pr.y1);
                        }
                        pr.incl.build(pr.cw, pr.ch);
                        pr.imsb.build(pr.cw, pr.ch);
                    }
                }
            }
        }
    }

    // the packets of the tile, in order, each once
    struct Packet {
        uint32_t layno, resno, compno, precno;
        int volume;                 // the POC volume that lists it
    };

    // opj_tcd_is_subband_area_of_interest over the whole image: whether a
    // precinct of some band of the packet lies within the band's extent
    // widened by the filter's margin; OpenJPEG skips the other packets (it
    // reads their headers and steps over their bodies)
    bool of_interest(const std::vector<TileComp>& tcs, const TileCoding& tcp,
                     const Packet& pk) const {
        const TileComp& tc = tcs[pk.compno];
        const Comp& comp = comps[pk.compno];
        const uint32_t margin = tcp.comps[pk.compno].qmfbid == 1 ? 2 : 3;
        const uint32_t tcx0 = std::max(static_cast<uint32_t>(tc.x0),
                                       uint_ceildiv(x0, comp.dx));
        const uint32_t tcy0 = std::max(static_cast<uint32_t>(tc.y0),
                                       uint_ceildiv(y0, comp.dy));
        const uint32_t tcx1 = std::min(static_cast<uint32_t>(tc.x1),
                                       uint_ceildiv(x1, comp.dx));
        const uint32_t tcy1 = std::min(static_cast<uint32_t>(tc.y1),
                                       uint_ceildiv(y1, comp.dy));
        const uint32_t nb = pk.resno == 0 ? tc.numres - 1 : tc.numres - pk.resno;
        const Res& res = tc.res[pk.resno];
        for (int b = 0; b < res.numbands; ++b) {
            const Band& band = res.bands[b];
            const uint32_t xob = band.bandno & 1, yob = band.bandno >> 1;
            auto edge = [&](uint32_t v, uint32_t ob) -> uint32_t {
                if (nb == 0) return v;
                const uint32_t off = (1u << (nb - 1)) * ob;
                if (v <= off) return 0;
                return static_cast<uint32_t>(
                    (static_cast<uint64_t>(v - off) + (uint64_t(1) << nb) - 1) >> nb);
            };
            uint32_t tbx0 = edge(tcx0, xob), tby0 = edge(tcy0, yob);
            uint32_t tbx1 = edge(tcx1, xob), tby1 = edge(tcy1, yob);
            tbx0 = tbx0 < margin ? 0 : tbx0 - margin;
            tby0 = tby0 < margin ? 0 : tby0 - margin;
            tbx1 = tbx1 > UINT32_MAX - margin ? UINT32_MAX : tbx1 + margin;
            tby1 = tby1 > UINT32_MAX - margin ? UINT32_MAX : tby1 + margin;
            const Precinct& pr = band.precs[pk.precno];
            if (static_cast<uint32_t>(pr.x0) < tbx1 &&
                static_cast<uint32_t>(pr.y0) < tby1 &&
                static_cast<uint32_t>(pr.x1) > tbx0 &&
                static_cast<uint32_t>(pr.y1) > tby0)
                return true;
        }
        return false;
    }

    void packets(uint32_t t, const TileCoding& tcp,
                 const std::vector<TileComp>& tcs, std::vector<Packet>& out) {
        int32_t bx0, by0, bx1, by1;
        tile_box(t, &bx0, &by0, &bx1, &by1);
        const uint32_t ncomp = static_cast<uint32_t>(comps.size());
        uint32_t max_res = 0, max_prec = 0;
        for (uint32_t c = 0; c < ncomp; ++c) {
            max_res = std::max(max_res, tcs[c].numres);
            for (const Res& r : tcs[c].res) max_prec = std::max(max_prec, r.pw * r.ph);
        }
        const uint64_t step_c = max_prec, step_r = ncomp * step_c,
                       step_l = max_res * step_r;
        const uint64_t include_size = tcp.numlayers * step_l;
        if (include_size > (1ull << 26)) fail("JPEG 2000: too many packets");
        std::vector<uint8_t> include(include_size, 0);
        std::vector<Poc> vols;
        if (tcp.poc) {
            vols = tcp.pocs;
            for (Poc& v : vols) v.layno1 = std::min(v.layno1, tcp.numlayers);
        } else {
            Poc v;
            v.resno0 = 0; v.compno0 = 0; v.resno1 = max_res; v.compno1 = ncomp;
            v.layno1 = tcp.numlayers; v.prg = tcp.prg;
            vols.push_back(v);
        }
        int volume = 0;
        auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) -> bool {
            const uint64_t index = l * step_l + r * step_r + c * step_c + p;
            if (index >= include_size) return false;
            if (!include[index]) {
                include[index] = 1;
                out.push_back(Packet{l, r, c, p, volume});
            }
            return true;
        };
        const uint32_t utx0 = static_cast<uint32_t>(bx0), uty0 = static_cast<uint32_t>(by0);
        const uint32_t utx1 = static_cast<uint32_t>(bx1), uty1 = static_cast<uint32_t>(by1);
        auto min_steps = [&](uint32_t cfrom, uint32_t cto, uint32_t* pdx,
                             uint32_t* pdy) {
            *pdx = 0;
            *pdy = 0;
            for (uint32_t c = cfrom; c < cto; ++c) {
                const TileComp& tc = tcs[c];
                for (uint32_t r = 0; r < tc.numres; ++r) {
                    const Res& res = tc.res[r];
                    const uint32_t ex = res.pdx + tc.numres - 1 - r;
                    const uint32_t ey = res.pdy + tc.numres - 1 - r;
                    if (ex < 32 && comps[c].dx <= UINT32_MAX / (1u << ex)) {
                        const uint32_t d = comps[c].dx * (1u << ex);
                        *pdx = !*pdx ? d : std::min(*pdx, d);
                    }
                    if (ey < 32 && comps[c].dy <= UINT32_MAX / (1u << ey)) {
                        const uint32_t d = comps[c].dy * (1u << ey);
                        *pdy = !*pdy ? d : std::min(*pdy, d);
                    }
                }
            }
        };
        // the precinct of position (x, y) in component c at resolution r, or
        // -1 when the position starts none (opj_pi_next_rpcl's tests)
        auto position = [&](uint32_t c, uint32_t r, uint32_t x, uint32_t y) -> int64_t {
            const TileComp& tc = tcs[c];
            const Res& res = tc.res[r];
            const uint32_t levelno = tc.numres - 1 - r;
            const uint32_t dx = comps[c].dx, dy = comps[c].dy;
            if (levelno >= 32 || ((dx << levelno) >> levelno) != dx ||
                ((dy << levelno) >> levelno) != dy)
                return -1;
            if ((static_cast<uint64_t>(dx) << levelno) > INT32_MAX ||
                (static_cast<uint64_t>(dy) << levelno) > INT32_MAX)
                return -1;
            const uint32_t trx0 = uint_ceildiv(utx0, dx << levelno);
            const uint32_t try0 = uint_ceildiv(uty0, dy << levelno);
            const uint32_t trx1 = uint_ceildiv(utx1, dx << levelno);
            const uint32_t try1 = uint_ceildiv(uty1, dy << levelno);
            const uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
            if (!((static_cast<uint64_t>(y) % (static_cast<uint64_t>(dy) << rpy) == 0) ||
                  (y == uty0 && ((static_cast<uint64_t>(try0) << levelno) %
                                 (1ull << rpy)))))
                return -1;
            if (!((static_cast<uint64_t>(x) % (static_cast<uint64_t>(dx) << rpx) == 0) ||
                  (x == utx0 && ((static_cast<uint64_t>(trx0) << levelno) %
                                 (1ull << rpx)))))
                return -1;
            if (res.pw == 0 || res.ph == 0) return -1;
            if (trx0 == trx1 || try0 == try1) return -1;
            const uint32_t prci = uint_floordivpow2(uint_ceildiv(x, dx << levelno), res.pdx) -
                                  uint_floordivpow2(trx0, res.pdx);
            const uint32_t prcj = uint_floordivpow2(uint_ceildiv(y, dy << levelno), res.pdy) -
                                  uint_floordivpow2(try0, res.pdy);
            return static_cast<int64_t>(prci) + static_cast<int64_t>(prcj) * res.pw;
        };
        for (const Poc& v : vols) {
            ++volume;
            if (v.compno0 >= ncomp || v.compno1 >= ncomp + 1) continue;
            bool ok = true;
            switch (v.prg) {
            case 0:                                     // LRCP
                for (uint32_t l = 0; l < v.layno1 && ok; ++l)
                    for (uint32_t r = v.resno0; r < v.resno1 && ok; ++r)
                        for (uint32_t c = v.compno0; c < v.compno1 && ok; ++c) {
                            if (r >= tcs[c].numres) continue;
                            const Res& res = tcs[c].res[r];
                            for (uint32_t p = 0; p < res.pw * res.ph && ok; ++p)
                                ok = emit(l, r, c, p);
                        }
                break;
            case 1:                                     // RLCP
                for (uint32_t r = v.resno0; r < v.resno1 && ok; ++r)
                    for (uint32_t l = 0; l < v.layno1 && ok; ++l)
                        for (uint32_t c = v.compno0; c < v.compno1 && ok; ++c) {
                            if (r >= tcs[c].numres) continue;
                            const Res& res = tcs[c].res[r];
                            for (uint32_t p = 0; p < res.pw * res.ph && ok; ++p)
                                ok = emit(l, r, c, p);
                        }
                break;
            case 2: case 3: {                           // RPCL, PCRL
                uint32_t sdx, sdy;
                min_steps(0, ncomp, &sdx, &sdy);
                if (!sdx || !sdy) break;
                auto visit = [&](uint32_t r, uint32_t c, uint32_t x, uint32_t y) {
                    const int64_t pn = position(c, r, x, y);
                    if (pn < 0) return;
                    for (uint32_t l = 0; l < v.layno1 && ok; ++l)
                        ok = emit(l, r, c, static_cast<uint32_t>(pn));
                };
                if (v.prg == 2) {
                    for (uint32_t r = v.resno0; r < v.resno1 && ok; ++r)
                        for (uint32_t y = uty0; y < uty1 && ok; y += sdy - (y % sdy))
                            for (uint32_t x = utx0; x < utx1 && ok; x += sdx - (x % sdx))
                                for (uint32_t c = v.compno0; c < v.compno1 && ok; ++c)
                                    if (r < tcs[c].numres) visit(r, c, x, y);
                } else {
                    for (uint32_t y = uty0; y < uty1 && ok; y += sdy - (y % sdy))
                        for (uint32_t x = utx0; x < utx1 && ok; x += sdx - (x % sdx))
                            for (uint32_t c = v.compno0; c < v.compno1 && ok; ++c)
                                for (uint32_t r = v.resno0;
                                     r < std::min(v.resno1, tcs[c].numres) && ok; ++r)
                                    visit(r, c, x, y);
                }
                break;
            }
            case 4: {                                   // CPRL
                for (uint32_t c = v.compno0; c < v.compno1 && ok; ++c) {
                    uint32_t sdx, sdy;
                    min_steps(c, c + 1, &sdx, &sdy);
                    if (!sdx || !sdy) {
                        ok = false;
                        break;
                    }
                    for (uint32_t y = uty0; y < uty1 && ok; y += sdy - (y % sdy))
                        for (uint32_t x = utx0; x < utx1 && ok; x += sdx - (x % sdx))
                            for (uint32_t r = v.resno0;
                                 r < std::min(v.resno1, tcs[c].numres) && ok; ++r) {
                                const int64_t pn = position(c, r, x, y);
                                if (pn < 0) continue;
                                for (uint32_t l = 0; l < v.layno1 && ok; ++l)
                                    ok = emit(l, r, c, static_cast<uint32_t>(pn));
                            }
                }
                break;
            }
            default:                    // a POC's unknown order: no packets
                if (!tcp.poc)
                    fail("JPEG 2000: an unknown progression order " +
                         std::to_string(v.prg));
                break;
            }
        }
    }

    static uint32_t numpasses(Bio& bio) {
        if (!bio.read(1)) return 1;
        if (!bio.read(1)) return 2;
        uint32_t n = bio.read(2);
        if (n != 3) return 3 + n;
        n = bio.read(5);
        if (n != 31) return 6 + n;
        return 37 + bio.read(7);
    }

    static void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
        if (cb.segs.size() <= index) cb.segs.resize(index + 1);
        Seg& s = cb.segs[index];
        s = Seg();
        if (cblksty & kTermAll) s.maxpasses = 1;
        else if (cblksty & kLazy)
            s.maxpasses = first ? 10
                          : (cb.segs[index - 1].maxpasses == 1 ||
                             cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
        else s.maxpasses = 109;
    }

    // one packet: its header (from the tile data, PPT or PPM), then the
    // code-blocks' bytes, kept (store) or skipped over; returns the bytes
    // read from the tile data
    size_t read_packet(TileCoding& tcp, std::vector<TileComp>& tcs,
                       const Packet& pk, const uint8_t* src, size_t max,
                       bool store) {
        const uint8_t* cur = src;
        if (tcp.csty & 2) {                          // SOP
            if (max >= 6 && cur[0] == 0xFF && cur[1] == 0x91) cur += 6;
        }
        const uint8_t* hstart;
        size_t hlen;
        std::vector<uint8_t>* hbuf = nullptr;
        size_t* hpos = nullptr;
        if (ppm) {
            hbuf = &ppm_data;
            hpos = &ppm_pos;
        } else if (tcp.ppt) {
            hbuf = &tcp.ppt_data;
            hpos = &tcp.ppt_pos;
        }
        if (hbuf) {
            hstart = hbuf->data() + *hpos;
            hlen = hbuf->size() - *hpos;
        } else {
            hstart = cur;
            hlen = static_cast<size_t>(src + max - cur);
        }
        const uint8_t* hp = hstart;
        Bio bio(hstart, hlen);
        const CompCoding& cc = tcp.comps[pk.compno];
        Res& res = tcs[pk.compno].res[pk.resno];
        if (pk.precno >= static_cast<uint64_t>(res.pw) * res.ph)
            fail("JPEG 2000: a packet of precinct " + std::to_string(pk.precno) +
                 " of " + std::to_string(res.pw * res.ph));
        const bool present = bio.read(1);
        if (present) {
            for (int b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                Precinct& pr = band.precs[pk.precno];
                for (uint32_t k = 0; k < pr.cw * pr.ch; ++k) {
                    Cblk& cb = pr.cblks[k];
                    uint32_t included;
                    if (!cb.numsegs)
                        included = tgt_decode(bio, pr.incl, k,
                                              static_cast<int32_t>(pk.layno + 1));
                    else
                        included = bio.read(1);
                    if (!included) {
                        cb.numnewpasses = 0;
                        continue;
                    }
                    if (!cb.numsegs) {
                        uint32_t i = 0;
                        while (!tgt_decode(bio, pr.imsb, k, static_cast<int32_t>(i))) ++i;
                        cb.numbps = static_cast<uint32_t>(band.numbps + 1) - i;
                        cb.numlenbits = 3;
                    }
                    cb.numnewpasses = numpasses(bio);
                    uint32_t inc = 0;
                    while (bio.read(1)) ++inc;
                    cb.numlenbits += inc;
                    uint32_t segno = 0;
                    if (!cb.numsegs) {
                        init_seg(cb, 0, cc.cblksty, true);
                    } else {
                        segno = cb.numsegs - 1;
                        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                            ++segno;
                            init_seg(cb, segno, cc.cblksty, false);
                        }
                    }
                    int32_t n = static_cast<int32_t>(cb.numnewpasses);
                    do {
                        Seg& s = cb.segs[segno];
                        s.numnewpasses = static_cast<uint32_t>(std::min<int64_t>(
                            static_cast<int64_t>(s.maxpasses) - s.numpasses, n));
                        uint32_t lg = 0;
                        for (uint32_t v = s.numnewpasses; v > 1; v >>= 1) ++lg;
                        const uint32_t bits = cb.numlenbits + lg;
                        if (bits > 32) fail("JPEG 2000: a packet header with a "
                                            "code-block length of " +
                                            std::to_string(bits) + " bits");
                        s.newlen = bio.read(bits);
                        n -= static_cast<int32_t>(s.numnewpasses);
                        if (n > 0) {
                            ++segno;
                            init_seg(cb, segno, cc.cblksty, false);
                        }
                    } while (n > 0);
                }
            }
        }
        bio.inalign();
        hp += bio.numbytes();
        if (tcp.csty & 4) {                          // EPH
            const size_t used = static_cast<size_t>(hp - hstart);
            if (hlen - used < 2 || hp[0] != 0xFF || hp[1] != 0x92)
                fail("JPEG 2000: a packet header without its EPH marker");
            hp += 2;
        }
        if (hbuf) *hpos += static_cast<size_t>(hp - hstart);
        else cur = hp;
        if (!present) return static_cast<size_t>(cur - src);
        // the bodies
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& pr = band.precs[pk.precno];
            for (uint32_t k = 0; k < pr.cw * pr.ch; ++k) {
                Cblk& cb = pr.cblks[k];
                if (!cb.numnewpasses) continue;
                size_t segno;
                if (!cb.numsegs) {
                    segno = 0;
                    cb.numsegs = 1;
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        ++cb.numsegs;
                    }
                }
                do {
                    Seg& s = cb.segs[segno];
                    if (s.newlen > static_cast<size_t>(src + max - cur))
                        fail("JPEG 2000: the stream is cut short (a code-block "
                             "segment runs " +
                             std::to_string(s.newlen - (src + max - cur)) +
                             " bytes past the tile's data)");
                    if (store) {
                        cb.data.insert(cb.data.end(), cur, cur + s.newlen);
                        s.len += s.newlen;
                    }
                    cur += s.newlen;
                    s.numpasses += s.numnewpasses;
                    cb.numnewpasses -= s.numnewpasses;
                    if (store) s.real_num_passes = s.numpasses;
                    if (cb.numnewpasses > 0) {
                        ++segno;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
            }
        }
        return static_cast<size_t>(cur - src);
    }

    void decode_cblk(T1& t1, Cblk& cb, const Band& band, const CompCoding& cc,
                     TileComp& tc, uint32_t r) {
        const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
        if (w <= 0 || h <= 0) return;
        t1.w = w;
        t1.h = h;
        t1.sw = w + 2;
        t1.data.assign(static_cast<size_t>(w) * h, 0);
        t1.st.assign(static_cast<size_t>(w + 2) * (h + 2), 0);
        t1.orient = band.bandno;
        t1.vsc = cc.cblksty & kVsc;
        if (cb.numsegs) {
            int32_t bpno = static_cast<int32_t>(cc.roishift + cb.numbps);
            if (bpno >= 31)
                fail("JPEG 2000: a code-block of " + std::to_string(bpno) +
                     " bit-planes (OpenJPEG decodes fewer than 31)");
            int passtype = 2;
            t1.mq.reset_states();
            size_t at = 0;
            for (uint32_t s = 0; s < cb.numsegs; ++s) {
                const Seg& seg = cb.segs[s];
                const bool raw = bpno <= static_cast<int32_t>(cb.numbps) - 4 &&
                                 passtype < 2 && (cc.cblksty & kLazy);
                if (raw) t1.mq.init_raw(cb.data.data() + at, seg.len);
                else t1.mq.init_mq(cb.data.data() + at, seg.len);
                at += seg.len;
                for (uint32_t p = 0; p < seg.real_num_passes && bpno >= 1; ++p) {
                    if (passtype == 0) t1.sigpass(bpno, raw);
                    else if (passtype == 1) t1.refpass(bpno, raw);
                    else t1.clnpass(bpno, cc.cblksty & kSegSym);
                    if ((cc.cblksty & kReset) && !raw) t1.mq.reset_states();
                    if (++passtype == 3) {
                        passtype = 0;
                        --bpno;
                    }
                }
            }
        }
        if (cc.roishift) {
            if (cc.roishift >= 31) {
                std::fill(t1.data.begin(), t1.data.end(), 0);
            } else {
                const int32_t thresh = 1 << cc.roishift;
                for (int32_t& v : t1.data) {
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= thresh) {
                        mag >>= cc.roishift;
                        v = v < 0 ? -mag : mag;
                    }
                }
            }
        }
        int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
        if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
        const int32_t stride = tc.w();
        if (cc.qmfbid == 1) {
            for (int j = 0; j < h; ++j)
                for (int i = 0; i < w; ++i)
                    tc.idata[static_cast<size_t>(y + j) * stride + x + i] =
                        t1.data[j * w + i] / 2;
        } else {
            const float step = 0.5f * band.stepsize;
            float* f = tc.fdata();
            for (int j = 0; j < h; ++j)
                for (int i = 0; i < w; ++i)
                    f[static_cast<size_t>(y + j) * stride + x + i] =
                        static_cast<float>(t1.data[j * w + i]) * step;
        }
    }

    void decode_tile(uint32_t t) {
        TileCoding& tcp = tile(t);
        std::vector<TileComp> tcs;
        init_tile(t, tcp, tcs);
        std::vector<Packet> order;
        packets(t, tcp, tcs, order);
        size_t at = 0;
        const size_t total = tcp.data.size();
        std::vector<bool> first_pass_failed;
        int volume = -1;
        for (const Packet& pk : order) {
            if (pk.volume != volume) {              // opj_t2_decode_packets'
                volume = pk.volume;                 // pino loop
                first_pass_failed.assign(comps.size(), true);
            }
            const bool keep = of_interest(tcs, tcp, pk);
            at += read_packet(tcp, tcs, pk, tcp.data.data() + at, total - at,
                              keep);
            if (keep) {
                first_pass_failed[pk.compno] = false;
                resno_decoded[pk.compno] = std::max(resno_decoded[pk.compno],
                                                    pk.resno);
            } else if (first_pass_failed[pk.compno] &&
                       resno_decoded[pk.compno] == 0) {
                resno_decoded[pk.compno] = tcs[pk.compno].numres - 1;
            }
        }
        T1 t1;
        for (size_t c = 0; c < comps.size(); ++c) {
            TileComp& tc = tcs[c];
            const CompCoding& cc = tcp.comps[c];
            for (uint32_t r = 0; r < tc.numres; ++r)
                for (int b = 0; b < tc.res[r].numbands; ++b) {
                    Band& band = tc.res[r].bands[b];
                    for (Precinct& pr : band.precs)
                        for (Cblk& cb : pr.cblks)
                            decode_cblk(t1, cb, band, cc, tc, r);
                }
            const uint32_t levels = std::min(resno_decoded[c] + 1, tc.numres);
            if (cc.qmfbid == 1) idwt(tc, tc.idata.data(), lift53, levels);
            else idwt(tc, tc.fdata(), lift97, levels);
        }
        if (tcp.mct) mct(tcp, tcs);
        DecodedTile dt;
        dt.index = t;
        tile_box(t, &dt.x0, &dt.y0, &dt.x1, &dt.y1);
        for (size_t c = 0; c < comps.size(); ++c) {
            TileComp& tc = tcs[c];
            const Comp& comp = comps[c];
            int32_t lo, hi;
            if (comp.sgnd) {
                lo = -(1 << (comp.prec - 1));
                hi = (1 << (comp.prec - 1)) - 1;
            } else {
                lo = 0;
                hi = static_cast<int32_t>((1u << comp.prec) - 1);
            }
            const int32_t shift = comp.sgnd ? 0 : 1 << (comp.prec - 1);
            const size_t n = tc.idata.size();
            if (tcp.comps[c].qmfbid == 1) {
                for (size_t i = 0; i < n; ++i) {
                    const int32_t v = tc.idata[i] + shift;
                    tc.idata[i] = v < lo ? lo : v > hi ? hi : v;
                }
            } else {
                const float* f = tc.fdata();
                for (size_t i = 0; i < n; ++i) {
                    const float v = f[i];
                    int32_t o;
                    if (v > static_cast<float>(INT32_MAX)) {
                        o = hi;
                    } else if (v < static_cast<float>(INT32_MIN)) {
                        o = lo;
                    } else {
                        const int64_t q = static_cast<int64_t>(std::lrintf(v)) + shift;
                        o = static_cast<int32_t>(q < lo ? lo : q > hi ? hi : q);
                    }
                    tc.idata[i] = o;
                }
            }
            const Res& res = tc.res[std::min(resno_decoded[c], tc.numres - 1)];
            const int32_t rw = res.x1 - res.x0, rh = res.y1 - res.y0;
            std::vector<int32_t> region(static_cast<size_t>(rw) * rh);
            for (int32_t j = 0; j < rh; ++j)
                std::memcpy(region.data() + static_cast<size_t>(j) * rw,
                            tc.idata.data() + static_cast<size_t>(j) * tc.w(),
                            sizeof(int32_t) * rw);
            dt.box.insert(dt.box.end(), {res.x0, res.y0, res.x1, res.y1});
            dt.samples.push_back(std::move(region));
        }
        out.push_back(std::move(dt));
    }

    // -------------------------------------------------- transforms

    static void lift53(int32_t* x, int32_t sn, int32_t dn, int cas) {
        const int32_t len = sn + dn;
        if (len <= 1) {
            if (len == 1 && cas) x[0] /= 2;
            return;
        }
        std::vector<int32_t> o(len);
        // interleave: low band first in x, the low samples at cas + 2i
        for (int32_t i = 0; i < sn; ++i) o[cas + 2 * i] = x[i];
        for (int32_t i = 0; i < dn; ++i) o[1 - cas + 2 * i] = x[sn + i];
        auto at = [&](int32_t i) {
            if (i < 0) i = -i;
            if (i >= len) i = 2 * (len - 1) - i;
            return o[i];
        };
        for (int32_t i = cas; i < len; i += 2)
            o[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
        for (int32_t i = 1 - cas; i < len; i += 2)
            o[i] += (at(i - 1) + at(i + 1)) >> 1;
        std::memcpy(x, o.data(), sizeof(int32_t) * len);
    }

    static void lift97(float* x, int32_t sn, int32_t dn, int cas) {
        const int32_t len = sn + dn;
        if (len <= 1) return;
        std::vector<float> o(len);
        for (int32_t i = 0; i < sn; ++i) o[cas + 2 * i] = x[i];
        for (int32_t i = 0; i < dn; ++i) o[1 - cas + 2 * i] = x[sn + i];
        const float K = 1.230174105f, two_invK = 1.625732422f;
        for (int32_t i = cas; i < len; i += 2) o[i] = o[i] * K;
        for (int32_t i = 1 - cas; i < len; i += 2) o[i] = o[i] * two_invK;
        auto step = [&](int32_t first, float c) {
            for (int32_t i = first; i < len; i += 2) {
                const float l = i - 1 >= 0 ? o[i - 1] : o[i + 1];
                const float r = i + 1 < len ? o[i + 1] : o[i - 1];
                const float t = (l + r) * c;
                o[i] = o[i] + t;
            }
        };
        step(cas, -0.443506852f);
        step(1 - cas, -0.882911075f);
        step(cas, 0.052980118f);
        step(1 - cas, 1.586134342f);
        std::memcpy(x, o.data(), sizeof(float) * len);
    }

    template <typename T, typename Fn>
    static void idwt(TileComp& tc, T* d, Fn lift, uint32_t levels) {
        const int32_t stride = tc.w();
        std::vector<T> col;
        for (uint32_t r = 1; r < levels; ++r) {
            const Res& lo = tc.res[r - 1];
            const Res& hi = tc.res[r];
            const int32_t sw = lo.x1 - lo.x0, shh = lo.y1 - lo.y0;
            const int32_t rw = hi.x1 - hi.x0, rh = hi.y1 - hi.y0;
            const int casx = ((hi.x0 % 2) + 2) % 2, casy = ((hi.y0 % 2) + 2) % 2;
            for (int32_t j = 0; j < rh; ++j)
                lift(d + static_cast<size_t>(j) * stride, sw, rw - sw, casx);
            col.resize(rh);
            for (int32_t i = 0; i < rw; ++i) {
                for (int32_t j = 0; j < rh; ++j) col[j] = d[static_cast<size_t>(j) * stride + i];
                lift(col.data(), shh, rh - shh, casy);
                for (int32_t j = 0; j < rh; ++j) d[static_cast<size_t>(j) * stride + i] = col[j];
            }
        }
    }


    void mct(const TileCoding& tcp, std::vector<TileComp>& tcs) {
        if (comps.size() < 3) return;
        for (int c = 1; c < 3; ++c)
            if (static_cast<int64_t>(tcs[c].w()) * tcs[c].h() !=
                    static_cast<int64_t>(tcs[0].w()) * tcs[0].h() ||
                resno_decoded[c] != resno_decoded[0])
                fail("JPEG 2000: a multiple component transform over "
                     "components of different sizes");
        if (tcp.comps[1].qmfbid != tcp.comps[0].qmfbid ||
            tcp.comps[2].qmfbid != tcp.comps[0].qmfbid)
            fail("JPEG 2000: a multiple component transform over components "
                 "of both wavelets");
        const size_t n = tcs[0].idata.size();
        if (tcp.comps[0].qmfbid == 0) {
            float* c0 = tcs[0].fdata();
            float* c1 = tcs[1].fdata();
            float* c2 = tcs[2].fdata();
            for (size_t i = 0; i < n; ++i) {
                const float y = c0[i], u = c1[i], v = c2[i];
                const float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f);
                g = g - (v * 0.71414f);
                const float b = y + (u * 1.772f);
                c0[i] = r;
                c1[i] = g;
                c2[i] = b;
            }
        } else {
            int32_t* c0 = tcs[0].idata.data();
            int32_t* c1 = tcs[1].idata.data();
            int32_t* c2 = tcs[2].idata.data();
            for (size_t i = 0; i < n; ++i) {
                const int32_t y = c0[i], u = c1[i], v = c2[i];
                const int32_t g = y - ((u + v) >> 2);
                c0[i] = v + g;
                c1[i] = g;
                c2[i] = u + g;
            }
        }
    }
};

int report(const std::string& what, char* err, int errlen) {
    if (errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", what.c_str());
    return -1;
}

}  // namespace

extern "C" {

// Parse the codestream at data[start:n] (n: the whole stream, as OpenJPEG
// is given the file's length) up to its first SOT; *handle receives the
// decoder.
int cge_j2k_open(const unsigned char* data, long n, long start, void** handle,
                 char* err, int errlen) {
    *handle = nullptr;
    Decoder* d = new Decoder();
    try {
        if (start < 0 || start > n) fail("JPEG 2000: no codestream");
        d->data = data;
        d->len = static_cast<size_t>(n);
        d->pos = static_cast<size_t>(start);
        d->read_main_header();
    } catch (const DecodeError& e) {
        delete d;
        return report(e.what, err, errlen);
    } catch (const std::exception& e) {
        delete d;
        return report(std::string("JPEG 2000: ") + e.what(), err, errlen);
    }
    *handle = d;
    return 0;
}

// info: x0, y0, x1, y1, components, tiles across, tiles down, Rsiz
void cge_j2k_info(void* handle, long long* info) {
    const Decoder* d = static_cast<const Decoder*>(handle);
    const long long v[8] = {d->x0, d->y0, d->x1, d->y1,
                            static_cast<long long>(d->comps.size()), d->tw,
                            d->th, d->rsiz};
    std::memcpy(info, v, sizeof v);
}

// component c: precision, signed, dx, dy
void cge_j2k_comp(void* handle, int c, long long* info) {
    const Comp& k = static_cast<const Decoder*>(handle)->comps[c];
    const long long v[4] = {k.prec, k.sgnd, k.dx, k.dy};
    std::memcpy(info, v, sizeof v);
}

// Decode every tile, in the order OpenJPEG hands them to Pillow; the count
// of decoded tiles in *count.
int cge_j2k_decode(void* handle, int* count, char* err, int errlen) {
    Decoder* d = static_cast<Decoder*>(handle);
    try {
        d->run();
    } catch (const DecodeError& e) {
        return report(e.what, err, errlen);
    } catch (const std::exception& e) {
        return report(std::string("JPEG 2000: ") + e.what(), err, errlen);
    }
    *count = static_cast<int>(d->out.size());
    return 0;
}

// Decoded tile k: box receives its index, x0, y0, x1, y1 on the reference
// grid and each component's x0, y0, x1, y1; samples[c] (if not null)
// receives component c's samples, row by row.
void cge_j2k_tile(void* handle, int k, long long* box, int** samples) {
    const DecodedTile& t = static_cast<const Decoder*>(handle)->out[k];
    box[0] = t.index;
    box[1] = t.x0;
    box[2] = t.y0;
    box[3] = t.x1;
    box[4] = t.y1;
    for (size_t i = 0; i < t.box.size(); ++i) box[5 + i] = t.box[i];
    if (!samples) return;
    for (size_t c = 0; c < t.samples.size(); ++c)
        if (samples[c])
            std::memcpy(samples[c], t.samples[c].data(),
                        t.samples[c].size() * sizeof(int32_t));
}

void cge_j2k_free(void* handle) { delete static_cast<Decoder*>(handle); }

// One level of the inverse 5/3 transform of a w x h tile-component whose
// resolution starts at (x0, y0), in place on coef (the low band's sw x sh
// samples top-left, as the decoder lays them out), then, with rct, the
// reversible component transform over three such planes (coef holding
// them one after another).
int cge_j2k_idwt53(int* coef, int w, int h, int x0, int y0, int sw, int sh,
                   int planes, int rct, char* err, int errlen) {
    try {
        if (w < 0 || h < 0 || sw < 0 || sh < 0 || sw > w || sh > h ||
            planes < 1 || (rct && planes != 3))
            fail("JPEG 2000 5/3 transform: inconsistent sizes");
        for (int p = 0; p < planes; ++p) {
            TileComp tc;
            tc.x1 = w;
            tc.y1 = h;
            tc.numres = 2;
            tc.res.resize(2);
            tc.res[0].x0 = int_ceildivpow2(x0, 1);
            tc.res[0].y0 = int_ceildivpow2(y0, 1);
            tc.res[0].x1 = tc.res[0].x0 + sw;
            tc.res[0].y1 = tc.res[0].y0 + sh;
            tc.res[1].x0 = x0;
            tc.res[1].y0 = y0;
            tc.res[1].x1 = x0 + w;
            tc.res[1].y1 = y0 + h;
            Decoder::idwt(tc, coef + static_cast<size_t>(p) * w * h,
                          Decoder::lift53, 2);
        }
        if (rct) {
            const size_t n = static_cast<size_t>(w) * h;
            for (size_t i = 0; i < n; ++i) {
                const int32_t y = coef[i], u = coef[n + i], v = coef[2 * n + i];
                const int32_t g = y - ((u + v) >> 2);
                coef[i] = v + g;
                coef[n + i] = g;
                coef[2 * n + i] = u + g;
            }
        }
    } catch (const DecodeError& e) {
        return report(e.what, err, errlen);
    }
    return 0;
}

}  // extern "C"
