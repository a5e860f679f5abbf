// Zstandard decoding for the port's TIFF reader (scene/tiff.py, TIFF
// compression 50000): frames of RFC 8878, as libtiff's ZSTDDecode streams a
// strip or tile through libzstd's ZSTD_decompressStream for Pillow.
//
//   - the frame header (window descriptor, dictionary id, content size,
//     checksum flag); a frame that names a dictionary is an error, as it is
//     to libzstd without one;
//   - raw, RLE and compressed blocks, each at most min(window, 128 KiB);
//   - literals raw, RLE, Huffman-compressed (a tree of direct or
//     FSE-compressed weights) and treeless (the previous block's tree), in
//     one stream or four;
//   - sequences with each of the literal length, offset and match length
//     codes predefined, RLE, FSE-compressed or repeated from the previous
//     block, the repeat offsets, and matches that overlap their output;
//   - the content checksum is not verified.
//
// libtiff stops as soon as the strip is full, or when the first frame ends
// (libzstd returns 0 there, a skippable frame included), and a strip that
// is not full then is an error: so one frame is decoded, block by block,
// until the output holds out_n bytes; a skippable frame first leaves the
// strip empty, an error. Every check libzstd makes on these structures is
// an error here too (the bit streams must end exactly, the Huffman and FSE
// tables must be complete, an offset must stay inside the frame's output).
//
// Entry point (C ABI, loaded with ctypes): cge_zstd_decode. It returns 0, or
// -1 with a message in err, and reads no byte past n.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct ZstdError {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) {
    throw ZstdError{"ZSTD data corrupt: " + what};
}

int highbit(uint32_t v) {
    int n = 0;
    while (v >>= 1) ++n;
    return n;
}

// a forward bit reader (FSE table descriptions): bits LSB first; bits past
// the end read as 0, and the caller checks how far it read
struct ForwardBits {
    const uint8_t* p;
    size_t n;
    size_t bit = 0;
    uint32_t peek(int k) const {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i) {
            const size_t b = bit + i;
            if (b / 8 < n && (p[b / 8] >> (b % 8) & 1)) v |= 1u << i;
        }
        return v;
    }
    void skip(int k) { bit += k; }
};

// a backward bit stream (Huffman literals, FSE weights and sequences):
// read from its end, the first bit under the last byte's highest set bit;
// bits past its start read as 0 and count as consumed
struct BackBits {
    const uint8_t* p = nullptr;
    size_t n = 0;
    int64_t pos = 0;  // bits not yet consumed, from the start
    void init(const uint8_t* data, size_t size) {
        if (size == 0) fail("an empty bit stream");
        if (data[size - 1] == 0) fail("a bit stream without its end mark");
        p = data;
        n = size;
        pos = static_cast<int64_t>(8 * (size - 1) + highbit(data[size - 1]));
    }
    uint64_t read(int k) {
        uint64_t v = 0;
        for (int i = 0; i < k; ++i) {
            --pos;
            v <<= 1;
            if (pos >= 0 && (p[pos / 8] >> (pos % 8) & 1)) v |= 1;
        }
        return v;
    }
    uint64_t peek(int k) const {
        uint64_t v = 0;
        int64_t q = pos;
        for (int i = 0; i < k; ++i) {
            --q;
            v <<= 1;
            if (q >= 0 && (p[q / 8] >> (q % 8) & 1)) v |= 1;
        }
        return v;
    }
    bool overflowed() const { return pos < 0; }
    bool finished() const { return pos == 0; }
};

struct FseEntry {
    uint16_t symbol;
    uint8_t bits;
    uint16_t base;
};

struct FseTable {
    int log = -1;  // -1: not defined
    std::vector<FseEntry> t;

    // FSE_buildDTable
    void build(const int16_t* norm, int max_symbol, int table_log) {
        const int size = 1 << table_log;
        t.assign(size, FseEntry{0, 0, 0});
        std::vector<uint32_t> next(max_symbol + 1);
        int high = size - 1;
        for (int s = 0; s <= max_symbol; ++s) {
            if (norm[s] == -1) {
                t[high--].symbol = static_cast<uint16_t>(s);
                next[s] = 1;
            } else {
                next[s] = static_cast<uint32_t>(std::max<int16_t>(norm[s], 0));
            }
        }
        const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
        int position = 0;
        for (int s = 0; s <= max_symbol; ++s)
            for (int i = 0; i < norm[s]; ++i) {
                t[position].symbol = static_cast<uint16_t>(s);
                do {
                    position = (position + step) & mask;
                } while (position > high);
            }
        if (position != 0) fail("an FSE table that does not fill");
        for (int u = 0; u < size; ++u) {
            const uint32_t ns = next[t[u].symbol]++;
            const int bits = table_log - highbit(ns);
            t[u].bits = static_cast<uint8_t>(bits);
            t[u].base = static_cast<uint16_t>((ns << bits) - size);
        }
        log = table_log;
    }

    void rle(int symbol) {
        t.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
        log = 0;
    }
};

// FSE_readNCount: a table description from p[0, n) with at most
// max_log accuracy and symbols up to max_symbol; the bytes it took
size_t read_ncount(const uint8_t* p, size_t n, int max_symbol, int max_log,
                   FseTable& table) {
    if (n == 0) fail("an FSE table description is missing");
    ForwardBits b{p, n};
    const int table_log = static_cast<int>(b.peek(4)) + 5;
    b.skip(4);
    if (table_log > max_log) fail("an FSE table log past its limit");
    std::vector<int16_t> norm(max_symbol + 2, 0);
    int remaining = (1 << table_log) + 1;
    int threshold = 1 << table_log;
    int nbits = table_log + 1;
    int symbol = 0;
    bool previous0 = false;
    while (remaining > 1 && symbol <= max_symbol) {
        if (previous0) {
            int n0 = symbol;
            while (b.peek(2) == 3) {
                n0 += 3;
                b.skip(2);
            }
            n0 += static_cast<int>(b.peek(2));
            b.skip(2);
            if (n0 > max_symbol) fail("an FSE table with too many symbols");
            while (symbol < n0) norm[symbol++] = 0;
            if (b.bit > 8 * n + 32) fail("an FSE table description runs on");
        }
        const int max = (2 * threshold - 1) - remaining;
        int count;
        if (static_cast<int>(b.peek(nbits - 1)) < max) {
            count = static_cast<int>(b.peek(nbits - 1));
            b.skip(nbits - 1);
        } else {
            count = static_cast<int>(b.peek(nbits));
            if (count >= threshold) count -= max;
            b.skip(nbits);
        }
        --count;
        remaining -= count < 0 ? -count : count;
        norm[symbol++] = static_cast<int16_t>(count);
        previous0 = count == 0;
        while (remaining < threshold) {
            --nbits;
            threshold >>= 1;
        }
    }
    if (remaining != 1) fail("an FSE table whose counts do not add up");
    if (symbol > max_symbol + 1) fail("an FSE table with too many symbols");
    const size_t used = (b.bit + 7) / 8;
    if (used > n) fail("an FSE table description past its end");
    table.build(norm.data(), symbol - 1, table_log);
    return used;
}

struct Huffman {
    int log = 0;  // 0: none yet
    std::vector<uint8_t> symbol, bits;
};

// HUF_readStats + HUF_readDTableX1: the tree at p; the bytes it took
size_t read_huffman(const uint8_t* p, size_t n, Huffman& h, int64_t* stats) {
    if (n == 0) fail("a Huffman tree description is missing");
    uint8_t w[256] = {0};
    size_t count, used;
    const int head = p[0];
    if (head >= 128) {
        count = static_cast<size_t>(head - 127);
        used = 1 + (count + 1) / 2;
        if (used > n) fail("a Huffman tree description past its end");
        if (count >= 256) fail("a Huffman tree of too many weights");
        for (size_t i = 0; i < count; i += 2) {
            w[i] = p[1 + i / 2] >> 4;
            w[i + 1] = p[1 + i / 2] & 15;
        }
        ++stats[21];
    } else {
        used = 1 + static_cast<size_t>(head);
        if (used > n) fail("a Huffman tree description past its end");
        // FSE_decompress_wksp: two interleaved states over the weights
        FseTable t;
        const size_t hdr = read_ncount(p + 1, head, 255, 6, t);
        BackBits b;
        b.init(p + 1 + hdr, head - hdr);
        uint32_t s1 = static_cast<uint32_t>(b.read(t.log));
        uint32_t s2 = static_cast<uint32_t>(b.read(t.log));
        count = 0;
        const size_t cap = 255;
        auto decode = [&](uint32_t& s) {
            const FseEntry& e = t.t[s];
            w[count++] = static_cast<uint8_t>(e.symbol);
            s = e.base + static_cast<uint32_t>(b.read(e.bits));
        };
        while (true) {
            if (count > cap - 2) fail("a Huffman tree of too many weights");
            decode(s1);
            if (b.overflowed()) {
                w[count++] = static_cast<uint8_t>(t.t[s2].symbol);
                break;
            }
            if (count > cap - 2) fail("a Huffman tree of too many weights");
            decode(s2);
            if (b.overflowed()) {
                w[count++] = static_cast<uint8_t>(t.t[s1].symbol);
                break;
            }
        }
        ++stats[20];
    }
    uint32_t rank[13] = {0};
    uint32_t total = 0;
    for (size_t i = 0; i < count; ++i) {
        if (w[i] > 12) fail("a Huffman weight past 12");
        ++rank[w[i]];
        total += (1u << w[i]) >> 1;
    }
    if (total == 0) fail("a Huffman tree without weights");
    const int log = highbit(total) + 1;
    if (log > 12) fail("a Huffman tree deeper than 12 bits");
    const uint32_t rest = (1u << log) - total;
    if ((1u << highbit(rest)) != rest)
        fail("a Huffman tree that does not complete");
    const int last = highbit(rest) + 1;
    w[count] = static_cast<uint8_t>(last);
    ++rank[last];
    if (rank[1] < 2 || (rank[1] & 1)) fail("a Huffman tree of odd shape");
    const size_t symbols = count + 1;
    h.log = log;
    h.symbol.assign(size_t{1} << log, 0);
    h.bits.assign(size_t{1} << log, 0);
    uint32_t start[14] = {0};
    uint32_t next = 0;
    for (int k = 1; k <= log; ++k) {
        start[k] = next;
        next += rank[k] << (k - 1);
    }
    for (size_t s = 0; s < symbols; ++s) {
        const int wt = w[s];
        if (!wt) continue;
        const uint32_t len = (1u << wt) >> 1;
        for (uint32_t u = start[wt]; u < start[wt] + len; ++u) {
            h.symbol[u] = static_cast<uint8_t>(s);
            h.bits[u] = static_cast<uint8_t>(log + 1 - wt);
        }
        start[wt] += len;
    }
    return used;
}

void huffman_stream(const Huffman& h, const uint8_t* p, size_t n,
                    uint8_t* out, size_t count) {
    BackBits b;
    b.init(p, n);
    for (size_t i = 0; i < count; ++i) {
        const uint32_t v = static_cast<uint32_t>(b.peek(h.log));
        out[i] = h.symbol[v];
        b.read(h.bits[v]);
    }
    if (!b.finished()) fail("a Huffman stream that does not end exactly");
}

// literal length and match length codes: (baseline, extra bits)
const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,   12,   13,   14,    15,    16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,   26,   27,   28,    29,    30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,   47,   51,   59,    67,    83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
// the predefined distributions (RFC 8878 3.1.1.3.2.2)
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

class Frame {
  public:
    Frame(uint8_t* out, size_t out_n, int64_t* stats)
        : out_(out), out_n_(out_n), stats_(stats) {}
    void decode(const uint8_t* p, size_t n);

  private:
    void block(const uint8_t* p, size_t n);
    size_t literals(const uint8_t* p, size_t n);
    size_t table(const uint8_t* p, size_t n, int mode, int which,
                 FseTable& t);
    void emit(const uint8_t* src, size_t len);
    void emit_match(size_t offset, size_t len);

    uint8_t* out_;
    size_t out_n_;
    int64_t* stats_;
    std::vector<uint8_t> frame_;  // the frame's output so far
    size_t block_max_ = 0;
    std::vector<uint8_t> lit_;
    Huffman huf_;
    FseTable ll_, of_, ml_;
    uint64_t rep_[3] = {1, 4, 8};
};

void Frame::emit(const uint8_t* src, size_t len) {
    frame_.insert(frame_.end(), src, src + len);
}

void Frame::emit_match(size_t offset, size_t len) {
    if (offset == 0 || offset > frame_.size())
        fail("a match offset past the frame's start");
    const size_t from = frame_.size() - offset;
    for (size_t i = 0; i < len; ++i) frame_.push_back(frame_[from + i]);
}

size_t Frame::literals(const uint8_t* p, size_t n) {
    if (n == 0) fail("a block without its literals section");
    const int type = p[0] & 3, format = (p[0] >> 2) & 3;
    size_t head, size, csize = 0;
    bool four = false;
    if (type < 2) {
        if (format == 0 || format == 2) {
            head = 1;
            size = p[0] >> 3;
        } else if (format == 1) {
            head = 2;
            if (n < 2) fail("a literals header past the block");
            size = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4);
        } else {
            head = 3;
            if (n < 3) fail("a literals header past the block");
            size = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4) +
                   (static_cast<size_t>(p[2]) << 12);
        }
    } else {
        head = format < 2 ? 3 : format == 2 ? 4 : 5;
        if (n < head) fail("a literals header past the block");
        uint64_t v = 0;
        for (size_t i = 0; i < head; ++i)
            v |= static_cast<uint64_t>(p[i]) << (8 * i);
        const int bits = format < 2 ? 10 : format == 2 ? 14 : 18;
        size = (v >> 4) & ((1u << bits) - 1);
        csize = (v >> (4 + bits)) & ((1u << bits) - 1);
        four = format != 0;
    }
    if (size > block_max_) fail("more literals than a block holds");
    lit_.resize(size);
    if (type == 0) {
        if (head + size > n) fail("raw literals past the block");
        std::memcpy(lit_.data(), p + head, size);
        ++stats_[0];
        return head + size;
    }
    if (type == 1) {
        if (head + 1 > n) fail("RLE literals past the block");
        std::memset(lit_.data(), p[head], size);
        ++stats_[1];
        return head + 1;
    }
    if (head + csize > n) fail("compressed literals past the block");
    if (four && size < 6) fail("fewer than 6 literals in four streams");
    const uint8_t* q = p + head;
    size_t qn = csize;
    if (type == 2) {
        const size_t tree = read_huffman(q, qn, huf_, stats_);
        q += tree;
        qn -= tree;
    } else if (huf_.log == 0) {
        fail("treeless literals without a previous tree");
    }
    stats_[2 + (type - 2) * 2 + (four ? 1 : 0)] += 1;
    if (!four) {
        huffman_stream(huf_, q, qn, lit_.data(), size);
    } else {
        if (qn < 10) fail("four Huffman streams in fewer than 10 bytes");
        size_t len[4];
        for (int i = 0; i < 3; ++i) len[i] = q[2 * i] | (q[2 * i + 1] << 8);
        if (6 + len[0] + len[1] + len[2] > qn)
            fail("Huffman streams past their section");
        len[3] = qn - 6 - len[0] - len[1] - len[2];
        const size_t seg = (size + 3) / 4;
        const uint8_t* s = q + 6;
        for (int i = 0; i < 4; ++i) {
            const size_t count = i < 3 ? seg : size - 3 * seg;
            huffman_stream(huf_, s, len[i], lit_.data() + i * seg, count);
            s += len[i];
        }
    }
    return head + csize;
}

// which: 0 literal lengths, 1 offsets, 2 match lengths
size_t Frame::table(const uint8_t* p, size_t n, int mode, int which,
                    FseTable& t) {
    static const int kMax[3] = {35, 31, 52};
    static const int kLog[3] = {9, 8, 9};
    static const int kDefaultLog[3] = {6, 5, 6};
    static const int16_t* const kNorm[3] = {kLLNorm, kOFNorm, kMLNorm};
    static const int kNormMax[3] = {35, 28, 52};
    stats_[6 + 4 * which + mode] += 1;
    switch (mode) {
        case 0:
            t.build(kNorm[which], kNormMax[which], kDefaultLog[which]);
            return 0;
        case 1:
            if (n < 1) fail("an RLE code past the block");
            if (p[0] > kMax[which]) fail("an RLE code past its table");
            t.rle(p[0]);
            return 1;
        case 2:
            return read_ncount(p, n, kMax[which], kLog[which], t);
        default:
            if (t.log < 0) fail("a repeated table without a previous one");
            return 0;
    }
}

void Frame::block(const uint8_t* p, size_t n) {
    const size_t lit_n = literals(p, n);
    p += lit_n;
    n -= lit_n;
    const size_t start = frame_.size();
    if (n < 1) fail("a block without its sequences section");
    size_t nseq;
    size_t k;
    if (p[0] < 128) {
        nseq = p[0];
        k = 1;
    } else if (p[0] < 255) {
        if (n < 2) fail("a sequences header past the block");
        nseq = (static_cast<size_t>(p[0] - 128) << 8) + p[1];
        k = 2;
    } else {
        if (n < 3) fail("a sequences header past the block");
        nseq = p[1] + (static_cast<size_t>(p[2]) << 8) + 0x7F00;
        k = 3;
    }
    if (nseq == 0) {
        if (k != n) fail("bytes after an empty sequences section");
        ++stats_[18];
        emit(lit_.data(), lit_.size());
        return;
    }
    if (k + 1 > n) fail("a sequences header past the block");
    const int modes = p[k++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    k += table(p + k, n - k, modes >> 6, 0, ll_);
    k += table(p + k, n - k, (modes >> 4) & 3, 1, of_);
    k += table(p + k, n - k, (modes >> 2) & 3, 2, ml_);
    if (k > n) fail("sequence tables past the block");
    BackBits b;
    b.init(p + k, n - k);
    uint32_t sll = static_cast<uint32_t>(b.read(ll_.log));
    uint32_t sof = static_cast<uint32_t>(b.read(of_.log));
    uint32_t sml = static_cast<uint32_t>(b.read(ml_.log));
    size_t lit_pos = 0;
    for (size_t i = 0; i < nseq; ++i) {
        const int ofc = of_.t[sof].symbol;
        const int mlc = ml_.t[sml].symbol;
        const int llc = ll_.t[sll].symbol;
        if (ofc > 31 || mlc > 52 || llc > 35) fail("a code past its table");
        uint64_t ofv = (uint64_t{1} << ofc) + b.read(ofc);
        const size_t ml = kMLBase[mlc] + static_cast<size_t>(b.read(kMLBits[mlc]));
        const size_t ll = kLLBase[llc] + static_cast<size_t>(b.read(kLLBits[llc]));
        uint64_t offset;
        if (ofv > 3) {
            offset = ofv - 3;
            rep_[2] = rep_[1];
            rep_[1] = rep_[0];
            rep_[0] = offset;
        } else {
            int idx = static_cast<int>(ofv) - 1 + (ll == 0 ? 1 : 0);
            if (idx == 0) {
                offset = rep_[0];
            } else {
                offset = idx == 3 ? rep_[0] - 1 : rep_[idx];
                if (idx != 1) rep_[2] = rep_[1];
                rep_[1] = rep_[0];
                rep_[0] = offset;
            }
        }
        if (lit_pos + ll > lit_.size()) fail("a sequence past its literals");
        if (frame_.size() - start + ll + ml > block_max_)
            fail("a block that decodes past its size");
        emit(lit_.data() + lit_pos, ll);
        lit_pos += ll;
        emit_match(static_cast<size_t>(offset), ml);
        if (i + 1 < nseq) {
            sll = ll_.t[sll].base + static_cast<uint32_t>(b.read(ll_.t[sll].bits));
            sml = ml_.t[sml].base + static_cast<uint32_t>(b.read(ml_.t[sml].bits));
            sof = of_.t[sof].base + static_cast<uint32_t>(b.read(of_.t[sof].bits));
        }
    }
    if (!b.finished()) fail("a sequence bit stream that does not end exactly");
    if (frame_.size() - start + lit_.size() - lit_pos > block_max_)
        fail("a block that decodes past its size");
    emit(lit_.data() + lit_pos, lit_.size() - lit_pos);
}

void Frame::decode(const uint8_t* p, size_t n) {
    if (n < 4) fail("ZSTD data ends before the strip is full");
    const uint32_t magic = p[0] | (p[1] << 8) | (p[2] << 16) |
                           (static_cast<uint32_t>(p[3]) << 24);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        ++stats_[19];
        fail("a skippable frame first: ZSTD data ends before the strip is "
             "full");
    }
    if (magic != 0xFD2FB528u) fail("not a ZSTD frame (magic number)");
    size_t pos = 4;
    if (pos >= n) fail("a frame header past the data");
    const int fhd = p[pos++];
    const int fcs_id = fhd >> 6, single = (fhd >> 5) & 1,
              checksum = (fhd >> 2) & 1, dict = fhd & 3;
    (void)checksum;
    if (fhd & 8) fail("a reserved frame header bit set");
    const size_t head = 1 + (single ? 0 : 1) + (dict ? (1 << (dict - 1)) : 0) +
                        (fcs_id ? (1 << fcs_id) : single);
    if (pos + head - 1 > n) fail("a frame header past the data");
    uint64_t window = 0;
    if (!single) {
        const int wd = p[pos++];
        const int wlog = 10 + (wd >> 3);
        const uint64_t base = uint64_t{1} << wlog;
        window = base + (base / 8) * (wd & 7);
    }
    uint32_t dict_id = 0;
    for (int i = 0; dict && i < (1 << (dict - 1)); ++i)
        dict_id |= static_cast<uint32_t>(p[pos++]) << (8 * i);
    if (dict_id) fail("a frame that needs a dictionary");
    uint64_t fcs = 0;
    bool has_fcs = fcs_id || single;
    const int fcs_bytes = fcs_id ? (1 << fcs_id) : single;
    for (int i = 0; i < fcs_bytes; ++i)
        fcs |= static_cast<uint64_t>(p[pos++]) << (8 * i);
    if (fcs_id == 1) fcs += 256;
    if (single) window = fcs;
    if (window > (uint64_t{1} << 27) + 1)
        fail("a window past libzstd's limit");
    block_max_ = static_cast<size_t>(std::min<uint64_t>(window, 128 * 1024));
    while (true) {
        if (pos + 3 > n) fail("ZSTD data ends before the strip is full");
        const uint32_t bh = p[pos] | (p[pos + 1] << 8) | (p[pos + 2] << 16);
        pos += 3;
        const bool last = bh & 1;
        const int type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        if (type == 3) fail("a reserved block type");
        if (size > block_max_) fail("a block past its maximum size");
        const size_t payload = type == 1 ? 1 : size;
        if (pos + payload > n) fail("ZSTD data ends before the strip is full");
        if (type == 0) {
            emit(p + pos, size);
        } else if (type == 1) {
            frame_.insert(frame_.end(), size, p[pos]);
        } else {
            block(p + pos, size);
        }
        ++stats_[22 + type];
        pos += payload;
        if (has_fcs && frame_.size() > fcs)
            fail("a frame that decodes past its content size");
        if (frame_.size() >= out_n_) {
            std::memcpy(out_, frame_.data(), out_n_);
            return;
        }
        if (last) break;
    }
    if (has_fcs && frame_.size() != fcs)
        fail("a frame whose size is not its content size");
    fail("ZSTD data ends before the strip is full (" +
         std::to_string(frame_.size()) + " of " + std::to_string(out_n_) +
         " bytes)");
}

}  // namespace

extern "C" {

// data[0, n): a TIFF strip's or tile's ZSTD frame -> its first out_n bytes
// in out. stats, when not null, receives 25 counts: literals raw, RLE,
// compressed in 1 and 4 streams, treeless in 1 and 4 streams (0-5); the
// literal length, offset and match length tables predefined, RLE, FSE and
// repeated (6-9, 10-13, 14-17); blocks without sequences (18); skippable
// frames (19); Huffman trees of FSE and of direct weights (20, 21); raw,
// RLE and compressed blocks (22-24).
int cge_zstd_decode(const unsigned char* data, long n, unsigned char* out,
                    long out_n, long long* stats, char* err, int errlen) {
    int64_t counts[25] = {0};
    int rc = -1;
    try {
        if (n < 0 || out_n < 0) throw ZstdError{"bad ZSTD geometry"};
        Frame f(out, static_cast<size_t>(out_n), counts);
        f.decode(data, static_cast<size_t>(n));
        rc = 0;
    } catch (const ZstdError& e) {
        if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.what.c_str());
    } catch (const std::exception& e) {
        if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.what());
    }
    if (stats)
        for (int k = 0; k < 25; ++k) stats[k] = counts[k];
    return rc;
}

}  // extern "C"
