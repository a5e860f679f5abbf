// CCITT fax decoding for the port's TIFF reader (scene/tiff.py): the
// compressions 2 (CCITT RLE, Modified Huffman rows, each byte-aligned),
// 3 (Group 3: EOL-framed rows, 1D or, with T4Options bit 0, a tag bit a row
// choosing 1D or 2D) and 4 (Group 4: 2D rows, no EOLs), as libtiff's
// tif_fax3.c decodes them for Pillow.
//
// The decoder follows libtiff's macros (tif_fax3.h) step by step, since
// what a damaged row turns into is theirs: the same lookup tables (the
// 7-bit mode table, the 12-bit white and 13-bit black run tables of
// mkg3states.c, an EOL recognised by 7 or 11 zero bits), the same bit
// accumulator that pads the input's last byte with zeros, the same run
// arrays, which persist from strip to strip, and the same repairs:
//
//   - a code that is no code ends its row ("unexpected"), and the row is
//     cut or padded to its width (CLEANUP_RUNS: runs past the width are
//     dropped, a short row is filled with white);
//   - Group 3 rows each start with a search for the next EOL, skipping
//     whatever lies before it (fill bits and junk alike); a search that
//     runs off the end of a strip puts the decoder in no-EOL mode for the
//     rest of the image (libtiff 4.7's FAXMODE_NOEOL), and the row is
//     decoded again from the strip's first bit, with no search from then
//     on;
//   - data that ends inside a row of compressions 2 and 3 is an error
//     (libtiff's decoder returns -1, and Pillow raises);
//   - a Group 4 strip that ends early (its data, or an EOFB) is not an
//     error in libtiff when a row was decoded, but Pillow's buffer then
//     holds rows that no decoder wrote: that is an error here.
//
// White runs are 0 bits and black runs 1 bits, MSB first, as libtiff's
// _TIFFFax3fillruns writes them; Pillow's raw modes "1" and "1;I" then
// read the bits by the photometric.
//
// Entry point (C ABI, loaded with ctypes): cge_fax_decode decodes the
// chunks (strips or tiles) of one image in order, with one decoder state
// across them, as libtiff keeps it. It returns 0, or -1 with a message in
// err, and reads no byte past each chunk.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <utility>
#include <vector>

namespace {

enum State {
    S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
    S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
    uint8_t state = S_Null, width = 0;
    int32_t param = 0;
};

// T.4 run-length codes, MSB first
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
// the extended make-up codes of both colours, runs 1792 to 2560
const char* const kMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states.c FillTable: every index whose low `width` bits are the code
// read first bit first
void put(TabEnt* t, int size, const char* code, int state, int param) {
    const int width = static_cast<int>(std::strlen(code));
    int v = 0;
    for (int i = 0; i < width; ++i)
        if (code[i] == '1') v |= 1 << i;
    for (int c = v; c < (1 << size); c += 1 << width) {
        t[c].state = static_cast<uint8_t>(state);
        t[c].width = static_cast<uint8_t>(width);
        t[c].param = param;
    }
}

struct Tables {
    TabEnt main[128], white[4096], black[8192];
    Tables() {
        put(main, 7, "0001", S_Pass, 0);
        put(main, 7, "001", S_Horiz, 0);
        put(main, 7, "1", S_V0, 0);
        put(main, 7, "011", S_VR, 1);
        put(main, 7, "000011", S_VR, 2);
        put(main, 7, "0000011", S_VR, 3);
        put(main, 7, "010", S_VL, 1);
        put(main, 7, "000010", S_VL, 2);
        put(main, 7, "0000010", S_VL, 3);
        put(main, 7, "0000001", S_Ext, 0);
        put(main, 7, "0000000", S_EOL, 0);
        for (int i = 0; i < 27; ++i) {
            put(white, 12, kWhiteMakeUp[i], S_MakeUpW, 64 * (i + 1));
            put(black, 13, kBlackMakeUp[i], S_MakeUpB, 64 * (i + 1));
        }
        for (int i = 0; i < 13; ++i) {
            put(white, 12, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
            put(black, 13, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
        }
        for (int i = 0; i < 64; ++i) {
            put(white, 12, kWhiteTerm[i], S_TermW, i);
            put(black, 13, kBlackTerm[i], S_TermB, i);
        }
        put(white, 12, "00000000000", S_EOL, 0);
        put(black, 13, "00000000000", S_EOL, 0);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

const uint8_t kRev[256] = {
#define R2(n) n, n + 2 * 64, n + 1 * 64, n + 3 * 64
#define R4(n) R2(n), R2(n + 2 * 16), R2(n + 1 * 16), R2(n + 3 * 16)
#define R6(n) R4(n), R4(n + 2 * 4), R4(n + 1 * 4), R4(n + 3 * 4)
    R6(0), R6(2), R6(1), R6(3)
#undef R6
#undef R4
#undef R2
};

struct FaxError {
    std::string what;
};

// status of a chunk
enum { kOk = 1, kFailed = -1 };

class FaxDecoder {
  public:
    FaxDecoder(int comp, int options, int width)
        : comp_(comp), two_d_(comp == 4 || (comp == 3 && (options & 1))),
          lastx_(width) {
        nruns_ = ((width + 1 + 31) / 32) * 32;
        if (two_d_) nruns_ *= 2;
        runs_.assign(static_cast<size_t>(nruns_) * 2 + 1, 0);
        curruns_ = runs_.data();
        refruns_ = two_d_ ? runs_.data() + nruns_ : nullptr;
        rowbytes_ = (width + 7) / 8;
    }

    // one strip or tile of `rows` rows into out; kOk or kFailed, with the
    // rows decoded in rows_done
    int chunk(const uint8_t* data, size_t n, int rows, uint8_t* out);

    int rows_done = 0;
    int64_t events[6] = {0, 0, 0, 0, 0, 0};  // see cge_fax_decode

  private:
    int decode_rle(uint8_t* buf, int rows);
    int decode_1d(uint8_t* buf, int rows);
    int decode_2d(uint8_t* buf, int rows);
    int decode_g4(uint8_t* buf, int rows);
    void fill(uint8_t* buf, uint32_t* runs, uint32_t* erun);

    int comp_;
    bool two_d_;
    int lastx_;
    int nruns_;
    size_t rowbytes_;
    std::vector<uint32_t> runs_;
    uint32_t* curruns_;
    uint32_t* refruns_;
    // libtiff's CACHE_STATE
    const uint8_t* cp_ = nullptr;
    const uint8_t* ep_ = nullptr;
    uint32_t BitAcc_ = 0;
    int BitsAvail_ = 0;
    int EOLcnt_ = 0;
    int line_ = 0;
    const uint8_t* start_ = nullptr;
    bool noeol_ = false;  // persists from strip to strip

    void rewind() {
        cp_ = start_;
        BitAcc_ = 0;
        BitsAvail_ = 0;
        noeol_ = true;
    }
};

// tif_fax3.h, with the state in members
#define EndOfData() (cp_ >= ep_)
#define NeedBits8(n, eoflab)                                   \
    do {                                                       \
        if (BitsAvail_ < (n)) {                                \
            if (EndOfData()) {                                 \
                if (BitsAvail_ == 0) goto eoflab;              \
                BitsAvail_ = (n);                              \
            } else {                                           \
                BitAcc_ |= static_cast<uint32_t>(kRev[*cp_++]) \
                           << BitsAvail_;                      \
                BitsAvail_ += 8;                               \
            }                                                  \
        }                                                      \
    } while (0)
#define NeedBits16(n, eoflab)                                      \
    do {                                                           \
        if (BitsAvail_ < (n)) {                                    \
            if (EndOfData()) {                                     \
                if (BitsAvail_ == 0) goto eoflab;                  \
                BitsAvail_ = (n);                                  \
            } else {                                               \
                BitAcc_ |= static_cast<uint32_t>(kRev[*cp_++])     \
                           << BitsAvail_;                          \
                if ((BitsAvail_ += 8) < (n)) {                     \
                    if (EndOfData()) {                             \
                        BitsAvail_ = (n);                          \
                    } else {                                       \
                        BitAcc_ |= static_cast<uint32_t>(          \
                                       kRev[*cp_++])               \
                                   << BitsAvail_;                  \
                        BitsAvail_ += 8;                           \
                    }                                              \
                }                                                  \
            }                                                      \
        }                                                          \
    } while (0)
#define GetBits(n) (BitAcc_ & ((1u << (n)) - 1))
#define ClrBits(n)          \
    do {                    \
        BitsAvail_ -= (n);  \
        BitAcc_ >>= (n);    \
    } while (0)
#define LOOKUP8(wid, tab, eoflab)      \
    do {                               \
        NeedBits8(wid, eoflab);        \
        TabEnt = (tab) + GetBits(wid); \
        ClrBits(TabEnt->width);        \
    } while (0)
#define LOOKUP16(wid, tab, eoflab)     \
    do {                               \
        NeedBits16(wid, eoflab);       \
        TabEnt = (tab) + GetBits(wid); \
        ClrBits(TabEnt->width);        \
    } while (0)
#define unexpected() (++events[0])
#define badlength() (++events[1])

#define SETVALUE(x)                                          \
    do {                                                     \
        if (pa >= thisrun + nruns_) {                        \
            ++events[2];                                     \
            return kFailed;                                  \
        }                                                    \
        *pa++ = static_cast<uint32_t>(RunLength + (x));      \
        a0 += (x);                                           \
        RunLength = 0;                                       \
    } while (0)

#define CLEANUP_RUNS()                                     \
    do {                                                   \
        if (RunLength) SETVALUE(0);                        \
        if (a0 != lastx) {                                 \
            badlength();                                   \
            while (a0 > lastx && pa > thisrun)             \
                a0 -= static_cast<int>(*--pa);             \
            if (a0 < lastx) {                              \
                if (a0 < 0) a0 = 0;                        \
                if ((pa - thisrun) & 1) SETVALUE(0);       \
                SETVALUE(lastx - a0);                      \
            } else if (a0 > lastx) {                       \
                SETVALUE(lastx);                           \
                SETVALUE(0);                               \
            }                                              \
        }                                                  \
    } while (0)

#define SYNC_EOL(eoflab)                      \
    do {                                      \
        if (EOLcnt_ == 0) {                   \
            for (;;) {                        \
                NeedBits16(11, eoflab);       \
                if (GetBits(11) == 0) break;  \
                ClrBits(1);                   \
            }                                 \
        }                                     \
        for (;;) {                            \
            NeedBits8(8, eoflab);             \
            if (GetBits(8)) break;            \
            ClrBits(8);                       \
        }                                     \
        while (GetBits(1) == 0) ClrBits(1);   \
        ClrBits(1);                           \
        EOLcnt_ = 0;                          \
    } while (0)

#define EXPAND1D(eoflab)                                         \
    do {                                                         \
        for (;;) {                                               \
            for (;;) {                                           \
                LOOKUP16(12, T.white, eof1d);                    \
                switch (TabEnt->state) {                         \
                    case S_EOL:                                  \
                        EOLcnt_ = 1;                             \
                        goto done1d;                             \
                    case S_TermW:                                \
                        SETVALUE(TabEnt->param);                 \
                        goto doneWhite1d;                        \
                    case S_MakeUpW:                              \
                    case S_MakeUp:                               \
                        a0 += TabEnt->param;                     \
                        RunLength += TabEnt->param;              \
                        break;                                   \
                    default:                                     \
                        unexpected();                            \
                        goto done1d;                             \
                }                                                \
            }                                                    \
        doneWhite1d:                                             \
            if (a0 >= lastx) goto done1d;                        \
            for (;;) {                                           \
                LOOKUP16(13, T.black, eof1d);                    \
                switch (TabEnt->state) {                         \
                    case S_EOL:                                  \
                        EOLcnt_ = 1;                             \
                        goto done1d;                             \
                    case S_TermB:                                \
                        SETVALUE(TabEnt->param);                 \
                        goto doneBlack1d;                        \
                    case S_MakeUpB:                              \
                    case S_MakeUp:                               \
                        a0 += TabEnt->param;                     \
                        RunLength += TabEnt->param;              \
                        break;                                   \
                    default:                                     \
                        unexpected();                            \
                        goto done1d;                             \
                }                                                \
            }                                                    \
        doneBlack1d:                                             \
            if (a0 >= lastx) goto done1d;                        \
            if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;       \
        }                                                        \
    eof1d:                                                       \
        CLEANUP_RUNS();                                          \
        goto eoflab;                                             \
    done1d:                                                      \
        CLEANUP_RUNS();                                          \
    } while (0)

#define CHECK_b1                                                   \
    do {                                                           \
        if (pa != thisrun)                                         \
            while (b1 <= a0 && b1 < lastx) {                       \
                if (pb + 1 >= refruns_ + nruns_) {                 \
                    ++events[2];                                   \
                    return kFailed;                                \
                }                                                  \
                b1 += static_cast<int>(pb[0] + pb[1]);             \
                pb += 2;                                           \
            }                                                      \
    } while (0)

#define EXPAND2D(eoflab)                                                \
    do {                                                                \
        while (a0 < lastx) {                                            \
            if (pa >= thisrun + nruns_) {                               \
                ++events[2];                                            \
                return kFailed;                                         \
            }                                                           \
            LOOKUP8(7, T.main, eof2d);                                  \
            switch (TabEnt->state) {                                    \
                case S_Pass:                                            \
                    CHECK_b1;                                           \
                    if (pb + 1 >= refruns_ + nruns_) {                  \
                        ++events[2];                                    \
                        return kFailed;                                 \
                    }                                                   \
                    b1 += static_cast<int>(*pb++);                      \
                    RunLength += b1 - a0;                               \
                    a0 = b1;                                            \
                    b1 += static_cast<int>(*pb++);                      \
                    break;                                              \
                case S_Horiz:                                           \
                    if ((pa - thisrun) & 1) {                           \
                        for (;;) {                                      \
                            LOOKUP16(13, T.black, eof2d);               \
                            switch (TabEnt->state) {                    \
                                case S_TermB:                           \
                                    SETVALUE(TabEnt->param);            \
                                    goto doneWhite2da;                  \
                                case S_MakeUpB:                         \
                                case S_MakeUp:                          \
                                    a0 += TabEnt->param;                \
                                    RunLength += TabEnt->param;         \
                                    break;                              \
                                default:                                \
                                    goto badBlack2d;                    \
                            }                                           \
                        }                                               \
                    doneWhite2da:;                                      \
                        for (;;) {                                      \
                            LOOKUP16(12, T.white, eof2d);               \
                            switch (TabEnt->state) {                    \
                                case S_TermW:                           \
                                    SETVALUE(TabEnt->param);            \
                                    goto doneBlack2da;                  \
                                case S_MakeUpW:                         \
                                case S_MakeUp:                          \
                                    a0 += TabEnt->param;                \
                                    RunLength += TabEnt->param;         \
                                    break;                              \
                                default:                                \
                                    goto badWhite2d;                    \
                            }                                           \
                        }                                               \
                    doneBlack2da:;                                      \
                    } else {                                            \
                        for (;;) {                                      \
                            LOOKUP16(12, T.white, eof2d);               \
                            switch (TabEnt->state) {                    \
                                case S_TermW:                           \
                                    SETVALUE(TabEnt->param);            \
                                    goto doneWhite2db;                  \
                                case S_MakeUpW:                         \
                                case S_MakeUp:                          \
                                    a0 += TabEnt->param;                \
                                    RunLength += TabEnt->param;         \
                                    break;                              \
                                default:                                \
                                    goto badWhite2d;                    \
                            }                                           \
                        }                                               \
                    doneWhite2db:;                                      \
                        for (;;) {                                      \
                            LOOKUP16(13, T.black, eof2d);               \
                            switch (TabEnt->state) {                    \
                                case S_TermB:                           \
                                    SETVALUE(TabEnt->param);            \
                                    goto doneBlack2db;                  \
                                case S_MakeUpB:                         \
                                case S_MakeUp:                          \
                                    a0 += TabEnt->param;                \
                                    RunLength += TabEnt->param;         \
                                    break;                              \
                                default:                                \
                                    goto badBlack2d;                    \
                            }                                           \
                        }                                               \
                    doneBlack2db:;                                      \
                    }                                                   \
                    CHECK_b1;                                           \
                    break;                                              \
                case S_V0:                                              \
                    CHECK_b1;                                           \
                    SETVALUE(b1 - a0);                                  \
                    if (pb >= refruns_ + nruns_) {                      \
                        ++events[2];                                    \
                        return kFailed;                                 \
                    }                                                   \
                    b1 += static_cast<int>(*pb++);                      \
                    break;                                              \
                case S_VR:                                              \
                    CHECK_b1;                                           \
                    SETVALUE(b1 - a0 + TabEnt->param);                  \
                    if (pb >= refruns_ + nruns_) {                      \
                        ++events[2];                                    \
                        return kFailed;                                 \
                    }                                                   \
                    b1 += static_cast<int>(*pb++);                      \
                    break;                                              \
                case S_VL:                                              \
                    CHECK_b1;                                           \
                    if (b1 < a0 + TabEnt->param) {                      \
                        unexpected();                                   \
                        goto eol2d;                                     \
                    }                                                   \
                    SETVALUE(b1 - a0 - TabEnt->param);                  \
                    b1 -= static_cast<int>(*--pb);                      \
                    break;                                              \
                case S_Ext:                                             \
                    *pa++ = static_cast<uint32_t>(lastx - a0);          \
                    unexpected();                                       \
                    goto eol2d;                                         \
                case S_EOL:                                             \
                    *pa++ = static_cast<uint32_t>(lastx - a0);          \
                    NeedBits8(4, eof2d);                                \
                    if (GetBits(4)) unexpected();                       \
                    ClrBits(4);                                         \
                    EOLcnt_ = 1;                                        \
                    goto eol2d;                                         \
                default:                                                \
                badMain2d:                                              \
                    unexpected();                                       \
                    goto eol2d;                                         \
                badBlack2d:                                             \
                    unexpected();                                       \
                    goto eol2d;                                         \
                badWhite2d:                                             \
                    unexpected();                                       \
                    goto eol2d;                                         \
                eof2d:                                                  \
                    CLEANUP_RUNS();                                     \
                    goto eoflab;                                        \
            }                                                           \
        }                                                               \
        if (RunLength) {                                                \
            if (RunLength + a0 < lastx) {                               \
                NeedBits8(1, eof2d);                                    \
                if (!GetBits(1)) goto badMain2d;                        \
                ClrBits(1);                                             \
            }                                                           \
            SETVALUE(0);                                                \
        }                                                               \
    eol2d:                                                              \
        CLEANUP_RUNS();                                                 \
    } while (0)

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run
// past the width is cut to it (in the run array too, which the next row
// reads as its reference)
void FaxDecoder::fill(uint8_t* buf, uint32_t* runs, uint32_t* erun) {
    const uint32_t lastx = static_cast<uint32_t>(lastx_);
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        for (int k = 0; k < 2; ++k) {
            uint32_t run = runs[k];
            if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
            if (run) {
                if (k)
                    for (uint32_t i = x; i < x + run; ++i)
                        buf[i >> 3] |= static_cast<uint8_t>(0x80 >> (i & 7));
                else
                    for (uint32_t i = x; i < x + run; ++i)
                        buf[i >> 3] &= static_cast<uint8_t>(~(0x80 >> (i & 7)));
                x += run;
            }
        }
    }
    if (x != lastx) ++events[3];  // bits no run wrote: libtiff leaves them
}

int FaxDecoder::decode_rle(uint8_t* buf, int rows) {
    const Tables& T = tables();
    const TabEnt* TabEnt;
    uint32_t* thisrun = curruns_;
    uint32_t* pa;
    int a0, RunLength;
    const int lastx = lastx_;
    for (int r = 0; r < rows; ++r) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun;
        EXPAND1D(EOFRLE);
        fill(buf, thisrun, pa);
        {   // FAXMODE_BYTEALIGN
            const int n = BitsAvail_ - (BitsAvail_ & ~7);
            ClrBits(n);
        }
        buf += rowbytes_;
        ++line_;
        ++rows_done;
        continue;
    EOFRLE:
        fill(buf, thisrun, pa);
        return kFailed;
    }
    return kOk;
}

int FaxDecoder::decode_1d(uint8_t* buf, int rows) {
    const Tables& T = tables();
    const TabEnt* TabEnt;
    uint32_t* thisrun = curruns_;
    uint32_t* pa;
    int a0, RunLength;
    const int lastx = lastx_;
    for (int r = 0; r < rows; ++r) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun;
        if (!noeol_) SYNC_EOL(NoEOL1D);
    synced1d:
        EXPAND1D(EOF1Da);
        fill(buf, thisrun, pa);
        ++events[4];
        buf += rowbytes_;
        ++line_;
        ++rows_done;
        continue;
    NoEOL1D:
        rewind();
        goto synced1d;
    EOF1Da:
        fill(buf, thisrun, pa);
        return kFailed;
    }
    return kOk;
}

int FaxDecoder::decode_2d(uint8_t* buf, int rows) {
    const Tables& T = tables();
    const TabEnt* TabEnt;
    uint32_t* thisrun;
    uint32_t* pa;
    uint32_t* pb;
    int a0, b1, RunLength;
    const int lastx = lastx_;
    for (int r = 0; r < rows; ++r) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = curruns_;
        if (!noeol_) SYNC_EOL(NoEOL2D);
    synced2d:
        NeedBits8(1, EOF2D);
        {
            const bool is1D = GetBits(1);
            ClrBits(1);
            pb = refruns_;
            b1 = static_cast<int>(*pb++);
            if (is1D) {
                ++events[4];
                EXPAND1D(EOF2Da);
            } else {
                ++events[5];
                EXPAND2D(EOF2Da);
            }
        }
        fill(buf, thisrun, pa);
        if (pa < thisrun + nruns_) SETVALUE(0);
        std::swap(curruns_, refruns_);
        buf += rowbytes_;
        ++line_;
        ++rows_done;
        continue;
    NoEOL2D:
        rewind();
        goto synced2d;
    EOF2D:
        CLEANUP_RUNS();
    EOF2Da:
        fill(buf, thisrun, pa);
        return kFailed;
    }
    return kOk;
}

int FaxDecoder::decode_g4(uint8_t* buf, int rows) {
    const Tables& T = tables();
    const TabEnt* TabEnt;
    uint32_t* thisrun;
    uint32_t* pa;
    uint32_t* pb;
    int a0, b1, RunLength;
    const int lastx = lastx_;
    for (int r = 0; r < rows; ++r) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = curruns_;
        pb = refruns_;
        b1 = static_cast<int>(*pb++);
        ++events[5];
        EXPAND2D(EOFG4);
        if (EOLcnt_) goto EOFG4;
        fill(buf, thisrun, pa);
        SETVALUE(0);
        std::swap(curruns_, refruns_);
        buf += rowbytes_;
        ++line_;
        ++rows_done;
        continue;
    EOFG4:
        NeedBits16(13, BADG4);
    BADG4:
        ClrBits(13);
        fill(buf, thisrun, pa);
        return line_ ? kOk : kFailed;
    }
    return kOk;
}

int FaxDecoder::chunk(const uint8_t* data, size_t n, int rows, uint8_t* out) {
    // Fax3PreDecode
    cp_ = start_ = data;
    ep_ = data + n;
    BitAcc_ = 0;
    BitsAvail_ = 0;
    EOLcnt_ = 0;
    curruns_ = runs_.data();
    if (refruns_) {
        refruns_ = runs_.data() + nruns_;
        refruns_[0] = static_cast<uint32_t>(lastx_);
        refruns_[1] = 0;
    }
    line_ = 0;
    rows_done = 0;
    if (comp_ == 2) return decode_rle(out, rows);
    if (comp_ == 4) return decode_g4(out, rows);
    return two_d_ ? decode_2d(out, rows) : decode_1d(out, rows);
}

#undef EXPAND2D
#undef CHECK_b1
#undef EXPAND1D
#undef SYNC_EOL
#undef CLEANUP_RUNS
#undef SETVALUE
#undef badlength
#undef unexpected
#undef LOOKUP16
#undef LOOKUP8
#undef ClrBits
#undef GetBits
#undef NeedBits16
#undef NeedBits8
#undef EndOfData

}  // namespace

extern "C" {

// Decodes the n_chunks chunks of one image, chunk i the bytes data[starts[i],
// starts[i] + sizes[i]) (FillOrder 2 already reversed), rows[i] rows of
// `width` pixels each, into out: the chunks' rows one after another, each
// ceil(width / 8) bytes. comp is 2, 3 or 4; options the T4Options (bit 0:
// 2D rows). events, when not null, receives 6 counts: codes that are no
// code, rows cut or padded to the width, run-array overflows, rows with
// bits no run wrote, rows coded 1D and rows coded 2D.
int cge_fax_decode(const unsigned char* data, const long* starts,
                   const long* sizes, int n_chunks, int comp, int options,
                   int width, const int* rows, unsigned char* out,
                   long long* events, char* err, int errlen) {
    try {
        if (comp < 2 || comp > 4 || width <= 0 || n_chunks < 0)
            throw FaxError{"bad CCITT fax geometry"};
        FaxDecoder d(comp, options, width);
        const size_t rowbytes = (static_cast<size_t>(width) + 7) / 8;
        unsigned char* o = out;
        int status = kOk;
        for (int i = 0; i < n_chunks && status == kOk; ++i) {
            if (rows[i] < 0 || starts[i] < 0 || sizes[i] < 0)
                throw FaxError{"bad CCITT fax geometry"};
            status = d.chunk(data + starts[i], static_cast<size_t>(sizes[i]),
                             rows[i], o);
            if (status != kOk)
                throw FaxError{"strip or tile " + std::to_string(i) +
                               ": CCITT data ends inside row " +
                               std::to_string(d.rows_done)};
            if (d.rows_done < rows[i])
                throw FaxError{"strip or tile " + std::to_string(i) +
                               ": Group 4 data ends after row " +
                               std::to_string(d.rows_done) + " of " +
                               std::to_string(rows[i]) +
                               " (libtiff leaves the rest unwritten)"};
            if (d.events[2])
                throw FaxError{"strip or tile " + std::to_string(i) +
                               ": CCITT run array overflow"};
            if (d.events[3])
                throw FaxError{"strip or tile " + std::to_string(i) +
                               ": a CCITT row leaves pixels unwritten"};
            o += rowbytes * static_cast<size_t>(rows[i]);
        }
        if (events)
            for (int k = 0; k < 6; ++k) events[k] = d.events[k];
        return 0;
    } catch (const FaxError& e) {
        if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.what.c_str());
    } catch (const std::exception& e) {
        if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.what());
    }
    return -1;
}

}  // extern "C"
