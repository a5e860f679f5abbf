// The JPEG decoder of the port's texture loader (scene/jpeg.py; JPEG in
// TIFF for scene/tiff.py), as libjpeg-turbo 3.1 decodes a file with the
// defaults Pillow 12 runs it with (islow IDCT, fancy upsampling, block
// smoothing, out_color_space RGB, grey or CMYK):
//
//   - sequential and progressive DCT (SOF0, SOF1, SOF2) with Huffman
//     coding, and with arithmetic coding (SOF9, SOF10: T.81 Annex D and
//     sections F.1.4 / G.1.3 as jdarith.c decodes them, the DAC marker's
//     conditioning L, U and Kx, the statistics reset at each scan and
//     restart marker); sequential lossless (SOF3: predictors 1 to 7 and the
//     point transform, jdlossls.c); 8-bit samples, restart intervals;
//   - one, three or four components, each at any sampling h, v of 1 to 4
//     whose ratios to the largest are whole numbers;
//   - dequantisation and the accurate integer IDCT ("islow") in the 16-bit
//     arithmetic of libjpeg-turbo's SIMD code (idct_islow);
//   - block smoothing (jdcoefct.c decompress_smooth_data) of progressive
//     files whose scans leave one of the first nine AC coefficients
//     unrefined (see smoothing_ok and smooth_block);
//   - upsampling as jdsample.c chooses it for each component: the fancy
//     triangle filters h2v1 and h2v2 (components more than 2 samples wide)
//     and h1v2, each with its alternating rounding biases, and replication
//     for every other whole ratio (int_upsample), and for all of them in
//     lossless files, where libjpeg's fancy upsampling is off;
//   - the colour space as jdapimin.c chooses it (three components: JFIF ->
//     YCbCr, Adobe transform 0 -> RGB, any other -> YCbCr, otherwise by the
//     component ids; four: Adobe transform 0 or no Adobe marker -> CMYK,
//     any other -> YCCK) and the fixed-point tables of jdcolor.c: YCbCr ->
//     RGB, YCCK -> CMYK (ycck_cmyk_convert); CMYK is given as libjpeg gives
//     it, and scene/jpeg.py inverts it and converts it to RGB as Pillow
//     does ("CMYK;I", convert("RGB")); grey is replicated to RGB, as
//     Pillow's convert("RGB") does; lossless files convert no colours, as
//     libjpeg refuses a lossy conversion there.
//
// Pillow reads a file in blocks of 64 KB and hands libjpeg each one
// through a suspending source; jdarith.c cannot suspend, so an arithmetic
// scan that needs a byte past the blocks handed over by then fails
// ("broken data stream"), and so does the decoder here (kPillowBlock).
// The Huffman decoders read as jdhuff.c's bit buffer does: 57 bits or
// more a fill (jpeg_fill_bit_buffer), and on a sequential scan's fast path
// (no restart interval, no marker met, 512 bytes a block of the MCU in
// hand) six bytes at 16 bits or fewer; a suspended MCU is decoded again
// once Pillow's next block is there. Where a fill needs a byte past the
// end of the file (no EOI), Pillow reads the file as truncated, and so
// does the decoder here; a file of several scans needs its EOI.
//
// Damaged data goes as in libjpeg, whose warnings Pillow ignores: zeros
// past a marker met inside a scan (a Huffman segment cut short skips its
// MCUs up to the next restart), jdmarker.c's resynchronisation at restart
// markers, a Huffman code of 17 bits taken as 0, a run past the block's
// end on its last coefficient, an arithmetic decoding error skipping the
// rest of its restart interval; a reserved marker is an error.
//
// Headers as jdmarker.c reads them: APPn, COM and DNL segments of length
// below 2 skip nothing, DHT, DQT, DAC, SOF and SOS ones fail; DQT entries
// are 16-bit at any nonzero precision, and a DQT or SOF whose length is
// not that of its tables or components fails; DC and AC tables 0 and 1
// that no DHT before the first scan defined are T.81's standard tables in
// a sequential Huffman file (std_huff_tables); a table whose codes reach
// the all-ones code fails only where a scan uses it.
//
// Anything Pillow or libjpeg refuses raises with the case named: 12- and
// 16-bit samples, two components, hierarchical JPEG (SOF5-7, SOF13-15),
// lossless arithmetic coding (SOF11), fractional sampling ratios, MCUs of
// more than 10 blocks, a height left to a DNL marker, lossless YCbCr or
// YCCK or restarts that are no whole MCU rows.
//
// JPEG in TIFF (scene/tiff.py, compression 7) runs the same decoder, as
// libtiff's tif_jpeg.c drives libjpeg: a tables-only stream (JPEGTables)
// first, then the strip's or tile's abbreviated stream, in the colour space
// the TIFF sets (no conversion, 1 to 4 components; or YCbCr -> RGB),
// whatever its JFIF or Adobe markers say, from one buffer (no 64 KB
// blocks). Old-style JPEG in TIFF (scene/ojpeg.py, compression 6) runs it
// on the stream libtiff's tif_ojpeg.c rebuilds, through that codec's
// source, whose resync_to_restart is an error, and YCbCr as raw data
// (jpeg_read_raw_data: each component's samples as the IDCT gives them).
//
// Entry points (C ABI, loaded with ctypes): cge_jpeg_info parses the
// headers and gives the size and the channels of the output (3: RGB, 4:
// CMYK); cge_jpeg_decode writes [H][W][channels] bytes, row 0 the top;
// cge_jpeg_tiff_info and cge_jpeg_tiff_decode the same for JPEG in TIFF.
// Each returns 0, or -1 with a message in err, and reads no byte past n.

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

// a restart marker out of place under libtiff's old-style JPEG source
struct ResyncFailed {};

// libjpeg suspended by Pillow's source inside an MCU, at the end of the
// bytes handed over so far
struct Suspend {};

// The end of the data where libjpeg takes it as the end of the image: a
// source that supplies an EOI there (libtiff's), or Pillow's once the
// rows of a single-scan file are out (its jpeg_finish_decompress may run
// dry)
struct EndOfImage {};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ... with jpeg_natural_order's 16 extra entries, so that a run that
// damaged data carries past the block's end lands on its last coefficient
int natural(int k) { return k < 64 ? kNatural[k] : 63; }

// The size of the blocks in which Pillow's ImageFile.load reads a file
// (ImageFile.MAXBLOCK) and hands it to libjpeg.
constexpr size_t kPillowBlock = 65536;

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412,
    0x03d80514, 0x01da0617, 0x00e50719, 0x006f081c,
    0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024,
    0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a,
    0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c,
    0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843,
    0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48,
    0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432,
    0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d,
    0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452,
    0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a,
    0x0f6b4d4a, 0x0d514e4b, 0x0bb64f4d, 0x0a40304d,
    0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756,
    0x557059d8, 0x4ca95a5f, 0x44d95b60, 0x3e225c61,
    0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468,
    0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b,
    0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
};

// libjpeg's limit on the blocks (lossless: samples) of an interleaved MCU
// (D_MAX_BLOCKS_IN_MCU)
constexpr int kMaxBlocksInMcu = 10;

// The tables of T.81 Annex K.3 (jstdhuff.c): 16 counts, then the values.
// libjpeg-turbo gives them to DC and AC tables 0 and 1 that no DHT before
// the first scan defined (std_huff_tables, for Motion-JPEG frames).
const uint8_t kStdDc0[] = {
    0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b,
};
const uint8_t kStdDc1[] = {
    0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b,
};
const uint8_t kStdAc0[] = {
    0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04,
    0x00, 0x00, 0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
    0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85,
    0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2,
    0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
};
const uint8_t kStdAc1[] = {
    0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04,
    0x00, 0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
    0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9,
    0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
};

struct Huffman {
    bool defined = false;
    // jdhuff.c jpeg_make_d_derived_tbl: a code of some length reaches the
    // all-ones code; an error only where a scan uses the table
    bool bad = false;
    int count = 0;
    int32_t maxcode[18];  // largest code of each length, -1 if none
    int32_t valoffset[17];
    uint8_t vals[256];

    void build(const uint8_t* counts, const uint8_t* values, int n) {
        std::memcpy(vals, values, n);
        count = n;
        int32_t code = 0;
        int k = 0;
        bad = false;
        for (int len = 1; len <= 16; ++len) {
            valoffset[len] = k - code;
            k += counts[len - 1];
            code += counts[len - 1];
            maxcode[len] = counts[len - 1] ? code - 1 : -1;
            if (code >= (1 << len)) bad = true;
            code <<= 1;
        }
        maxcode[17] = 0x7FFFFFFF;
        defined = true;
    }

    void build_std(const uint8_t* table) {
        int n = 0;
        for (int i = 0; i < 16; ++i) n += table[i];
        build(table, table + 16, n);
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int width = 0, height = 0;          // samples of this component
    int bw = 0, bh = 0;                 // blocks (lossless: samples) stored,
                                        // whole MCUs
    int dc_table = 0, ac_table = 0;
    int pred = 0;                       // the DC (or lossless) predictor
    int dc_context = 0;                 // arithmetic DC conditioning
    bool latched = false;
    uint16_t quant[64];                 // latched at its first scan
    std::vector<int16_t> coef;          // [bh][bw][64], natural order
    std::vector<int32_t> diff;          // lossless: [bh][bw] differences
    std::vector<uint8_t> samples;       // lossless: [height][width]
    int coef_bits[64];                  // the last Al a coefficient got
    int prev_coef_bits[64];             // ... before the component's last
                                        // scan (0 before the file's first)
};

class Decoder {
  public:
    Decoder(const uint8_t* data, size_t n) : data_(data), n_(n) {
        for (int i = 0; i < 16; ++i) {         // jdarith.c's defaults
            dc_l_[i] = 0;
            dc_u_[i] = 1;
            ac_k_[i] = 5;
        }
    }

    void load_tables(const uint8_t* tables, size_t n);
    void parse_headers();
    void decode(uint8_t* out);

    int width = 0, height = 0;
    // the colour space: -1 chosen by the markers, as jdapimin.c does (the
    // output RGB or CMYK); 0 none (JCS_UNKNOWN: each component as it is, 1
    // to 4 of them); 1 YCbCr (-> RGB), whatever the markers say; 2 raw
    // data (jpeg_read_raw_data: each component's samples at its own
    // sampling, neither upsampled nor converted, one plane after another)
    int color = -1;
    int ncomp() const { return static_cast<int>(comps_.size()); }
    // the bytes of an output pixel: 3 (RGB), or 4 (CMYK) for four
    // components under color -1; the components themselves under color 0
    // (and at most that under color 2)
    int channels() const {
        return color == 0 || color == 2 ? ncomp() : (ncomp() == 4 ? 4 : 3);
    }
    // the first component's sampling factors as the frame header gives
    // them, and whether all others are 1x1 (libtiff's checks)
    int h0 = 1, v0 = 1;
    bool rest_1x1 = true;
    // libtiff's old-style JPEG source: its resync_to_restart is an error;
    // under raw data (libtiff's RGBA path, which goes on past a strip that
    // fails) the decoding stops there and the MCU row is given after the
    // planes, otherwise the decoding fails
    bool resync_fails = false;

  private:
    const uint8_t* data_;
    size_t n_;
    size_t pos_ = 0;
    // the end of the bytes Pillow has handed libjpeg so far (kPillowBlock)
    size_t fed_ = kPillowBlock;

    uint16_t quant_[4][64];            // natural order
    bool quant_defined_[4] = {false, false, false, false};
    Huffman dc_[4], ac_[4];
    std::vector<Component> comps_;
    int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
    bool progressive_ = false, arithmetic_ = false, lossless_ = false;
    int restart_interval_ = 0;
    bool jfif_ = false, adobe_ = false;
    int adobe_transform_ = -1;
    bool frame_seen_ = false;
    size_t first_scan_ = 0;            // the offset of the first SOS marker
    int scans_ = 0;                    // SOS markers read
    // jdinput.c has_multiple_scans: the first scan leaves out a component,
    // or the file is progressive; a single-scan file ends at its scan
    bool multiscan_ = false;
    bool end_is_eoi_ = false;
    // jdcoefct.c: the last iMCU row the last scan reached with its data
    // whole (Huffman's insufficient_data), past which smoothing takes
    // each component's coefficient bits from before its last scan
    int last_good_row_ = 0;
    // the MCU row whose restart failed under libtiff's old-style JPEG
    // source (-1: none)
    int resync_row_ = -1;

    // Huffman entropy-coded segment reader: libjpeg's 64-bit bit buffer;
    // fast_: jdhuff.c decode_mcu_fast's reads (an MCU of a sequential scan
    // with 512 bytes a block in hand); retry_: a read past the bytes
    // Pillow has handed over suspends the MCU (Suspend), which is decoded
    // again from its start once the next block is there
    uint64_t bitbuf_ = 0;
    int bitcnt_ = 0;
    bool fast_ = false, retry_ = false;
    int eobrun_ = 0;
    // libjpeg's unread_marker: a marker an entropy decoder ran into, pos_
    // past it (0 none); insufficient_data: the Huffman decoder needed bits
    // past it, and skips the MCUs up to the next restart; the RSTn expected
    // next
    int unread_ = 0;
    bool insufficient_ = false;
    int next_restart_ = 0;

    // arithmetic decoder (jdarith.c): the C and A registers, the bit
    // counter (-1: a decoding error, nothing more until the next restart),
    // whether a marker stopped the input (zeros from there), the
    // statistics bins and the conditioning of each table
    int64_t ar_c_ = 0, ar_a_ = 0;
    int ar_ct_ = -16;
    uint8_t dc_stats_[16][64], ac_stats_[16][256], fixed_bin_ = 113;
    uint8_t dc_l_[16], dc_u_[16], ac_k_[16];

    uint8_t byte() {
        if (pos_ >= n_) {
            if (end_is_eoi_) throw EndOfImage{};
            fail("corrupt JPEG data: premature end of file (a file Pillow "
                 "reads as truncated)");
        }
        // libjpeg's marker reader suspends for Pillow's next block
        while (pos_ >= fed_) fed_ += kPillowBlock;
        return data_[pos_++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    int next_marker();
    void read_segment(int marker);
    void read_sof(int marker, size_t end);
    std::string sampling_text() const;
    void read_dht(size_t end);
    void read_dqt(size_t end);
    void read_dac(size_t end);
    void read_sos(std::vector<Component*>& scomps, int& ss, int& se, int& ah,
                  int& al);
    void decode_scan(const std::vector<Component*>& scomps, int ss, int se,
                     int ah, int al);

    int source_byte();
    void fill(int nbits);
    void fill_fast();
    int bits(int n);
    int bit();
    int huff(const Huffman& t);
    int huff_slow(const Huffman& t, int min_bits);
    static int extend(int v, int s) {
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }
    int entropy_byte();
    int entropy_marker();
    void read_restart_marker();
    void restart(const std::vector<Component*>& scomps, int ss, int ah);

    void block_sequential(Component& c, int16_t* blk);
    void block_dc_first(Component& c, int16_t* blk, int al);
    void block_dc_refine(int16_t* blk, int al);
    void block_ac_first(Component& c, int16_t* blk, int ss, int se, int al);
    void block_ac_refine(Component& c, int16_t* blk, int ss, int se, int al);
    int lossless_diff(Component& c);

    int arith_byte();
    int arith_decode(uint8_t* st);
    void arith_reset(const std::vector<Component*>& scomps, int ss, int ah);
    int arith_magnitude(uint8_t* st, int tbl, bool ac, int k, uint8_t** last);
    bool arith_sequential(Component& c, int16_t* blk);
    bool arith_dc_first(Component& c, int16_t* blk, int al);
    void arith_dc_refine(int16_t* blk, int al);
    bool arith_ac_first(Component& c, int16_t* blk, int ss, int se, int al);
    bool arith_ac_refine(Component& c, int16_t* blk, int ss, int se, int al);

    bool smoothing_ok() const;
    void idct_plane(const Component& c, bool smooth,
                    std::vector<uint8_t>& plane, bool padded = false) const;
    void undifference(Component& c, int psv, int pt,
                      const std::vector<char>& first_rows);
};

// A tables-only stream (TIFF's JPEGTables): SOI, then quantisation and
// Huffman tables (and restart intervals, application data, comments) up to
// EOI, which stay defined for the image stream parsed after it.
void Decoder::load_tables(const uint8_t* tables, size_t n) {
    const uint8_t* data = data_;
    const size_t size = n_;
    data_ = tables;
    n_ = n;
    pos_ = 0;
    if (n < 4 || tables[0] != 0xFF || tables[1] != 0xD8)
        fail("bogus JPEGTables (no SOI marker)");
    pos_ = 2;
    while (true) {
        int m = next_marker();
        if (m == 0xD9) break;
        if ((m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) || m == 0xDA)
            fail("bogus JPEGTables (a frame or scan header in it)");
        read_segment(m);
    }
    data_ = data;
    n_ = size;
    pos_ = 0;
}

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
    if (color != -1) fed_ = SIZE_MAX;       // libtiff hands over one buffer
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
    if (m == 0xD8) fail("corrupt JPEG data: a second SOI marker");
    // jdmarker.c read_markers: the reserved markers are fatal
    if (m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD))
        fail("corrupt JPEG data: unknown JPEG marker 0x" + [m] {
            char b[8];
            std::snprintf(b, sizeof b, "%02X", m);
            return std::string(b);
        }());
    int len = u16();
    if (m == 0xDD && len != 4) fail("corrupt JPEG data: bad DRI length");
    if (len < 2) {
        // jdmarker.c: APPn, COM and DNL skip nothing more; the tables' and
        // headers' readers end at a length that is not 0
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) return;
        fail("corrupt JPEG data: bad marker length");
    }
    if (pos_ + len - 2 > n_) {
        // libjpeg waits for the rest of the segment
        if (end_is_eoi_) throw EndOfImage{};
        fail("corrupt JPEG data: a marker segment runs past the end of the "
             "file (a file Pillow reads as truncated)");
    }
    size_t end = pos_ + len - 2;
    switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
            read_sof(m, end);
            break;
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
            fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
                 ") is not supported (libjpeg refuses it)");
        case 0xCB:
            fail("lossless arithmetic-coded JPEG (SOF11) is not supported "
                 "(libjpeg refuses it)");
        case 0xC8:
            fail("JPEG with a JPG (0xFFC8) frame is not supported (libjpeg "
                 "refuses it)");
        case 0xC4:
            read_dht(end);
            break;
        case 0xCC:
            read_dac(end);
            break;
        case 0xDB:
            read_dqt(end);
            break;
        case 0xDD:
            restart_interval_ = u16();
            break;
        case 0xDC:                             // DNL: ignored
            break;
        case 0xE0:
            // jdmarker.c examine_app0: 14 bytes or more, "JFIF\0"
            if (len >= 16 && std::memcmp(data_ + pos_, "JFIF\0", 5) == 0)
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
    progressive_ = m == 0xC2 || m == 0xCA;
    arithmetic_ = m >= 0xC9;
    lossless_ = m == 0xC3;
    int precision = byte();
    height = u16();
    width = u16();
    int nc = byte();
    if (precision != 8)
        fail(std::to_string(precision) + "-bit JPEG is not supported "
             "(Pillow reads 8-bit samples only)");
    if (height == 0) fail("JPEG with height 0 (set by a DNL marker) is "
                          "not supported");
    if (width == 0) fail("corrupt JPEG data: width 0");
    if (color == 0 || color == 2 ? (nc < 1 || nc > 4)
                                 : (nc != 1 && nc != 3 && nc != 4))
        fail(std::to_string(nc) + "-component JPEG is not supported "
             "(Pillow reads 1, 3 and 4 components)");
    // jdmarker.c get_sof: the length is that of nc components exactly
    if (pos_ + 3 * nc != end) fail("corrupt JPEG data: bad SOF length");
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
    h0 = comps_[0].h;
    v0 = comps_[0].v;
    for (int i = 1; i < nc; ++i)
        rest_1x1 = rest_1x1 && comps_[i].h == 1 && comps_[i].v == 1;
    for (auto& c : comps_) {
        hmax_ = std::max(hmax_, c.h);
        vmax_ = std::max(vmax_, c.v);
    }
    // jdsample.c upsamples by whole ratios only
    for (auto& c : comps_)
        if (hmax_ % c.h || vmax_ % c.v)
            fail(sampling_text() + ": fractional sampling ratios are not "
                 "supported (libjpeg refuses them)");
    const int du = lossless_ ? 1 : 8;          // samples a data unit spans
    mcux_ = (width + du * hmax_ - 1) / (du * hmax_);
    mcuy_ = (height + du * vmax_ - 1) / (du * vmax_);
    for (auto& c : comps_) {
        c.width = (width * c.h + hmax_ - 1) / hmax_;
        c.height = (height * c.v + vmax_ - 1) / vmax_;
        c.bw = mcux_ * c.h;
        c.bh = mcuy_ * c.v;
        for (int& b : c.coef_bits) b = -1;
        for (int& b : c.prev_coef_bits) b = 0;
    }
}

// The frame's sampling for messages: the kind of file, each component's
// factors, and the names of the chroma ratios to the first component
// (4:2:2, 4:4:0, ...), e.g. "four-component (CMYK or YCCK) JPEG sampling
// 2x2,1x1,1x1,2x2 (4:2:0)".
std::string Decoder::sampling_text() const {
    static const char* const kKinds[5] = {
        "", "grey", "two-component", "three-component",
        "four-component (CMYK or YCCK)"};
    std::string s = std::string(kKinds[ncomp()]) + " JPEG sampling ";
    std::string names;
    for (size_t i = 0; i < comps_.size(); ++i) {
        const Component& c = comps_[i];
        s += (i ? "," : "") + std::to_string(c.h) + "x" + std::to_string(c.v);
        const Component& y = comps_[0];
        if (i == 0 || y.h % c.h || y.v % c.v) continue;
        const int he = y.h / c.h, ve = y.v / c.v;
        const char* name = he == 2 && ve == 1 ? "4:2:2"
                         : he == 2 && ve == 2 ? "4:2:0"
                         : he == 1 && ve == 2 ? "4:4:0"
                         : he == 4 && ve == 1 ? "4:1:1"
                         : he == 4 && ve == 2 ? "4:1:0" : nullptr;
        if (name && names.find(name) == std::string::npos)
            names += std::string(names.empty() ? "" : ", ") + name;
    }
    return names.empty() ? s : s + " (" + names + ")";
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

// jdmarker.c get_dqt: 16-bit entries for any nonzero precision, the tables
// read on past the segment's end where its length falls short, which is
// then an error
void Decoder::read_dqt(size_t end) {
    while (pos_ < end) {
        int pq_tq = byte();
        int pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3) fail("corrupt JPEG data: bad DQT table index");
        for (int k = 0; k < 64; ++k)
            quant_[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16()
                                                               : byte());
        quant_defined_[tq] = true;
    }
    if (pos_ != end) fail("corrupt JPEG data: bad DQT length");
}

// jdmarker.c get_dac: (table, value) pairs; tables 0-15 DC (L in the low
// nibble, U in the high one), 16-31 AC (Kx)
void Decoder::read_dac(size_t end) {
    if ((end - pos_) % 2) fail("corrupt JPEG data: bad DAC length");
    while (pos_ < end) {
        int index = byte(), val = byte();
        if (index >= 32) fail("corrupt JPEG data: bad DAC table index");
        if (index >= 16) {
            ac_k_[index - 16] = static_cast<uint8_t>(val);
        } else {
            dc_l_[index] = static_cast<uint8_t>(val & 15);
            dc_u_[index] = static_cast<uint8_t>(val >> 4);
            if (dc_l_[index] > dc_u_[index])
                fail("corrupt JPEG data: bad DAC value");
        }
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
        found->dc_table = tables >> 4;       // checked where a scan uses
        found->ac_table = tables & 15;       // them (decode_scan)
        scomps.push_back(found);
    }
    ss = byte();
    se = byte();
    int a = byte();
    ah = a >> 4;
    al = a & 15;
    pos_ = end;
    if (lossless_) {
        // jdlossls.c: Ss the predictor 1-7, Se and Ah 0, Al below the
        // precision
        if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
            fail("corrupt JPEG data: bad lossless scan parameters");
    } else if (progressive_) {
        // jdphuff.c / jdarith.c start_pass; the warnings there (a band
        // refined out of order) are no errors
        bool bad = (ss == 0 && se != 0) ||
                   (ss > 0 && (ss > se || se > 63 || ns != 1)) ||
                   (ah != 0 && al != ah - 1) || al > 13;
        if (bad) fail("corrupt JPEG data: bad progressive scan parameters");
    }
    // sequential scans with other Ss, Se, Ah or Al only warn (jdhuff.c)
    if (ns > 1) {
        int blocks = 0;
        for (Component* c : scomps) blocks += c->h * c->v;
        if (blocks > kMaxBlocksInMcu)
            fail(sampling_text() + ": a scan of " + std::to_string(blocks) +
                 " blocks an MCU is not supported (libjpeg allows 10)");
    }
}

// A byte of the entropy-coded data for the Huffman bit buffer: -1 at the
// end of the data where libtiff's source supplies an EOI there. Pillow's
// source suspends libjpeg at the end of the bytes handed over so far:
// Pillow reads its next block (Suspend, or on at once where the MCU need
// not be decoded again), and at the end of the file it reads the file as
// truncated.
int Decoder::source_byte() {
    if (pos_ >= n_) {
        if (fed_ == SIZE_MAX) return -1;
        fail("corrupt JPEG data: the data end inside a scan, where libjpeg's "
             "bit buffer reads ahead (a file Pillow reads as truncated)");
    }
    if (pos_ >= fed_) {
        if (retry_) throw Suspend{};
        fed_ += kPillowBlock;
    }
    return data_[pos_++];
}

// jdhuff.c jpeg_fill_bit_buffer: the buffer loaded to 57 bits or more
// (MIN_GET_BITS of a 64-bit buffer), a stuffed 0xFF read as 0xFF; a
// marker (or the end of libtiff's data, an EOI) stops the input, and where
// nbits are wanted past it they are zeros (insufficient_data)
void Decoder::fill(int nbits) {
    if (!unread_) {
        while (bitcnt_ < 57) {
            int c = source_byte();
            if (c == 0xFF) {
                do {
                    c = source_byte();
                } while (c == 0xFF);
                if (c == 0) {
                    c = 0xFF;                     // stuffed 0xFF
                } else {
                    unread_ = c < 0 ? 0xD9 : c;
                    break;
                }
            } else if (c < 0) {
                unread_ = 0xD9;
                break;
            }
            bitbuf_ = (bitbuf_ << 8) | static_cast<uint64_t>(c);
            bitcnt_ += 8;
        }
    }
    if (unread_ && nbits > bitcnt_) {
        insufficient_ = true;
        bitbuf_ <<= 57 - bitcnt_;
        bitcnt_ = 57;
    }
}

// jdhuff.h FILL_BIT_BUFFER_FAST: six bytes at 16 bits or fewer, without a
// check of the end; a marker is backed out and read as a zero byte (the
// MCU is then decoded again the slow way)
void Decoder::fill_fast() {
    if (bitcnt_ > 16) return;
    for (int i = 0; i < 6; ++i) {
        // the fast path runs with 512 bytes a block in hand; past the
        // data's end (damaged data only) zeros are read in place of what
        // lies past libjpeg's buffer
        const int c0 = pos_ < n_ ? data_[pos_] : 0;
        const int c1 = pos_ + 1 < n_ ? data_[pos_ + 1] : 0;
        if (pos_ < n_) ++pos_;
        bitbuf_ = (bitbuf_ << 8) | static_cast<uint64_t>(c0);
        bitcnt_ += 8;
        if (c0 == 0xFF) {
            if (pos_ < n_) ++pos_;
            if (c1 != 0) {
                unread_ = c1;
                pos_ -= 2;
                bitbuf_ &= ~static_cast<uint64_t>(0xFF);
            }
        }
    }
}

int Decoder::bits(int n) {
    if (n == 0) return 0;
    if (fast_)
        fill_fast();
    else if (bitcnt_ < n)
        fill(n);
    bitcnt_ -= n;
    return static_cast<int>((bitbuf_ >> bitcnt_) & ((1u << n) - 1));
}

int Decoder::bit() { return bits(1); }

// jdhuff.h HUFF_DECODE (HUFF_DECODE_FAST under fast_): a code of 8 bits
// or fewer from the next 8 bits, a longer one from 9 bits on, bit by bit
// (jpeg_huff_decode); below 8 bits in the buffer after a fill, bit by bit
// from the first
int Decoder::huff(const Huffman& t) {
    if (fast_) {
        fill_fast();
    } else if (bitcnt_ < 8) {
        fill(0);
        if (bitcnt_ < 8) return huff_slow(t, 1);
    }
    const int look = static_cast<int>((bitbuf_ >> (bitcnt_ - 8)) & 0xFF);
    for (int len = 1; len <= 8; ++len) {
        const int code = look >> (8 - len);
        if (code <= t.maxcode[len]) {
            bitcnt_ -= len;
            return t.vals[(t.valoffset[len] + code) & 0xFF];
        }
    }
    if (!fast_) return huff_slow(t, 9);
    bitcnt_ -= 9;
    int32_t code = static_cast<int32_t>((bitbuf_ >> bitcnt_) & 0x1FF);
    int len = 9;
    while (code > t.maxcode[len]) {
        --bitcnt_;
        code = (code << 1) | static_cast<int32_t>((bitbuf_ >> bitcnt_) & 1);
        ++len;
    }
    // libjpeg warns of a code of 17 bits and takes it as 0
    return len > 16 ? 0 : t.vals[(t.valoffset[len] + code) & 0xFF];
}

// jdhuff.c jpeg_huff_decode: min_bits at once, then bit by bit
int Decoder::huff_slow(const Huffman& t, int min_bits) {
    int32_t code = bits(min_bits);
    int len = min_bits;
    while (code > t.maxcode[len]) {
        code = (code << 1) | bit();
        ++len;
    }
    return len > 16 ? 0 : t.vals[(t.valoffset[len] + code) & 0xFF];
}

// A byte the entropy decoders' marker search reads (jdmarker.c
// next_marker): an arithmetic scan cannot wait for Pillow's next block
// there; the end of the data is an EOI where libtiff supplies the bytes
// and an error where Pillow does (it runs out of file).
int Decoder::entropy_byte() {
    if (pos_ >= n_) {
        if (fed_ == SIZE_MAX) return -1;
        fail("corrupt JPEG data: premature end of file");
    }
    if (pos_ >= fed_) {
        if (arithmetic_)
            fail(std::string("arithmetic-coded JPEG (SOF") +
                 (progressive_ ? "10" : "9") + ") whose scan runs past the 64 "
                 "KB blocks Pillow has read at its start: Pillow refuses it "
                 "(broken data stream)");
        fed_ += kPillowBlock;              // the Huffman decoder suspends
    }
    return data_[pos_++];
}

// jdmarker.c next_marker from the entropy decoder's position: skip to an
// 0xFF, its fill bytes, and a stuffed zero
int Decoder::entropy_marker() {
    for (;;) {
        int c = entropy_byte();
        while (c >= 0 && c != 0xFF) c = entropy_byte();
        if (c < 0) return 0xD9;
        do {
            c = entropy_byte();
        } while (c == 0xFF);
        if (c < 0) return 0xD9;
        if (c != 0) return c;
    }
}

// jdmarker.c read_restart_marker and jpeg_resync_to_restart: the marker
// that ends the interval (read now, or met by the entropy decoder) is
// swallowed when it is the RSTn expected, and otherwise by the resync
// rule: a marker below SOF0 or one of the two RSTn before the expected one
// is skipped for the next marker; any other non-RST marker, or one of
// the next two RSTn, is left unread (the interval after it reads as
// empty); any other RSTn is taken as the expected one.
void Decoder::read_restart_marker() {
    if (!unread_) unread_ = entropy_marker();
    const int want = next_restart_;
    next_restart_ = (next_restart_ + 1) & 7;
    if (unread_ == 0xD0 + want) {
        unread_ = 0;
        return;
    }
    if (resync_fails) throw ResyncFailed{};
    for (;;) {
        const int m = unread_;
        int action;
        if (m < 0xC0)
            action = 2;
        else if (m < 0xD0 || m > 0xD7)
            action = 3;
        else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7))
            action = 3;
        else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7))
            action = 2;
        else
            action = 1;
        if (action == 1) {
            unread_ = 0;
            return;
        }
        if (action == 3) return;
        unread_ = entropy_marker();
    }
}

// jdhuff.c / jdphuff.c / jdarith.c process_restart
void Decoder::restart(const std::vector<Component*>& scomps, int ss,
                      int ah) {
    bitcnt_ = 0;
    bitbuf_ = 0;
    read_restart_marker();
    eobrun_ = 0;
    for (Component* c : scomps) c->pred = 0;
    if (arithmetic_)
        arith_reset(scomps, ss, ah);
    else if (!unread_)
        insufficient_ = false;
}

void Decoder::block_sequential(Component& c, int16_t* blk) {
    int s = huff(dc_[c.dc_table]);
    int diff = s ? extend(bits(s), s) : 0;
    c.pred = static_cast<int>(static_cast<uint32_t>(c.pred) + diff);
    blk[0] = static_cast<int16_t>(c.pred);
    const Huffman& t = ac_[c.ac_table];
    for (int k = 1; k < 64; ++k) {
        int rs = huff(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[natural(k)] = static_cast<int16_t>(extend(bits(s), s));
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

void Decoder::block_dc_first(Component& c, int16_t* blk, int al) {
    int s = huff(dc_[c.dc_table]);
    int diff = s ? extend(bits(s), s) : 0;
    c.pred = static_cast<int>(static_cast<uint32_t>(c.pred) + diff);
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
            int v = extend(bits(s), s);
            blk[natural(k)] = static_cast<int16_t>(
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
            if (s) {                 // libjpeg warns where s is not 1
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
            if (s) blk[natural(k)] = static_cast<int16_t>(s);
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

// jdlhuff.c: a sample difference of category s (16: 32768, no bits)
int Decoder::lossless_diff(Component& c) {
    int s = huff(dc_[c.dc_table]);
    if (s == 0) return 0;
    if (s == 16) return 32768;
    if (s > 16) fail("corrupt JPEG data: bad lossless difference");
    return extend(bits(s), s);
}

// jdarith.c get_byte and the data input of arith_decode: a stuffed 0xFF
// is 0xFF; a marker (or the end of the data) stops the input, and zeros
// follow
int Decoder::arith_byte() {
    if (unread_) return 0;
    int data = entropy_byte();
    if (data == 0xFF) {
        do {
            data = entropy_byte();
        } while (data == 0xFF);
        if (data == 0) return 0xFF;
        unread_ = data < 0 ? 0xD9 : data;
        return 0;
    }
    if (data < 0) {
        unread_ = 0xD9;
        return 0;
    }
    return data;
}

// jdarith.c arith_decode: one binary decision with the statistics bin st
int Decoder::arith_decode(uint8_t* st) {
    while (ar_a_ < 0x8000) {
        if (--ar_ct_ < 0) {
            ar_c_ = (ar_c_ << 8) | arith_byte();
            if ((ar_ct_ += 8) < 0)              // the initial bytes
                if (++ar_ct_ == 0) ar_a_ = 0x8000;
        }
        ar_a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = ar_a_ - qe;
    ar_a_ = temp;
    temp <<= ar_ct_;
    if (ar_c_ >= temp) {
        ar_c_ -= temp;
        if (ar_a_ < qe) {                        // MPS after the exchange
            ar_a_ = qe;
            *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
        } else {                                 // LPS
            ar_a_ = qe;
            *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (ar_a_ < 0x8000) {
        if (ar_a_ < qe) {                        // LPS after the exchange
            *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {                                 // MPS
            *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

// jdarith.c start_pass / process_restart: the statistics of the scan's
// tables cleared, the predictions and the registers reset
void Decoder::arith_reset(const std::vector<Component*>& scomps, int ss,
                          int ah) {
    for (Component* c : scomps) {
        if (!progressive_ || (ss == 0 && ah == 0)) {
            std::memset(dc_stats_[c->dc_table], 0, 64);
            c->pred = 0;
            c->dc_context = 0;
        }
        if (!progressive_ || ss)
            std::memset(ac_stats_[c->ac_table], 0, 256);
    }
    ar_c_ = 0;
    ar_a_ = 0;
    ar_ct_ = -16;
}

// Figures F.23 and F.24: the magnitude category of a nonzero value from
// the bin st on, then its bits; v - 1 as jdarith.c builds it. -1 on a
// magnitude overflow.
int Decoder::arith_magnitude(uint8_t* st, int tbl, bool ac, int k,
                             uint8_t** last) {
    int m = arith_decode(st);
    if (m != 0) {
        if (ac) {
            if (arith_decode(st)) {
                m <<= 1;
                st = ac_stats_[tbl] + (k <= ac_k_[tbl] ? 189 : 217);
                while (arith_decode(st)) {
                    if ((m <<= 1) == 0x8000) return -1;
                    st += 1;
                }
            }
        } else {
            st = dc_stats_[tbl] + 20;
            while (arith_decode(st)) {
                if ((m <<= 1) == 0x8000) return -1;
                st += 1;
            }
        }
    }
    *last = st;
    return m;
}

// jdarith.c decode_mcu for one block; false on a decoding error (the rest
// of the MCU and of the restart interval is skipped)
bool Decoder::arith_sequential(Component& c, int16_t* blk) {
    if (!arith_dc_first(c, blk, 0)) return false;
    const int tbl = c.ac_table;
    for (int k = 1; k <= 63; ++k) {
        uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
        if (arith_decode(st)) break;             // EOB
        while (arith_decode(st + 1) == 0) {
            st += 3;
            if (++k > 63) return false;          // spectral overflow
        }
        const int sign = arith_decode(&fixed_bin_);
        uint8_t* mst = nullptr;
        int m = arith_magnitude(st + 2, tbl, true, k, &mst);
        if (m < 0) return false;
        int v = m;
        mst += 14;
        while (m >>= 1)
            if (arith_decode(mst)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] = static_cast<int16_t>(v);
    }
    return true;
}

// Sections F.1.4.4.1 / G.1.3.1: the DC difference, with its conditioning
bool Decoder::arith_dc_first(Component& c, int16_t* blk, int al) {
    const int tbl = c.dc_table;
    uint8_t* st = dc_stats_[tbl] + c.dc_context;
    if (arith_decode(st) == 0) {
        c.dc_context = 0;
    } else {
        const int sign = arith_decode(st + 1);
        st += 2 + sign;
        uint8_t* mst = nullptr;
        int m = arith_magnitude(st, tbl, false, 0, &mst);
        if (m < 0) return false;                 // magnitude overflow
        if (m < static_cast<int>((1L << dc_l_[tbl]) >> 1))
            c.dc_context = 0;
        else if (m > static_cast<int>((1L << dc_u_[tbl]) >> 1))
            c.dc_context = 12 + sign * 4;
        else
            c.dc_context = 4 + sign * 4;
        int v = m;
        mst += 14;
        while (m >>= 1)
            if (arith_decode(mst)) v |= m;
        v += 1;
        if (sign) v = -v;
        c.pred = (c.pred + v) & 0xFFFF;
    }
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
    return true;
}

void Decoder::arith_dc_refine(int16_t* blk, int al) {
    if (arith_decode(&fixed_bin_))
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
}

bool Decoder::arith_ac_first(Component& c, int16_t* blk, int ss, int se,
                             int al) {
    const int tbl = c.ac_table;
    for (int k = ss; k <= se; ++k) {
        uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
        if (arith_decode(st)) break;             // EOB
        while (arith_decode(st + 1) == 0) {
            st += 3;
            if (++k > se) return false;          // spectral overflow
        }
        const int sign = arith_decode(&fixed_bin_);
        uint8_t* mst = nullptr;
        int m = arith_magnitude(st + 2, tbl, true, k, &mst);
        if (m < 0) return false;
        int v = m;
        mst += 14;
        while (m >>= 1)
            if (arith_decode(mst)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v)
                                                << al);
    }
    return true;
}

// jdarith.c decode_mcu_AC_refine
bool Decoder::arith_ac_refine(Component& c, int16_t* blk, int ss, int se,
                              int al) {
    const int tbl = c.ac_table;
    const int p1 = 1 << al;
    const int m1 = static_cast<int>(static_cast<uint32_t>(-1) << al);
    int kex = se;                 // the previous stage's end of block
    for (; kex > 0; --kex)
        if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
        uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
        if (k > kex && arith_decode(st)) break;  // EOB
        for (;;) {
            int16_t* coef = blk + kNatural[k];
            if (*coef) {                         // previously nonzero
                if (arith_decode(st + 2))
                    *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1
                                                           : *coef + p1);
                break;
            }
            if (arith_decode(st + 1)) {          // newly nonzero
                *coef = static_cast<int16_t>(arith_decode(&fixed_bin_) ? m1
                                                                       : p1);
                break;
            }
            st += 3;
            if (++k > se) return false;          // spectral overflow
        }
    }
    return true;
}

void Decoder::decode_scan(const std::vector<Component*>& scomps, int ss,
                          int se, int ah, int al) {
    bitbuf_ = 0;
    bitcnt_ = 0;
    unread_ = 0;
    insufficient_ = false;
    next_restart_ = 0;
    eobrun_ = 0;
    for (auto& c : comps_) c.pred = 0;
    // jdinput.c start_input_pass: the quantisation tables latched, then
    // the entropy decoder's start_pass
    for (Component* c : scomps) {
        if (!lossless_ && !c->latched) {
            if (!quant_defined_[c->tq])
                fail("corrupt JPEG data: a component's quantisation table "
                     "is undefined");
            std::memcpy(c->quant, quant_[c->tq], sizeof c->quant);
            c->latched = true;
        }
    }
    for (Component* c : scomps) {
        if (progressive_) {
            // jdphuff.c / jdarith.c start_pass
            for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
                c->prev_coef_bits[k] = scans_ > 1 ? c->coef_bits[k] : 0;
            for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
        } else {
            c->coef_bits[0] = 0;
        }
        // jdhuff.c jpeg_make_d_derived_tbl for the tables the scan uses: 4
        // of them, defined, codes short of the all-ones code, a DC table's
        // symbols categories (lossless: up to 16)
        const bool dc_used = lossless_ || !progressive_ || (ss == 0 && ah == 0);
        const bool ac_used = !lossless_ && (!progressive_ || ss > 0);
        if (!arithmetic_) {
            if ((dc_used && (c->dc_table > 3 || !dc_[c->dc_table].defined)) ||
                (ac_used && (c->ac_table > 3 || !ac_[c->ac_table].defined)))
                fail("corrupt JPEG data: a scan uses an undefined Huffman "
                     "table");
            if ((dc_used && dc_[c->dc_table].bad) ||
                (ac_used && ac_[c->ac_table].bad))
                fail("corrupt JPEG data: bad Huffman table (a code reaches "
                     "the all-ones code)");
            if (dc_used) {
                const Huffman& t = dc_[c->dc_table];
                for (int i = 0; i < t.count; ++i)
                    if (t.vals[i] > (lossless_ ? 16 : 15))
                        fail("corrupt JPEG data: bad Huffman table");
            }
        }
    }
    if (arithmetic_) arith_reset(scomps, ss, ah);
    // the MCUs: each component's h x v blocks (samples) in an interleaved
    // scan, one block of the component's own in a non-interleaved one
    const bool one = scomps.size() == 1;
    const int du = lossless_ ? 1 : 8;
    const int nbx = one ? (scomps[0]->width + du - 1) / du : mcux_;
    const int nby = one ? (scomps[0]->height + du - 1) / du : mcuy_;
    // lossless: the sample rows predicted as a first row (jddiffct.c:
    // the scan's first and each one after a restart, which comes at whole
    // MCU rows)
    std::vector<std::vector<char>> first_rows(scomps.size());
    if (lossless_) {
        if (restart_interval_ % nbx)
            fail("lossless JPEG whose restart interval (" +
                 std::to_string(restart_interval_) + ") is no whole number "
                 "of MCU rows (" + std::to_string(nbx) + " MCUs): libjpeg "
                 "refuses it");
        for (size_t i = 0; i < scomps.size(); ++i) {
            Component& c = *scomps[i];
            c.diff.assign(static_cast<size_t>(c.bw) * c.bh, 0);
            first_rows[i].assign(c.bh, 0);
            first_rows[i][0] = 1;
        }
    }
    // arithmetic: a decoding error (ct == -1) skips the MCUs up to the next
    // restart; Huffman: so does a segment cut short by a marker
    // (insufficient_data), the blocks left as they are
    bool failed = false;
    auto mcu_blocks = [&](int my, int mx) {
        for (Component* c : scomps) {
            const int bv = one ? 1 : c->v, bh = one ? 1 : c->h;
            for (int v = 0; v < bv; ++v)
                for (int h = 0; h < bh; ++h) {
                    const int by = my * bv + v, bx = mx * bh + h;
                    if (lossless_) {
                        c->diff[static_cast<size_t>(by) * c->bw + bx] =
                            lossless_diff(*c);
                        continue;
                    }
                    int16_t* blk = c->coef.data() +
                        (static_cast<size_t>(by) * c->bw + bx) * 64;
                    bool ok = true;
                    if (!progressive_) {
                        if (arithmetic_) ok = arith_sequential(*c, blk);
                        else block_sequential(*c, blk);
                    } else if (ss == 0) {
                        if (ah == 0) {
                            if (arithmetic_) ok = arith_dc_first(*c, blk, al);
                            else block_dc_first(*c, blk, al);
                        } else if (arithmetic_) {
                            arith_dc_refine(blk, al);
                        } else {
                            block_dc_refine(blk, al);
                        }
                    } else if (ah == 0) {
                        if (arithmetic_)
                            ok = arith_ac_first(*c, blk, ss, se, al);
                        else
                            block_ac_first(*c, blk, ss, se, al);
                    } else if (arithmetic_) {
                        ok = arith_ac_refine(*c, blk, ss, se, al);
                    } else {
                        block_ac_refine(*c, blk, ss, se, al);
                    }
                    if (!ok) {                  // libjpeg warns and skips
                        failed = true;
                        return;
                    }
                }
        }
    };
    // jdhuff.c decode_mcu of a sequential Huffman scan: the fast path
    // where no restart interval is set, no marker has been met and 512
    // bytes a block of the MCU are in hand (of the bytes Pillow has handed
    // over), else the slow one; suspended, the MCU is decoded again from
    // its start, as libjpeg does once Pillow has read its next block
    int mcu_size = 0;
    for (Component* c : scomps) mcu_size += one ? 1 : c->h * c->v;
    const bool sequential_huffman =
        !arithmetic_ && !lossless_ && !progressive_;
    std::vector<int> preds(scomps.size());
    auto mcu = [&](int my, int mx) {
        if (failed || (!arithmetic_ && !lossless_ && insufficient_)) return;
        if (!sequential_huffman) {
            mcu_blocks(my, mx);
            return;
        }
        const size_t pos = pos_;
        const uint64_t buf = bitbuf_;
        const int cnt = bitcnt_, unread = unread_;
        const bool insufficient = insufficient_;
        for (size_t i = 0; i < scomps.size(); ++i) preds[i] = scomps[i]->pred;
        auto restore = [&] {
            pos_ = pos;
            bitbuf_ = buf;
            bitcnt_ = cnt;
            unread_ = unread;
            insufficient_ = insufficient;
            for (size_t i = 0; i < scomps.size(); ++i)
                scomps[i]->pred = preds[i];
        };
        retry_ = true;
        for (;;) {
            const size_t held = std::min(fed_, n_);
            fast_ = !restart_interval_ && !unread_ && held > pos_ &&
                    held - pos_ >= static_cast<size_t>(512) * mcu_size;
            try {
                mcu_blocks(my, mx);
                if (fast_ && unread_) {         // a marker: the slow way
                    fast_ = false;
                    restore();
                    mcu_blocks(my, mx);
                }
                break;
            } catch (const Suspend&) {
                restore();
                fed_ += kPillowBlock;
            }
        }
        fast_ = retry_ = false;
    };
    int done = 0;
    bool skip_row = false;
    for (int my = 0; my < nby; ++my)
        for (int mx = 0; mx < nbx; ++mx) {
            // jdcoefct.c consume_data / decompress_onepass: an MCU fetched
            // with the segment whole (before the entropy decoder's own
            // restart) keeps its iMCU row good
            if (!insufficient_) last_good_row_ = one ? my / scomps[0]->v : my;
            if (restart_interval_ && done && done % restart_interval_ == 0) {
                try {
                    restart(scomps, ss, ah);
                } catch (const ResyncFailed&) {
                    // libjpeg stops here; whether libtiff's reads came this
                    // far, the caller decides
                    resync_row_ = my;
                    return;
                }
                failed = false;
                if (lossless_ && mx == 0)
                    for (size_t i = 0; i < scomps.size(); ++i)
                        first_rows[i][one ? my : my * scomps[i]->v] = 1;
            }
            // jdlhuff.c: an MCU row that starts cut short reads as zero
            // differences, and the prediction starts over
            if (lossless_ && mx == 0) {
                skip_row = insufficient_;
                if (skip_row)
                    for (size_t i = 0; i < scomps.size(); ++i)
                        first_rows[i][one ? my : my * scomps[i]->v] = 1;
            }
            if (!skip_row) mcu(my, mx);
            ++done;
        }
    if (lossless_)
        for (size_t i = 0; i < scomps.size(); ++i)
            undifference(*scomps[i], ss, al, first_rows[i]);
}

// The accurate integer IDCT ("islow") as libjpeg-turbo's SIMD code
// computes it (jidctint-avx2.asm, which Pillow's build runs; its results
// are jidctint.c's wherever no intermediate leaves 16 bits, as in every
// well-formed file): the dequantised coefficients and the sums of two of
// them kept to 16 bits (pmullw, paddw), the products summed in 32 bits
// (pmaddwd), each pass's results saturated to 16 bits (packssdw), and the
// output saturated to 8 bits and centred (packsswb, paddb 128). A block
// whose AC coefficients are all zero takes the first pass's shortcut:
// its dequantised DC, shifted in 16 bits.
constexpr int kConstBits = 13, kPass1Bits = 2;

inline int16_t wrap16(int32_t x) {
    return static_cast<int16_t>(static_cast<uint16_t>(x & 0xFFFF));
}

inline int16_t sat16(int32_t x) {
    return static_cast<int16_t>(std::min(std::max(x, -32768), 32767));
}

inline int32_t add32(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
}

inline int32_t sub32(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) -
                                static_cast<uint32_t>(b));
}

// pmaddwd of the pairs (a, b) and (ca, cb)
inline int32_t madd(int16_t a, int16_t b, int32_t ca, int32_t cb) {
    return add32(a * ca, b * cb);
}

// One 8-point pass over x[0..7] (16 bits), out[k] = the 32-bit values
// before the descale, in the SIMD code's grouping of the constants.
void idct_8(const int16_t* x, int32_t* out) {
    const int32_t tmp3 = madd(x[2], x[6], 10703, 4433);   // F130, F054
    const int32_t tmp2 = madd(x[2], x[6], 4433, -10704);  // F054, -F130
    const int32_t tmp0 = int32_t(wrap16(x[0] + x[4])) * (1 << kConstBits);
    const int32_t tmp1 = int32_t(wrap16(x[0] - x[4])) * (1 << kConstBits);
    const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
    const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
    const int16_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
    const int16_t z3 = wrap16(t0 + t2), z4 = wrap16(t1 + t3);
    const int32_t z3p = madd(z3, z4, -6436, 9633);        // -F078, F117
    const int32_t z4p = madd(z3, z4, 9633, 6437);         // F117, F078
    const int32_t o0 = add32(madd(t0, t3, -4927, -7373), z3p);
    const int32_t o3 = add32(madd(t0, t3, -7373, 4926), z4p);
    const int32_t o1 = add32(madd(t1, t2, -4176, -20995), z4p);
    const int32_t o2 = add32(madd(t1, t2, -20995, 4177), z3p);
    out[0] = add32(tmp10, o3);
    out[7] = sub32(tmp10, o3);
    out[1] = add32(tmp11, o2);
    out[6] = sub32(tmp11, o2);
    out[2] = add32(tmp12, o1);
    out[5] = sub32(tmp12, o1);
    out[3] = add32(tmp13, o0);
    out[4] = sub32(tmp13, o0);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
    int16_t ws[64];                   // [row][column] after the first pass
    bool ac_zero = true;
    for (int k = 8; k < 64; ++k) ac_zero = ac_zero && in[k] == 0;
    if (ac_zero) {
        for (int col = 0; col < 8; ++col) {
            const int16_t dc = wrap16(wrap16(in[col] * q[col]) * 4);
            for (int r = 0; r < 8; ++r) ws[8 * r + col] = dc;
        }
    } else {
        for (int col = 0; col < 8; ++col) {
            int16_t x[8];
            int32_t y[8];
            for (int r = 0; r < 8; ++r)
                x[r] = wrap16(in[8 * r + col] * q[8 * r + col]);
            idct_8(x, y);
            const int sh = kConstBits - kPass1Bits;
            for (int r = 0; r < 8; ++r)
                ws[8 * r + col] = sat16(add32(y[r], 1 << (sh - 1)) >> sh);
        }
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int row = 0; row < 8; ++row) {
        int32_t y[8];
        idct_8(ws + 8 * row, y);
        uint8_t* op = out + static_cast<size_t>(row) * stride;
        for (int k = 0; k < 8; ++k) {
            const int v = sat16(add32(y[k], 1 << (sh - 1)) >> sh);
            op[k] = static_cast<uint8_t>(std::min(std::max(v, -128), 127) +
                                         128);
        }
    }
}

// jdcoefct.c smoothing_ok: progressive, every component's DC known and the
// quantisers of its DC and first nine AC coefficients nonzero, and some
// component with one of those nine coefficients not fully refined (its
// coef_bits not 0: -1 never coded, Al > 0 still approximate). The
// coef_bits are those after the last scan (libjpeg latches them once the
// whole file is in; a file cut short is an error in Pillow).
bool Decoder::smoothing_ok() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const Component& c : comps_) {
        if (!c.latched) return false;
        for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
            if (c.quant[k] == 0) return false;
        if (c.coef_bits[0] < 0) return false;
        for (int k = 1; k < 10; ++k)
            if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later) for one
// block: ws (a copy of the block) gets estimates of its coefficients 1-9
// (zigzag) that are still zero and not known to be exact, from the DC
// values of the 5x5 blocks around it (dc[r][c], r and c -2..2 as 0..4,
// the current block dc[2][2]). Where no AC coefficient of 1-9 was ever
// coded, a Gaussian-like kernel estimates them all and the DC too
// ("change_dc"); otherwise the five of section K.8, on the 5x5 window.
// Each estimate is ((Q << 7) + num) / (Q << 8) of num = Q00 x the
// kernel's sum, rounded away from zero, and capped at 2^Al - 1 in
// magnitude where the coefficient has Al bits to come.
void smooth_block(const int* dcv, const uint16_t* q, const int* coef_bits,
                  int16_t* ws) {
    auto dc = [&](int i) { return dcv[i - 1]; };   // DC01..DC25
    const bool change_dc = coef_bits[1] == -1 && coef_bits[2] == -1 &&
        coef_bits[3] == -1 && coef_bits[4] == -1 && coef_bits[5] == -1 &&
        coef_bits[6] == -1 && coef_bits[7] == -1 && coef_bits[8] == -1 &&
        coef_bits[9] == -1;
    const int64_t q00 = q[0];
    auto estimate = [&](int zz, int nat, int64_t qk, int64_t sum) {
        const int al = coef_bits[zz];
        if (al == 0 || ws[nat] != 0) return;
        const int64_t num = q00 * sum;
        int pred;
        if (num >= 0) {
            pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        } else {
            pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
        }
        ws[nat] = static_cast<int16_t>(pred);
    };
    // AC01
    estimate(1, 1, q[1], change_dc ?
        (-dc(1) - dc(2) + dc(4) + dc(5) - 3 * dc(6) + 13 * dc(7) -
         13 * dc(9) + 3 * dc(10) - 3 * dc(11) + 38 * dc(12) - 38 * dc(14) +
         3 * dc(15) - 3 * dc(16) + 13 * dc(17) - 13 * dc(19) + 3 * dc(20) -
         dc(21) - dc(22) + dc(24) + dc(25)) :
        (-7 * dc(11) + 50 * dc(12) - 50 * dc(14) + 7 * dc(15)));
    // AC10
    estimate(2, 8, q[8], change_dc ?
        (-dc(1) - 3 * dc(2) - 3 * dc(3) - 3 * dc(4) - dc(5) - dc(6) +
         13 * dc(7) + 38 * dc(8) + 13 * dc(9) - dc(10) + dc(16) -
         13 * dc(17) - 38 * dc(18) - 13 * dc(19) + dc(20) + dc(21) +
         3 * dc(22) + 3 * dc(23) + 3 * dc(24) + dc(25)) :
        (-7 * dc(3) + 50 * dc(8) - 50 * dc(18) + 7 * dc(23)));
    // AC20
    estimate(3, 16, q[16], change_dc ?
        (dc(3) + 2 * dc(7) + 7 * dc(8) + 2 * dc(9) - 5 * dc(12) -
         14 * dc(13) - 5 * dc(14) + 2 * dc(17) + 7 * dc(18) + 2 * dc(19) +
         dc(23)) :
        (-dc(3) + 13 * dc(8) - 24 * dc(13) + 13 * dc(18) - dc(23)));
    // AC11
    estimate(4, 9, q[9], change_dc ?
        (-dc(1) + dc(5) + 9 * dc(7) - 9 * dc(9) - 9 * dc(17) + 9 * dc(19) +
         dc(21) - dc(25)) :
        (dc(10) + dc(16) - 10 * dc(17) + 10 * dc(19) - dc(2) - dc(20) +
         dc(22) - dc(24) + dc(4) - dc(6) + 10 * dc(7) - 10 * dc(9)));
    // AC02
    estimate(5, 2, q[2], change_dc ?
        (2 * dc(7) - 5 * dc(8) + 2 * dc(9) + dc(11) + 7 * dc(12) -
         14 * dc(13) + 7 * dc(14) + dc(15) + 2 * dc(17) - 5 * dc(18) +
         2 * dc(19)) :
        (-dc(11) + 13 * dc(12) - 24 * dc(13) + 13 * dc(14) - dc(15)));
    if (!change_dc) return;
    // AC03, AC12, AC21, AC30
    estimate(6, 3, q[3], dc(7) - dc(9) + 2 * dc(12) - 2 * dc(14) + dc(17) -
                             dc(19));
    estimate(7, 10, q[10], dc(7) - 3 * dc(8) + dc(9) - dc(17) +
                               3 * dc(18) - dc(19));
    estimate(8, 17, q[17], dc(7) - dc(9) - 3 * dc(12) + 3 * dc(14) +
                               dc(17) - dc(19));
    estimate(9, 24, q[24], dc(7) + 2 * dc(8) + dc(9) - dc(17) -
                               2 * dc(18) - dc(19));
    // DC
    const int64_t num = q00 *
        (-2 * dc(1) - 6 * dc(2) - 8 * dc(3) - 6 * dc(4) - 2 * dc(5) -
         6 * dc(6) + 6 * dc(7) + 42 * dc(8) + 6 * dc(9) - 6 * dc(10) -
         8 * dc(11) + 42 * dc(12) + 152 * dc(13) + 42 * dc(14) -
         8 * dc(15) - 6 * dc(16) + 6 * dc(17) + 42 * dc(18) + 6 * dc(19) -
         6 * dc(20) - 2 * dc(21) - 6 * dc(22) - 8 * dc(23) - 6 * dc(24) -
         2 * dc(25));
    int pred;
    if (num >= 0)
        pred = static_cast<int>(((q00 << 7) + num) / (q00 << 8));
    else
        pred = -static_cast<int>(((q00 << 7) - num) / (q00 << 8));
    ws[0] = static_cast<int16_t>(pred);
}

// The component's samples [height][width], cropped from its blocks, with
// the blocks smoothed first where smooth. The smoothing reads the DC of
// the blocks around, clamped to the component's blocks across (its
// width_in_blocks) and, down the rows, by jdcoefct.c's own rule: an iMCU
// row of v block rows, the last one of height_in_blocks % v (or v), the
// row above or below counted within block_rows x total_iMCU_rows, so that
// a row can reach the padding rows of the last iMCU row, and the last
// iMCU row's rows other neighbours than the plain clamp would give.
void Decoder::idct_plane(const Component& c, bool smooth,
                         std::vector<uint8_t>& plane, bool padded) const {
    const int pw = c.bw * 8;
    std::vector<uint8_t> full(static_cast<size_t>(pw) * c.bh * 8);
    auto block = [&](int by, int bx) {
        return c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
    };
    auto out = [&](int by, int bx) {
        return full.data() + static_cast<size_t>(by) * 8 * pw + bx * 8;
    };
    if (!smooth) {
        for (int by = 0; by < c.bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_islow(block(by, bx), c.quant, out(by, bx), pw);
    } else {
        const int wb = (c.width + 7) / 8, hb = (c.height + 7) / 8;
        const int vs = c.v, rows = mcuy_;
        // smoothing_ok's latch of the coefficient bits before the last
        // scan: -1 where the file has one scan
        int prev_bits[10];
        for (int k = 1; k < 10; ++k)
            prev_bits[k] = scans_ > 1 ? c.prev_coef_bits[k] : -1;
        prev_bits[0] = c.coef_bits[0];
        int16_t ws[64];
        int dcv[25];
        for (int r = 0; r < rows; ++r) {
            int block_rows = vs;
            if (r == rows - 1) {
                block_rows = hb % vs;
                if (block_rows == 0) block_rows = vs;
            }
            const int image_rows = block_rows * rows;
            for (int b = 0; b < block_rows; ++b) {
                const int row = r * vs + b;
                const int ib = r * block_rows + b;
                const int prev = ib > 0 ? row - 1 : row;
                const int pprev = ib > 1 ? row - 2 : prev;
                const int next = ib < image_rows - 1 ? row + 1 : row;
                const int nnext = ib < image_rows - 2 ? row + 2 : next;
                const int brows[5] = {pprev, prev, row, next, nnext};
                for (int bx = 0; bx < wb; ++bx) {
                    for (int i = 0; i < 5; ++i)
                        for (int j = 0; j < 5; ++j) {
                            const int x = std::min(std::max(bx + j - 2, 0),
                                                   wb - 1);
                            dcv[5 * i + j] = block(brows[i], x)[0];
                        }
                    std::memcpy(ws, block(row, bx), sizeof ws);
                    smooth_block(dcv, c.quant,
                                 r > last_good_row_ ? prev_bits : c.coef_bits,
                                 ws);
                    idct_islow(ws, c.quant, out(row, bx), pw);
                }
            }
        }
    }
    if (padded) {              // every block of the MCU grid, as it is
        plane.swap(full);
        return;
    }
    plane.resize(static_cast<size_t>(c.width) * c.height);
    for (int y = 0; y < c.height; ++y)
        std::memcpy(plane.data() + static_cast<size_t>(y) * c.width,
                    full.data() + static_cast<size_t>(y) * pw, c.width);
}

// jdlossls.c: the samples of a component from its differences: the
// first row of the scan (and of each restart interval) predicted from
// 2^(7 - Pt) and then the sample to its left, each other row's first
// sample from the one above and the rest by the predictor psv of the
// neighbours Ra (left), Rb (above) and Rc (above left); values kept to 16
// bits, then shifted up by the point transform into 8-bit samples.
void Decoder::undifference(Component& c, int psv, int pt,
                           const std::vector<char>& first_rows) {
    const int w = c.width;
    std::vector<int32_t> prev(w), cur(w);
    c.samples.resize(static_cast<size_t>(w) * c.height);
    for (int y = 0; y < c.height; ++y) {
        const int32_t* d = c.diff.data() + static_cast<size_t>(y) * c.bw;
        if (first_rows[y]) {
            int ra = (d[0] + (1 << (8 - pt - 1))) & 0xFFFF;
            cur[0] = ra;
            for (int x = 1; x < w; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
        } else {
            int rb = prev[0], ra = (d[0] + rb) & 0xFFFF;
            cur[0] = ra;
            for (int x = 1; x < w; ++x) {
                const int rc = rb;
                rb = prev[x];
                int64_t p;
                switch (psv) {
                    case 1: p = ra; break;
                    case 2: p = rb; break;
                    case 3: p = rc; break;
                    case 4: p = int64_t(ra) + rb - rc; break;
                    case 5: p = ra + ((int64_t(rb) - rc) >> 1); break;
                    case 6: p = rb + ((int64_t(ra) - rc) >> 1); break;
                    default: p = (int64_t(ra) + rb) >> 1; break;
                }
                cur[x] = ra = static_cast<int>((d[x] + p) & 0xFFFF);
            }
        }
        uint8_t* s = c.samples.data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x)
            s[x] = static_cast<uint8_t>(static_cast<uint32_t>(cur[x]) << pt);
        std::swap(prev, cur);
    }
}

// jdsample.c: a component's samples brought to [height][width] of the
// image, he x ve times as many, by the method jinit_upsampler picks: the
// fancy filters h2v1 and h2v2 where the component is more than 2 samples
// wide, h1v2 at any width, replication (fullsize, h2v1_upsample,
// h2v2_upsample, int_upsample) otherwise, and always when fancy is off.
void upsample(const std::vector<uint8_t>& in, int cw, int ch, int he, int ve,
              bool fancy, int width, int height, std::vector<uint8_t>& out) {
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
    const bool h2v1 = fancy && he == 2 && ve == 1 && cw > 2;
    const bool h2v2 = fancy && he == 2 && ve == 2 && cw > 2;
    const bool h1v2 = fancy && he == 1 && ve == 2;
    for (int y = 0; y < height; ++y) {
        const int iy = y / ve;
        // the nearer row's neighbour: above for even output rows, below
        // for odd ones, the edge rows repeated
        const int ny = (y % 2 == 0) ? std::max(iy - 1, 0)
                                    : std::min(iy + 1, ch - 1);
        uint8_t* op = out.data() + static_cast<size_t>(y) * width;
        for (int x = 0; x < width; ++x) {
            const int ix = x / he;
            const int nx = (x % 2 == 0) ? std::max(ix - 1, 0)
                                        : std::min(ix + 1, cw - 1);
            int v;
            if (h2v1) {                        // h2v1_fancy_upsample
                v = (3 * at(iy, ix) + at(iy, nx) + (x % 2 == 0 ? 1 : 2)) >> 2;
            } else if (h2v2) {                 // h2v2_fancy_upsample
                int thiscol = 3 * at(iy, ix) + at(ny, ix);
                int othercol = 3 * at(iy, nx) + at(ny, nx);
                v = (3 * thiscol + othercol + (x % 2 == 0 ? 8 : 7)) >> 4;
            } else if (h1v2) {                 // h1v2_fancy_upsample
                v = (3 * at(iy, ix) + at(ny, ix) + (y % 2 == 0 ? 1 : 2)) >> 2;
            } else {                           // replication
                v = at(iy, ix);
            }
            op[x] = static_cast<uint8_t>(v);
        }
    }
}

void Decoder::decode(uint8_t* out) {
    for (auto& c : comps_)
        if (!lossless_) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    pos_ = first_scan_;
    end_is_eoi_ = fed_ == SIZE_MAX;
    // jstdhuff.c std_huff_tables, which jdhuff.c's decoder (sequential
    // Huffman only) calls at jpeg_start_decompress: the tables no DHT
    // defined before the first scan
    if (!arithmetic_ && !progressive_ && !lossless_)
        for (int t = 0; t < 2; ++t) {
            if (!dc_[t].defined) dc_[t].build_std(t ? kStdDc1 : kStdDc0);
            if (!ac_[t].defined) ac_[t].build_std(t ? kStdAc1 : kStdAc0);
        }
    try {
        for (;;) {
            int m = unread_;
            unread_ = 0;
            if (!m) m = next_marker();
            if (m == 0xD9) break;               // EOI
            if (m == 0xDA) {
                if (scans_ && !multiscan_)
                    fail("corrupt JPEG data: a second scan after a "
                         "sequential scan of every component (libjpeg "
                         "expects EOI)");
                ++scans_;
                std::vector<Component*> scomps;
                int ss = 0, se = 0, ah = 0, al = 0;
                read_sos(scomps, ss, se, ah, al);
                if (scans_ == 1)
                    multiscan_ = progressive_ || scomps.size() < comps_.size();
                decode_scan(scomps, ss, se, ah, al);
                if (resync_row_ >= 0) break;    // libjpeg stops here
                // libtiff's old-style JPEG codec reads the scanlines it
                // needs and never finishes: what follows a scan of every
                // component (the next plane's SOS) is left unread
                if (resync_fails && !multiscan_) break;
                if (!multiscan_) end_is_eoi_ = true;
                // on to the next marker (unread_, or past the scan's last
                // bytes)
                bitcnt_ = 0;
                continue;
            }
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC)
                fail("corrupt JPEG data: a second frame header");
            read_segment(m);
        }
    } catch (const EndOfImage&) {
    }
    if (!scans_) fail("JPEG without a scan");
    for (auto& c : comps_)
        if (c.coef_bits[0] < 0)
            fail("corrupt JPEG data: a component's DC was never coded");
    const int nc = ncomp();
    // the colour space (jdapimin.c default_decompress_parms)
    enum { kGrey, kRgb, kYcc, kCmyk, kYcck, kNone } space = kNone;
    if (color == 1) {
        space = kYcc;
    } else if (color == -1) {
        if (nc == 1)
            space = kGrey;
        else if (nc == 3)
            space = jfif_ ? kYcc : adobe_ ? (adobe_transform_ == 0 ? kRgb
                                                                   : kYcc)
                  : (comps_[0].id == 'R' && comps_[1].id == 'G' &&
                     comps_[2].id == 'B') ? kRgb : kYcc;
        else
            space = adobe_ && adobe_transform_ != 0 ? kYcck : kCmyk;
        // jdcolor.c: no lossy colour conversion in lossless mode
        if (lossless_ && (space == kYcc || space == kYcck))
            fail(std::string("lossless JPEG in ") +
                 (space == kYcc ? "YCbCr" : "YCCK") + " is not supported "
                 "(libjpeg converts no colours in lossless mode)");
    }
    const bool smooth = !lossless_ && smoothing_ok();
    std::vector<std::vector<uint8_t>> planes(comps_.size());
    for (size_t i = 0; i < comps_.size(); ++i) {
        std::vector<uint8_t> plane;
        const Component& c = comps_[i];
        if (color == 2) {      // raw data: the MCU grid's blocks, as they are
            if (lossless_) fail("raw data of a lossless JPEG");
            idct_plane(c, smooth, plane, true);
            std::memcpy(out, plane.data(), plane.size());
            out += plane.size();
            continue;
        }
        if (lossless_)
            plane = c.samples;
        else
            idct_plane(c, smooth, plane);
        if (plane.size() != static_cast<size_t>(c.width) * c.height)
            fail("corrupt JPEG data: a component was never coded");
        upsample(plane, c.width, c.height, hmax_ / c.h, vmax_ / c.v,
                 !lossless_, width, height, planes[i]);
    }
    if (color == 2) {           // then the MCU row whose restart failed
        const int32_t row = resync_row_;
        std::memcpy(out, &row, sizeof row);
        return;
    }
    const size_t npx = static_cast<size_t>(width) * height;
    if (space == kNone || space == kRgb || space == kCmyk) {
        const size_t k = comps_.size();        // no conversion
        for (size_t i = 0; i < npx; ++i)
            for (size_t j = 0; j < k; ++j) out[k * i + j] = planes[j][i];
        if (resync_fails) {     // then the MCU row whose restart failed
            const int32_t row = resync_row_;
            std::memcpy(out + npx * k, &row, sizeof row);
        }
        return;
    }
    if (space == kGrey) {
        for (size_t i = 0; i < npx; ++i)
            out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[0][i];
        return;
    }
    // jdcolor.c build_ycc_rgb_table, ycc_rgb_convert and ycck_cmyk_convert
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
    const int k = space == kYcck ? 4 : 3;
    for (size_t i = 0; i < npx; ++i) {
        int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
        int r = y + cr_r[cr];
        int g = y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale);
        int b = y + cb_b[cb];
        if (k == 4) {                           // YCCK: inverted, K as is
            r = 255 - r;
            g = 255 - g;
            b = 255 - b;
            out[4 * i + 3] = planes[3][i];
        }
        out[k * i] = clamp(r);
        out[k * i + 1] = clamp(g);
        out[k * i + 2] = clamp(b);
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

// info: width, height, channels of the output (3 RGB, 4 CMYK)
int cge_jpeg_info(const unsigned char* data, long n, int* info, char* err,
                  int errlen) {
    return guarded(err, errlen, [&] {
        Decoder d(data, static_cast<size_t>(n));
        d.parse_headers();
        info[0] = d.width;
        info[1] = d.height;
        info[2] = d.channels();
    });
}

int cge_jpeg_decode(const unsigned char* data, long n, unsigned char* out,
                    long capacity, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        Decoder d(data, static_cast<size_t>(n));
        d.parse_headers();
        if (static_cast<long>(d.width) * d.height * d.channels() > capacity)
            fail("the output buffer is too small");
        d.decode(out);
    });
}

// JPEG in TIFF (compression 7), as libtiff's tif_jpeg.c hands it to
// libjpeg: the tables-only stream of the JPEGTables tag (tn 0: none), then
// the strip's or tile's own stream, decoded in the colour space the TIFF
// sets (color: 0 none, 1 YCbCr -> RGB; 2 raw data, as libtiff's
// old-style JPEG codec reads YCbCr). info: width, height, components,
// the first component's sampling factors, and 1 if the others are 1x1.
int cge_jpeg_tiff_info(const unsigned char* tables, long tn,
                       const unsigned char* data, long n, int color,
                       int* info, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        Decoder d(data, static_cast<size_t>(n));
        d.color = color & 3;
        d.resync_fails = (color & 4) != 0;
        if (tn > 0) d.load_tables(tables, static_cast<size_t>(tn));
        d.parse_headers();
        info[0] = d.width;
        info[1] = d.height;
        info[2] = d.ncomp();
        info[3] = d.h0;
        info[4] = d.v0;
        info[5] = d.rest_1x1 ? 1 : 0;
    });
}

// ... and its samples: [height][width][components] with color 0, [height]
// [width][3] RGB with color 1, each component's plane of its blocks in the
// MCU grid ([MCU rows x v x 8][MCU columns x h x 8], the blocks past the
// component's own size included) in turn with color 2; with color 2, and
// color 0 under libtiff's old-style JPEG source (color | 4), then an
// int32: the MCU row at whose restart that source failed, after which
// nothing was decoded (-1: none).
int cge_jpeg_tiff_decode(const unsigned char* tables, long tn,
                         const unsigned char* data, long n, int color,
                         unsigned char* out, long capacity, char* err,
                         int errlen) {
    return guarded(err, errlen, [&] {
        Decoder d(data, static_cast<size_t>(n));
        d.color = color & 3;
        d.resync_fails = (color & 4) != 0;
        if (tn > 0) d.load_tables(tables, static_cast<size_t>(tn));
        d.parse_headers();
        // (color 0 under libtiff's old-style JPEG source: then the failed
        // row's int32)
        const long row = d.resync_fails && d.color == 0 ? 4 : 0;
        if (static_cast<long>(d.width) * d.height * d.channels() + row >
            capacity)
            fail("the output buffer is too small");
        d.decode(out);
    });
}

}  // extern "C"
