// Byte-serial decoding for the port's texture loader
// (cge_tpu_torch/scene/image_io.py and the format modules beside it).
//
// The JAX package loads a texture through Pillow. This file holds the parts
// of decoding that run byte by byte, each giving the bytes Pillow 12's
// decoders give; headers, palettes, orientation and colour conversion stay
// in numpy. JPEG (JPEG in TIFF too) has a file of its own, cge_jpeg.cpp.
// The others here, each a loop over a stream that numpy cannot split:
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
// Entry points (C ABI, loaded with ctypes): each writes the bytes its
// comment names and returns 0, or -1 with a message in err, and reads no
// byte past n.

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
