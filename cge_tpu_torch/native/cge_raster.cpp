// Byte-serial decoding of the raster formats of model and game asset sets
// for the port's texture loader (cge_tpu_torch/scene/sgi.py, pcx.py, sun.py,
// qoi.py, icns.py, tiff.py, xbm.py, fli.py, msp.py and im.py).
//
// The JAX package loads a texture through Pillow. This file holds the loops
// over a stream that numpy cannot split, each giving the bytes Pillow 12's
// decoder gives; headers, palettes, orientation and colour conversion stay
// in numpy:
//
//   - SGI run-length rows (cge_sgi_rle), as Pillow's SgiRleDecode.c: the
//     start and length tables after the 512-byte header, one entry a row
//     and channel; each row's length read as a count of packets, not of
//     bytes; a row that ends early keeps the bytes the previous row left in
//     the row buffer; a last packet that is not the terminator ends the
//     whole image there, without an error; the bounds checks stop one byte
//     short of the file's end, as Pillow's do; 8- and 16-bit atoms;
//   - PCX run-length rows (cge_pcx_rle), as Pillow's PcxDecode.c: a byte
//     of the form 11xxxxxx repeats the next byte xxxxxx times, any other
//     byte is itself; a run that crosses the end of a row (of all planes)
//     is an error;
//   - Sun raster run-length rows (cge_sun_rle), as Pillow's SunRleDecode.c:
//     0x80 0x00 is one byte 0x80, 0x80 n v is n + 1 bytes v, any other
//     byte is itself; runs flow on into the next rows;
//   - the QOI op stream (cge_qoi), as Pillow's QoiDecoder: RGB, RGBA,
//     index, diff, luma and run ops from black opaque, the index hash
//     (3r + 5g + 7b + 11a) % 64 updated by every op but the run, a missing
//     index entry read as transparent black; the stream must hold every
//     op's bytes up to the last pixel;
//   - ICNS run-length colour entries (cge_icns_rle), as Pillow's
//     IcnsImagePlugin.read_32: the red, green and blue channels one after
//     another, a byte b >= 0x80 repeating the next byte b - 125 times, any
//     other b + 1 literal bytes; a channel whose runs overrun its pixels,
//     or whose data end first (a read cut short included), is an error;
//   - ThunderScan 4-bit rows (cge_thunder), as libtiff 4.7's tif_thunder.c
//     ThunderDecode: each row from a last pixel of 0, a byte's top two bits
//     choosing a run of the last pixel (its low six bits the count), three
//     2-bit or two 3-bit deltas from it (the skip codes 2 and 4 writing
//     none), or a raw pixel; a row that the data leave short, or that a run
//     overruns (it then writes none of its pixels), is an error (libtiff's
//     "Not enough" / "Too much data");
//   - XBM's hex bytes (cge_xbm), as Pillow's XbmDecode.c: from the end of
//     the header on, each byte from the two characters after the next
//     'x' (a character that is no hex digit reads 0, so "0x1," is 0x10),
//     the search going on past them; the data must hold the bytes of the
//     last row, the two characters after its last 'x' included;
//   - an FLI / FLC frame chunk (cge_fli_frame), as Pillow's FliDecode.c
//     walks it: its sub-chunks in turn, each moved past by its own size
//     (0, or past the frame, is an error), SS2 word deltas (7: skip and
//     last-byte flag words, runs of byte pairs), LC byte deltas (12: a
//     start line and a count of lines), BLACK (13), BRUN (15: byte runs,
//     each line's packet count byte passed over), COPY (16: the raw
//     image), the palette and stamp chunks (4, 11, 18) passed over and any
//     other type an error; a packet that overruns its line ends the line's
//     packets, after which SS2 and LC stop with an error and BRUN fails
//     unless the line is whole; data that the frame's bytes do not hold
//     are an error, as is a COPY chunk cut short (after which Pillow reads
//     on and never finds another frame);
//   - Windows Paint 2.x rows (cge_msp_rle), as Pillow's MspDecoder: each
//     row's encoded length from the row map, a length of 0 a white row, a
//     byte 0 a run (a count, then the byte), any other byte n that many
//     literal bytes (as many as the row still holds); the rows joined into
//     one stream whose first rows x stride bytes are the image; a row that
//     the file cuts short, a run cut after its 0, and a stream too short
//     for the image are errors;
//   - IM's packed samples of 2 to 31 bits (cge_bit_decode), as Pillow's
//     BitDecode.c with IM's arguments (pad 8, fill 3, unsigned): each byte
//     ORed into a 64-bit buffer above the bits it holds, a sample taken
//     from its low bits, the buffer shifted down by the sample's bits (or,
//     where it held more than 32, set to the last byte's bits left over);
//     at a row's end the count of buffered bits is set to 0 but not the
//     buffer, whose leftover bits so reach the next row's first sample;
//     rows from the bottom; data that end before the last sample are an
//     error.
//
// Entry points (C ABI, loaded with ctypes): each writes the bytes its
// comment names and returns 0, or -1 with a message in err, and reads no
// byte past n.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct DecodeError {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

constexpr size_t kSgiHeader = 512;

uint32_t be32(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 24) |
           (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

// One channel of one row (expandrow and expandrow2): n packets from
// buf[at:], every bpc-byte atom written z atoms apart into dest. 0 when the
// row ends (its packets spent or a zero count), 1 when the last packet is
// not a zero count (the image ends there), -1 on an overrun. last is the
// index of the last byte of buf, the data after the header; like Pillow's,
// the checks keep a copy or a 16-bit run value off that byte.
int sgi_row(uint8_t* dest, const uint8_t* buf, int64_t at, uint32_t n,
            int z, int xsize, int bpc, int64_t last) {
    int x = 0;
    const size_t step = static_cast<size_t>(z) * bpc;
    for (int64_t left = static_cast<int32_t>(n); left > 0; --left) {
        if (at + (bpc - 1) > last) return -1;
        const uint8_t pixel = buf[at + bpc - 1];
        at += bpc;
        if (left == 1 && pixel != 0) return 1;
        int count = pixel & 0x7F;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (at + static_cast<int64_t>(bpc) * count > last) return -1;
            for (; count > 0; --count, at += bpc, dest += step)
                std::memcpy(dest, buf + at, bpc);
        } else {
            if (at + (bpc == 1 ? 0 : 2) > last) return -1;
            for (; count > 0; --count, dest += step)
                std::memcpy(dest, buf + at, bpc);
            at += bpc;
        }
    }
    return 0;
}

// The whole file in, out [height][width * bands * bpc] in the tables' row
// order (the file's first row is the image's last); the rows after an
// early end are left as they are.
void sgi_rle(const uint8_t* data, size_t n, int width, int height,
             int bands, int bpc, uint8_t* out) {
    if (width < 1 || height < 1 || bands < 1 || (bpc != 1 && bpc != 2))
        fail("bad SGI image geometry");
    const int64_t bufsize = static_cast<int64_t>(n) -
                            static_cast<int64_t>(kSgiHeader);
    const int64_t tablen = static_cast<int64_t>(bands) * height;
    if (bufsize < 8 * tablen)
        fail("SGI run-length tables are truncated (buffer overrun)");
    const uint8_t* buf = data + kSgiHeader;
    const size_t row = static_cast<size_t>(width) * bands * bpc;
    std::vector<uint8_t> line(row, 0);
    for (int r = 0; r < height; ++r) {
        for (int c = 0; c < bands; ++c) {
            const int64_t k = r + static_cast<int64_t>(c) * height;
            const uint32_t start = be32(buf + 4 * k);
            const uint32_t length = be32(buf + 4 * (tablen + k));
            if (start < kSgiHeader)
                fail("SGI row starts inside the header (buffer overrun)");
            const int status = sgi_row(line.data() + c * bpc, buf,
                                       start - kSgiHeader, length, bands,
                                       width, bpc, bufsize - 1);
            if (status == -1)
                fail("SGI run-length row overruns its row or the file "
                     "(buffer overrun)");
            if (status == 1) return;
        }
        std::memcpy(out + static_cast<size_t>(r) * row, line.data(), row);
    }
}

// Rows [rows][row_bytes] from data[offset:].
void pcx_rle(const uint8_t* data, size_t n, size_t offset, size_t row_bytes,
             int rows, uint8_t* out) {
    if (rows < 1 || row_bytes < 1) fail("bad PCX image geometry");
    const size_t total = row_bytes * static_cast<size_t>(rows);
    size_t pos = offset, done = 0, x = 0;
    bool overrun = false;
    while (done < total) {
        if (pos >= n) fail("PCX image data is truncated");
        const uint8_t b = data[pos];
        if ((b & 0xC0) == 0xC0) {
            if (pos + 1 >= n) fail("PCX image data is truncated");
            for (int k = b & 0x3F; k > 0; --k) {
                if (x >= row_bytes) {
                    overrun = true;
                    break;
                }
                out[done + x++] = data[pos + 1];
            }
            pos += 2;
        } else {
            out[done + x++] = b;
            ++pos;
        }
        if (x >= row_bytes) {
            done += row_bytes;
            x = 0;
        }
    }
    if (overrun) fail("PCX run crosses the end of a row (buffer overrun)");
}

// Rows [rows][row_bytes] from data[offset:].
void sun_rle(const uint8_t* data, size_t n, size_t offset, size_t row_bytes,
             int rows, uint8_t* out) {
    if (rows < 1 || row_bytes < 1) fail("bad Sun raster image geometry");
    const size_t total = row_bytes * static_cast<size_t>(rows);
    size_t pos = offset, done = 0;
    while (done < total) {
        if (pos >= n) fail("Sun raster image data is truncated");
        const uint8_t b = data[pos];
        if (b != 0x80) {
            out[done++] = b;
            ++pos;
            continue;
        }
        if (pos + 1 >= n) fail("Sun raster image data is truncated");
        const size_t count = data[pos + 1];
        if (!count) {
            out[done++] = 0x80;
            pos += 2;
            continue;
        }
        if (pos + 2 >= n) fail("Sun raster image data is truncated");
        const size_t take = count + 1 < total - done ? count + 1
                                                     : total - done;
        std::memset(out + done, data[pos + 2], take);
        done += take;
        pos += 3;
    }
}

// pixels RGBA quadruples out, from the op stream at data[offset:].
void qoi(const uint8_t* data, size_t n, size_t offset, int64_t pixels,
         uint8_t* out) {
    if (pixels < 1) fail("bad QOI image geometry");
    uint8_t seen[64][4];
    bool have[64] = {};
    uint8_t prev[4] = {0, 0, 0, 255};
    size_t pos = offset;
    int64_t done = 0;
    auto need = [&](size_t k) {
        if (pos + k > n) fail("QOI op stream is truncated");
    };
    while (done < pixels) {
        need(1);
        const uint8_t b = data[pos++];
        uint8_t v[4];
        if (b == 0xFE) {
            need(3);
            v[0] = data[pos];
            v[1] = data[pos + 1];
            v[2] = data[pos + 2];
            v[3] = prev[3];
            pos += 3;
        } else if (b == 0xFF) {
            need(4);
            std::memcpy(v, data + pos, 4);
            pos += 4;
        } else if ((b >> 6) == 0) {
            const int i = b & 0x3F;
            if (have[i]) {
                std::memcpy(v, seen[i], 4);
            } else {
                std::memset(v, 0, 4);
            }
        } else if ((b >> 6) == 1) {
            v[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
            v[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
            v[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
            v[3] = prev[3];
        } else if ((b >> 6) == 2) {
            need(1);
            const uint8_t b2 = data[pos++];
            const int dg = (b & 0x3F) - 32;
            v[0] = static_cast<uint8_t>(prev[0] + dg + ((b2 >> 4) - 8));
            v[1] = static_cast<uint8_t>(prev[1] + dg);
            v[2] = static_cast<uint8_t>(prev[2] + dg + ((b2 & 0x0F) - 8));
            v[3] = prev[3];
        } else {                                     // run
            for (int k = (b & 0x3F) + 1; k > 0 && done < pixels; --k)
                std::memcpy(out + 4 * done++, prev, 4);
            continue;
        }
        std::memcpy(prev, v, 4);
        const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
        std::memcpy(seen[h], v, 4);
        have[h] = true;
        std::memcpy(out + 4 * done++, v, 4);
    }
}

uint16_t le16(const uint8_t* p) {
    return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

uint32_t le32(const uint8_t* p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
}

std::string printed(const char* fmt, long a, long b = 0) {
    char buf[160];
    std::snprintf(buf, sizeof buf, fmt, a, b);
    return buf;
}

// The frame chunk buf[0:n] into im [ys][xs], whose bytes the earlier
// chunks left.
void fli_frame(const uint8_t* buf, int64_t n, int64_t xs, int64_t ys,
               uint8_t* im) {
    if (n < 8) fail("FLI frame of fewer than 8 bytes (buffer overrun)");
    if (le16(buf + 4) != 0xF1FA)
        fail(printed("FLI frame chunk of type 0x%04lx, not 0xF1FA "
                     "(unrecognized data stream contents)",
                     le16(buf + 4)));
    const int chunks = le16(buf + 6);
    int64_t ptr = 16, left = n - 16;
    for (int c = 0; c < chunks; ++c) {
        if (left < 10)
            fail(printed("FLI sub-chunk %ld's header past the frame's end "
                         "(buffer overrun)", c));
        int64_t data = ptr + 6;
        const int64_t end = ptr + left;
        const int type = le16(buf + ptr + 4);
        auto need = [&](int64_t k) {
            if (data + k > end)
                fail(printed("FLI sub-chunk %ld of type %ld overruns the "
                             "frame (buffer overrun)", c, type));
        };
        switch (type) {
        case 4:
        case 11:
        case 18:
            break;                          // palettes, the postage stamp
        case 7: {                           // SS2: word deltas
            const int64_t lines = le16(buf + data);
            data += 2;
            int64_t l = 0, y = 0;
            for (; l < lines && y < ys; ++l, ++y) {
                uint8_t* row = im + y * xs;
                need(2);
                int64_t packets = le16(buf + data);
                data += 2;
                while (packets & 0x8000) {
                    if (packets & 0x4000) {
                        y += 65536 - packets;       // lines skipped
                        if (y >= ys)
                            fail("FLI SS2 chunk skips past the last line "
                                 "(buffer overrun)");
                        row = im + y * xs;
                    } else {
                        row[xs - 1] = static_cast<uint8_t>(packets);
                    }
                    need(2);
                    packets = le16(buf + data);
                    data += 2;
                }
                int64_t p = 0, x = 0;
                for (; p < packets; ++p) {
                    need(2);
                    x += buf[data];
                    if (buf[data + 1] >= 128) {
                        need(4);
                        const int64_t i = 256 - buf[data + 1];
                        if (x + 2 * i > xs) break;
                        for (int64_t j = 0; j < i; ++j, x += 2) {
                            row[x] = buf[data + 2];
                            row[x + 1] = buf[data + 3];
                        }
                        data += 4;
                    } else {
                        const int64_t i = 2 * buf[data + 1];
                        if (x + i > xs) break;
                        need(2 + i);
                        std::memcpy(row + x, buf + data + 2, i);
                        data += 2 + i;
                        x += i;
                    }
                }
                if (p < packets) break;
            }
            if (l < lines)
                fail("FLI SS2 chunk's lines overrun the image (buffer "
                     "overrun)");
            break;
        }
        case 12: {                          // LC: byte deltas
            int64_t y = le16(buf + data);
            const int64_t ymax = y + le16(buf + data + 2);
            data += 4;
            for (; y < ymax && y < ys; ++y) {
                uint8_t* row = im + y * xs;
                need(1);
                const int64_t packets = buf[data++];
                int64_t p = 0, x = 0, i = 0;
                for (; p < packets; ++p, x += i) {
                    need(2);
                    x += buf[data];
                    if (buf[data + 1] & 0x80) {
                        i = 256 - buf[data + 1];
                        if (x + i > xs) break;
                        need(3);
                        std::memset(row + x, buf[data + 2], i);
                        data += 3;
                    } else {
                        i = buf[data + 1];
                        if (x + i > xs) break;
                        need(2 + i);
                        std::memcpy(row + x, buf + data + 2, i);
                        data += 2 + i;
                    }
                }
                if (p < packets) break;
            }
            if (y < ymax)
                fail("FLI LC chunk's lines overrun the image (buffer "
                     "overrun)");
            break;
        }
        case 13:                            // BLACK
            std::memset(im, 0, static_cast<size_t>(xs * ys));
            break;
        case 15:                            // BRUN: byte runs
            for (int64_t y = 0; y < ys; ++y) {
                uint8_t* row = im + y * xs;
                data += 1;                  // the line's packet count
                int64_t x = 0, i = 0;
                for (; x < xs; x += i) {
                    need(2);
                    if (buf[data] & 0x80) {
                        i = 256 - buf[data];
                        if (x + i > xs) break;
                        need(1 + i);
                        std::memcpy(row + x, buf + data + 1, i);
                        data += 1 + i;
                    } else {
                        i = buf[data];
                        if (x + i > xs) break;
                        std::memset(row + x, buf[data + 1], i);
                        data += 2;
                    }
                }
                if (x != xs)
                    fail(printed("FLI BRUN chunk's line %ld is not whole "
                                 "(buffer overrun)", y));
            }
            break;
        case 16:                            // COPY
            if (data + xs * ys > end)
                fail("FLI COPY chunk cut short: its image is not in the "
                     "frame (image file is truncated)");
            std::memcpy(im, buf + data, static_cast<size_t>(xs * ys));
            break;
        default:
            fail(printed("FLI sub-chunk of unknown type %ld", type));
        }
        const int32_t advance = static_cast<int32_t>(le32(buf + ptr));
        if (advance == 0)
            fail(printed("FLI sub-chunk %ld of size 0 (broken data "
                         "stream)", c));
        if (advance < 0 || advance > left)
            fail(printed("FLI sub-chunk %ld's size goes past the frame's "
                         "end (buffer overrun)", c));
        ptr += advance;
        left -= advance;
    }
}

// LinS rows from data[offset:] as the row map's lengths say, into out
// [rows * stride].
void msp_rle(const uint8_t* data, int64_t n, int64_t offset,
             const uint16_t* lengths, int64_t rows, int64_t stride,
             uint8_t* out) {
    const int64_t total = rows * stride;
    int64_t pos = offset, got = 0;
    auto put = [&](const uint8_t* src, int64_t k, int fill) {
        const int64_t m = std::min(k, total - got);
        if (m > 0) {
            if (src) std::memcpy(out + got, src, m);
            else std::memset(out + got, fill, m);
        }
        got += k;
    };
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t len = lengths[r];
        if (!len) {
            put(nullptr, stride, 0xFF);
            continue;
        }
        if (pos + len > n)
            fail(printed("Truncated MSP file, expected %ld bytes on row %ld",
                         len, r));
        const uint8_t* row = data + pos;
        pos += len;
        for (int64_t i = 0; i < len;) {
            const int type = row[i++];
            if (!type) {
                if (i + 2 > len)
                    fail(printed("Corrupted MSP file in row %ld", r));
                put(nullptr, row[i], row[i + 1]);
                i += 2;
            } else {
                put(row + i, std::min<int64_t>(type, len - i), 0);
                i += type;
            }
        }
    }
    if (got < total)
        fail(printed("MSP rows decode to %ld of the %ld bytes of the image "
                     "(not enough image data)", got, total));
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

int cge_sgi_rle(const unsigned char* data, long n, int width, int height,
                int bands, int bpc, unsigned char* out, char* err,
                int errlen) {
    return guarded(err, errlen, [&] {
        sgi_rle(data, static_cast<size_t>(n), width, height, bands, bpc,
                out);
    });
}

int cge_pcx_rle(const unsigned char* data, long n, long offset,
                long row_bytes, int rows, unsigned char* out, char* err,
                int errlen) {
    return guarded(err, errlen, [&] {
        pcx_rle(data, static_cast<size_t>(n), static_cast<size_t>(offset),
                static_cast<size_t>(row_bytes), rows, out);
    });
}

int cge_sun_rle(const unsigned char* data, long n, long offset,
                long row_bytes, int rows, unsigned char* out, char* err,
                int errlen) {
    return guarded(err, errlen, [&] {
        sun_rle(data, static_cast<size_t>(n), static_cast<size_t>(offset),
                static_cast<size_t>(row_bytes), rows, out);
    });
}

int cge_qoi(const unsigned char* data, long n, long offset, long pixels,
            unsigned char* out, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        qoi(data, static_cast<size_t>(n), static_cast<size_t>(offset),
            pixels, out);
    });
}

int cge_icns_rle(const unsigned char* data, long n, long offset, long pixels,
                 unsigned char* out, char* err, int errlen) {
    long pos = offset;
    for (int band = 0; band < 3; ++band) {
        unsigned char* dst = out + band * pixels;
        long left = pixels, got = 0;
        bool short_read = false;
        while (left > 0) {
            if (pos >= n) break;
            const int b = data[pos++];
            long size;
            if (b & 0x80) {
                size = b - 125;
                if (pos >= n) {
                    short_read = true;
                } else {
                    const unsigned char v = data[pos++];
                    for (long i = 0; i < size && got + i < pixels; ++i)
                        dst[got + i] = v;
                }
            } else {
                size = b + 1;
                if (pos + size > n) short_read = true;
                const long have = std::min(size, n - pos);
                for (long i = 0; i < have && got + i < pixels; ++i)
                    dst[got + i] = data[pos + i];
                pos += have;
            }
            if (!short_read) got += size;
            left -= size;
        }
        if (left != 0) {
            std::snprintf(err, static_cast<size_t>(errlen),
                          "ICNS run-length channel %d: error reading channel "
                          "[%ld left]", band, left);
            return -1;
        }
        if (short_read) {
            std::snprintf(err, static_cast<size_t>(errlen),
                          "ICNS run-length channel %d: the data end before "
                          "its last run (not enough image data)", band);
            return -1;
        }
    }
    return 0;
}

// ThunderScan: rows of width 4-bit pixels, (width + 1) / 2 bytes each,
// from data[0, n)
int cge_thunder(const unsigned char* data, long n, long width, long rows,
                unsigned char* out, char* err, int errlen) {
    static const int kDelta2[4] = {0, 1, 0, -1};
    static const int kDelta3[8] = {0, 1, 2, 3, 0, -3, -2, -1};
    const long line = (width + 1) / 2;
    long pos = 0;
    for (long row = 0; row < rows; ++row) {
        unsigned char* op0 = out + row * line;
        unsigned char* op = op0;
        unsigned lastpixel = 0;
        long npixels = 0;
        auto set = [&](int v) {
            lastpixel = static_cast<unsigned>(v) & 0xF;
            if (npixels < width) {
                if (npixels++ & 1)
                    *op++ |= static_cast<unsigned char>(lastpixel);
                else
                    op[0] = static_cast<unsigned char>(lastpixel << 4);
            }
        };
        while (pos < n && npixels < width) {
            int c = data[pos++];
            switch (c & 0xC0) {
            case 0x00: {                                  // run
                long k = c & 0x3F;
                if (npixels & 1) {
                    op[0] |= static_cast<unsigned char>(lastpixel);
                    lastpixel = *op++;
                    ++npixels;
                    --k;
                } else {
                    lastpixel |= lastpixel << 4;
                }
                npixels += k;
                if (npixels <= width) {
                    for (; k > 0; k -= 2)
                        *op++ = static_cast<unsigned char>(lastpixel);
                }
                if (k == -1) *--op &= 0xF0;
                lastpixel &= 0xF;
                break;
            }
            case 0x40:                                    // 2-bit deltas
                for (int sh = 4; sh >= 0; sh -= 2) {
                    const int d = (c >> sh) & 3;
                    if (d != 2) set(static_cast<int>(lastpixel) + kDelta2[d]);
                }
                break;
            case 0x80:                                    // 3-bit deltas
                for (int sh = 3; sh >= 0; sh -= 3) {
                    const int d = (c >> sh) & 7;
                    if (d != 4) set(static_cast<int>(lastpixel) + kDelta3[d]);
                }
                break;
            default:                                      // raw
                set(c);
                break;
            }
        }
        if (npixels != width) {
            std::snprintf(err, static_cast<size_t>(errlen),
                          "ThunderScan: %s data at scanline %ld (%ld != %ld)",
                          npixels < width ? "Not enough" : "Too much", row,
                          npixels, width);
            return -1;
        }
    }
    return 0;
}

// XBM: count bytes into out from data[offset] on
int cge_xbm(const unsigned char* data, long n, long offset, long count,
            unsigned char* out, char* err, int errlen) {
    auto hex = [](unsigned char v) -> int {
        return v >= '0' && v <= '9'   ? v - '0'
               : v >= 'a' && v <= 'f' ? v - 'a' + 10
               : v >= 'A' && v <= 'F' ? v - 'A' + 10
                                      : 0;
    };
    long pos = offset, k = 0;
    while (k < count) {
        while (pos < n && data[pos] != 'x') ++pos;
        if (n - pos < 3) {
            std::snprintf(err, static_cast<size_t>(errlen),
                          "XBM data end after %ld of the %ld bytes of its "
                          "rows (image file is truncated)", k, count);
            return -1;
        }
        out[k++] = static_cast<unsigned char>((hex(data[pos + 1]) << 4) +
                                              hex(data[pos + 2]));
        pos += 3;
    }
    return 0;
}

int cge_fli_frame(const unsigned char* data, long n, long width, long height,
                  unsigned char* im, char* err, int errlen) {
    return guarded(err, errlen,
                   [&] { fli_frame(data, n, width, height, im); });
}

int cge_msp_rle(const unsigned char* data, long n, long offset,
                const unsigned short* lengths, long rows, long stride,
                unsigned char* out, char* err, int errlen) {
    return guarded(err, errlen, [&] {
        msp_rle(data, n, offset, lengths, rows, stride, out);
    });
}

// IM: width x height samples of bits bits from data[offset, n), as floats
// into out, rows from the bottom
int cge_bit_decode(const unsigned char* data, long n, long offset, long bits,
                   long width, long height, float* out, char* err,
                   int errlen) {
    const uint64_t mask = (uint64_t{1} << bits) - 1;
    uint64_t buffer = 0;
    long count = 0, x = 0, y = height - 1;
    for (long pos = offset; pos < n; ++pos) {
        const uint64_t byte = data[pos];
        buffer |= byte << count;
        count += 8;
        while (count >= bits) {
            const uint64_t v = buffer & mask;
            if (count > 32)
                buffer = byte >> (8 - (count - bits));
            else
                buffer >>= bits;
            count -= bits;
            out[y * width + x] = static_cast<float>(v);
            if (++x >= width) {
                if (--y < 0) return 0;
                x = 0;
                count = 0;
            }
        }
    }
    std::snprintf(err, static_cast<size_t>(errlen),
                  "IM data end after %ld of the %ld samples of its %ld-bit "
                  "rows (image file is truncated)",
                  (height - 1 - y) * width + x, width * height, bits);
    return -1;
}

}  // extern "C"
