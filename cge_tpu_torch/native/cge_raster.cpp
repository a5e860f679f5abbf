// Byte-serial decoding of the raster formats of model and game asset sets
// for the port's texture loader (cge_tpu_torch/scene/sgi.py, pcx.py, sun.py
// and qoi.py).
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
//     or whose data end first (a read cut short included), is an error.
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

}  // extern "C"
