// Baseline JPEG decoder of the port (the counterpart of the imageio reads of
// the JAX package): sequential Huffman-coded 8-bit files with 1 or 3
// components and sampling factors of 1 or 2 on each axis, restart intervals,
// tables in any order before each scan, interleaved or not.  It computes as
// libjpeg(-turbo)'s defaults do, so that it gives the same pixels: the
// "islow" integer IDCT (jidctint.c) with its range limit, "fancy"
// (triangular) chroma upsampling (jdsample.c) with the edge rows the main
// controller replicates, and the integer YCbCr -> RGB tables (jdcolor.c).
// Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
// 4-component files are refused, and so are truncated or corrupt data: each
// error returns a nonzero code with a message.
//
// C interface (ctypes):
//   int jpeg_info(const uint8_t* data, long n, int* h, int* w, int* c,
//                 char* err, int err_len);
//   int jpeg_decode(const uint8_t* data, long n, uint8_t* out, long out_len,
//                   char* err, int err_len);
// out is [h, w, c] uint8, c = 1 (grayscale) or 3 (RGB).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
    std::string msg;
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
    char buf[256];
    snprintf(buf, sizeof(buf), fmt, a, b);
    throw Error{buf};
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLookBits = 9;

struct Huffman {
    bool present = false;
    uint8_t vals[256];
    int maxcode[18];
    int mincode[17];
    int valptr[17];
    uint8_t look_len[1 << kLookBits];
    uint8_t look_val[1 << kLookBits];

    void build(const uint8_t* bits, const uint8_t* values, int count) {
        memcpy(vals, values, count);
        memset(look_len, 0, sizeof(look_len));
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            // the codes of length l must fit in l bits (as libjpeg checks)
            // before they fill the lookup tables
            if (bits[l] && code + bits[l] >= (1 << l))
                fail("bad Huffman table (over-subscribed codes of length %d)",
                     l);
            for (int i = 0; i < bits[l]; i++, code++, k++) {
                if (l <= kLookBits) {
                    int lo = code << (kLookBits - l);
                    int hi = (code + 1) << (kLookBits - l);
                    for (int j = lo; j < hi; j++) {
                        look_len[j] = (uint8_t)l;
                        look_val[j] = values[k];
                    }
                }
            }
            maxcode[l] = bits[l] ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        present = true;
    }
};

struct Component {
    int id, h, v, tq;
    int width, height;          // samples of this component (downsampled)
    int bw, bh;                 // blocks, padded to whole MCUs
    int dc_table = 0, ac_table = 0;
    bool seen = false;
    uint16_t quant[64];         // natural order, latched at the first scan
    std::vector<int16_t> coef;  // [bh][bw][64], natural order
    std::vector<uint8_t> plane; // [bh * 8][bw * 8] after the IDCT
};

struct BitReader {
    const uint8_t* d;
    size_t n, pos;
    uint64_t acc = 0;     // left-aligned
    int nbits = 0;
    int fake_bits = 0;    // zero bits appended after a marker
    bool at_marker = false;

    void fill() {
        while (nbits <= 56) {
            uint64_t b = 0;
            if (at_marker) {
                fake_bits += 8;
            } else {
                if (pos >= n) fail("truncated data (entropy-coded segment "
                                   "runs past the end of the file)");
                b = d[pos];
                if (b == 0xFF) {
                    size_t q = pos + 1;
                    while (q < n && d[q] == 0xFF) q++;   // fill bytes
                    if (q >= n) fail("truncated data (entropy-coded segment "
                                     "runs past the end of the file)");
                    if (d[q] == 0x00) {
                        pos = q + 1;
                    } else {
                        at_marker = true;
                        pos = q - 1;        // at the marker's last 0xFF
                        b = 0;
                        fake_bits += 8;
                    }
                } else {
                    pos++;
                }
            }
            acc |= b << (56 - nbits);
            nbits += 8;
        }
    }

    int bits(int k) {   // k in 1..16
        if (nbits < k) fill();
        int v = (int)(acc >> (64 - k));
        acc <<= k;
        nbits -= k;
        return v;
    }

    int decode(const Huffman& h) {
        if (nbits < 16) fill();
        int look = (int)(acc >> (64 - kLookBits));
        int l = h.look_len[look];
        if (l) {
            acc <<= l;
            nbits -= l;
            return h.look_val[look];
        }
        for (l = kLookBits + 1; l <= 16; l++) {
            int code = (int)(acc >> (64 - l));
            if (code <= h.maxcode[l]) {
                acc <<= l;
                nbits -= l;
                return h.vals[h.valptr[l] + code - h.mincode[l]];
            }
        }
        fail("corrupt data (bad Huffman code)");
    }

    // zero bits read past a marker mean the segment ended early
    void check() const {
        if (nbits < fake_bits) fail("corrupt or truncated data (a scan "
                                    "ends before its last block)");
    }

    void reset() {
        acc = 0;
        nbits = 0;
        fake_bits = 0;
        at_marker = false;
    }
};

inline int extend(int v, int t) {
    return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

struct Decoder {
    const uint8_t* d;
    size_t n, pos = 0;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int mcux = 0, mcuy = 0;
    int restart_interval = 0;
    bool frame = false, jfif = false, adobe = false;
    int adobe_transform = -1;
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    Component comp[3];

    int u8() {
        if (pos >= n) fail("truncated data (in a marker segment)");
        return d[pos++];
    }
    int u16() {
        int a = u8();
        return (a << 8) | u8();
    }

    int next_marker() {
        // skips anything up to the next 0xFF, then fill bytes
        while (pos < n && d[pos] != 0xFF) pos++;
        while (pos < n && d[pos] == 0xFF) pos++;
        if (pos >= n) fail("truncated data (no EOI marker)");
        return d[pos++];
    }

    size_t segment_end() {
        int len = u16();
        if (len < 2 || pos - 2 + len > n)
            fail("truncated data (a marker segment of %d bytes)", len);
        return pos - 2 + len;
    }

    void read_sof() {
        size_t end = segment_end();
        if (frame) fail("more than one frame");
        int precision = u8();
        if (precision != 8)
            fail("%d-bit samples are not read (8-bit only)", precision);
        height = u16();
        width = u16();
        ncomp = u8();
        if (height == 0) fail("a height of 0 (DNL) is not read");
        if (width == 0) fail("a width of 0");
        if (ncomp == 4)
            fail("4-component (CMYK or YCCK) files are not read");
        if (ncomp != 1 && ncomp != 3)
            fail("%d components are not read (1 or 3 only)", ncomp);
        for (int i = 0; i < ncomp; i++) {
            Component& c = comp[i];
            c.id = u8();
            int hv = u8();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = u8();
            if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
                fail("sampling factors %dx%d are not read (1 or 2 only)",
                     c.h, c.v);
            if (c.tq > 3) fail("bad quantization table id %d", c.tq);
            if (c.h > hmax) hmax = c.h;
            if (c.v > vmax) vmax = c.v;
        }
        if (ncomp == 1) {   // one component: its blocks are the MCUs
            comp[0].h = comp[0].v = hmax = vmax = 1;
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; i++) {
            Component& c = comp[i];
            c.width = (width * c.h + hmax - 1) / hmax;
            c.height = (height * c.v + vmax - 1) / vmax;
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        }
        if (pos != end) fail("bad SOF segment length");
        frame = true;
    }

    void read_dqt() {
        size_t end = segment_end();
        while (pos < end) {
            int pq = u8();
            int id = pq & 15, prec = pq >> 4;
            if (id > 3 || prec > 1) fail("bad DQT table %d", pq);
            for (int k = 0; k < 64; k++) {
                int q = prec ? u16() : u8();
                qt[id][kZigzag[k]] = (uint16_t)q;
            }
            qt_present[id] = true;
        }
        if (pos != end) fail("bad DQT segment length");
    }

    void read_dht() {
        size_t end = segment_end();
        while (pos < end) {
            int tc = u8();
            int cls = tc >> 4, id = tc & 15;
            if (cls > 1 || id > 3) fail("bad DHT table %d", tc);
            uint8_t bits[17] = {0};
            int count = 0;
            for (int l = 1; l <= 16; l++) {
                bits[l] = (uint8_t)u8();
                count += bits[l];
            }
            if (count > 256 || pos + count > end)
                fail("bad DHT table of %d codes", count);
            (cls ? ac[id] : dc[id]).build(bits, d + pos, count);
            pos += count;
        }
        if (pos != end) fail("bad DHT segment length");
    }

    void read_app(int marker) {
        size_t end = segment_end();
        size_t len = end - pos;
        if (marker == 0xE0 && len >= 5 && memcmp(d + pos, "JFIF\0", 5) == 0)
            jfif = true;
        if (marker == 0xEE && len >= 12 && memcmp(d + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[pos + 11];
        }
        pos = end;
    }

    void decode_block(BitReader& br, Component& c, int* pred, int bx,
                      int by) {
        int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
        const Huffman& hd = dc[c.dc_table];
        const Huffman& ha = ac[c.ac_table];
        int t = br.decode(hd);
        if (t > 11) fail("corrupt data (a DC difference of %d bits)", t);
        int diff = t ? extend(br.bits(t), t) : 0;
        *pred += diff;
        blk[0] = (int16_t)*pred;
        for (int k = 1; k < 64; k++) {
            int rs = br.decode(ha);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) fail("corrupt data (a run past the block)");
                if (s > 10) fail("corrupt data (an AC value of %d bits)", s);
                blk[kZigzag[k]] = (int16_t)extend(br.bits(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void read_sos() {
        size_t end = segment_end();
        if (!frame) fail("a scan before the frame header");
        int ns = u8();
        if (ns < 1 || ns > ncomp) fail("a scan of %d components", ns);
        Component* sc[3];
        for (int i = 0; i < ns; i++) {
            int id = u8(), tables = u8();
            Component* c = nullptr;
            for (int j = 0; j < ncomp; j++)
                if (comp[j].id == id) c = &comp[j];
            if (!c) fail("a scan names component %d of no frame", id);
            c->dc_table = tables >> 4;
            c->ac_table = tables & 15;
            if (c->dc_table > 3 || c->ac_table > 3)
                fail("bad Huffman table ids %d", tables);
            if (!dc[c->dc_table].present || !ac[c->ac_table].present)
                fail("a scan uses an undefined Huffman table");
            if (!c->seen) {   // the quantization table is latched here
                if (!qt_present[c->tq])
                    fail("undefined quantization table %d", c->tq);
                memcpy(c->quant, qt[c->tq], sizeof(c->quant));
                c->seen = true;
            }
            sc[i] = c;
        }
        int ss = u8(), se = u8(), a = u8();
        if (ss != 0 || se != 63 || a != 0)
            fail("spectral selection or successive approximation "
                 "(progressive) is not read");
        if (pos != end) fail("bad SOS segment length");

        BitReader br{d, n, pos};
        int pred[3] = {0, 0, 0};
        int units_x, units_y;
        if (ns == 1) {
            units_x = (sc[0]->width + 7) / 8;
            units_y = (sc[0]->height + 7) / 8;
        } else {
            units_x = mcux;
            units_y = mcuy;
        }
        long total = (long)units_x * units_y;
        int next_rst = 0;
        for (long m = 0; m < total; m++) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                br.check();
                // the restart marker follows the interval's last byte
                size_t q = marker_at(br.pos);
                br.reset();
                if (d[q] != 0xD0 + next_rst)
                    fail("corrupt data (marker 0x%02X where RST%d belongs)",
                         d[q], next_rst);
                br.pos = q + 1;
                next_rst = (next_rst + 1) & 7;
                pred[0] = pred[1] = pred[2] = 0;
            }
            int mx = (int)(m % units_x), my = (int)(m / units_x);
            if (ns == 1) {
                decode_block(br, *sc[0], &pred[0], mx, my);
            } else {
                for (int i = 0; i < ns; i++) {
                    Component& c = *sc[i];
                    for (int by = 0; by < c.v; by++)
                        for (int bx = 0; bx < c.h; bx++)
                            decode_block(br, c, &pred[i], mx * c.h + bx,
                                         my * c.v + by);
                }
            }
        }
        br.check();
        pos = marker_at(br.pos) - 1;   // the scan ends at the next marker
    }

    // the position of the code byte of the first marker at or after q
    // (stuffed 0xFF 0x00 pairs and fill bytes skipped)
    size_t marker_at(size_t q) const {
        for (; q + 1 < n; q++) {
            if (d[q] != 0xFF) continue;
            while (q + 1 < n && d[q + 1] == 0xFF) q++;
            if (q + 1 < n && d[q + 1] != 0x00) return q + 1;
        }
        fail("truncated data (no marker after an entropy-coded segment)");
    }

    // header_only: stop at the frame header (its size and components)
    void parse(bool header_only) {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
        pos = 2;
        for (;;) {
            int m = next_marker();
            if (m == 0xD9) break;                       // EOI
            if (m == 0xC0 || m == 0xC1) {
                read_sof();
                if (header_only) return;
            } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
                fail("progressive JPEG is not read (baseline only)");
            } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
                fail("lossless JPEG is not read (baseline only)");
            } else if (m == 0xC5) {
                fail("hierarchical JPEG is not read (baseline only)");
            } else if (m == 0xC9 || m == 0xCA || m == 0xCC || m == 0xCD) {
                fail("arithmetic-coded JPEG is not read (Huffman only)");
            } else if (m == 0xC4) {
                read_dht();
            } else if (m == 0xDB) {
                read_dqt();
            } else if (m == 0xDD) {
                size_t end = segment_end();
                restart_interval = u16();
                if (pos != end) fail("bad DRI segment length");
            } else if (m == 0xDA) {
                read_sos();
            } else if (m == 0xDC) {
                fail("a DNL marker is not read");
            } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
                read_app(m);
            } else if (m >= 0xD0 && m <= 0xD7) {
                // a stray restart marker carries no segment
            } else {
                pos = segment_end();
            }
        }
        if (!frame) fail("no frame header");
        for (int i = 0; i < ncomp; i++)
            if (!comp[i].seen) fail("component %d has no scan", comp[i].id);
    }

    // --- jidctint.c: jpeg_idct_islow -----------------------------------
    static inline uint8_t range_limit(long x) {
        // libjpeg's post-IDCT table, indexed by x & 1023 (jdmaster.c)
        int t = (int)(x & 1023);
        if (t < 128) return (uint8_t)(t + 128);
        if (t < 512) return 255;
        if (t < 896) return 0;
        return (uint8_t)(t - 896);
    }

    static void idct_islow(const int16_t* in, const uint16_t* q,
                           uint8_t* out, int stride) {
        const long F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                   F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                   F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                   F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
        const int CB = 13, P1 = 2;
        int ws[64];
        for (int c = 0; c < 8; c++) {
            const int16_t* ip = in + c;
            const uint16_t* qp = q + c;
            int* wp = ws + c;
            if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] &&
                !ip[48] && !ip[56]) {
                int dcval = (ip[0] * qp[0]) * (1 << P1);
                for (int k = 0; k < 8; k++) wp[8 * k] = dcval;
                continue;
            }
            long z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
            long z1 = (z2 + z3) * F0_541;
            long tmp2 = z1 + z3 * -F1_847;
            long tmp3 = z1 + z2 * F0_765;
            z2 = ip[0] * qp[0];
            z3 = ip[32] * qp[32];
            long tmp0 = (z2 + z3) * (1L << CB);
            long tmp1 = (z2 - z3) * (1L << CB);
            long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = ip[56] * qp[56];
            tmp1 = ip[40] * qp[40];
            tmp2 = ip[24] * qp[24];
            tmp3 = ip[8] * qp[8];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            long z4 = tmp1 + tmp3;
            long z5 = (z3 + z4) * F1_175;
            tmp0 *= F0_298;
            tmp1 *= F2_053;
            tmp2 *= F3_072;
            tmp3 *= F1_501;
            z1 *= -F0_899;
            z2 *= -F2_562;
            z3 *= -F1_961;
            z4 *= -F0_390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            const int sh = CB - P1;
            const long r = 1L << (sh - 1);
            wp[0] = (int)((tmp10 + tmp3 + r) >> sh);
            wp[56] = (int)((tmp10 - tmp3 + r) >> sh);
            wp[8] = (int)((tmp11 + tmp2 + r) >> sh);
            wp[48] = (int)((tmp11 - tmp2 + r) >> sh);
            wp[16] = (int)((tmp12 + tmp1 + r) >> sh);
            wp[40] = (int)((tmp12 - tmp1 + r) >> sh);
            wp[24] = (int)((tmp13 + tmp0 + r) >> sh);
            wp[32] = (int)((tmp13 - tmp0 + r) >> sh);
        }
        for (int row = 0; row < 8; row++) {
            const int* wp = ws + 8 * row;
            uint8_t* op = out + (size_t)row * stride;
            const int sh = CB + P1 + 3;
            const long r = 1L << (sh - 1);
            if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
                !wp[7]) {
                uint8_t v = range_limit(((long)wp[0] + (1L << (P1 + 2)))
                                        >> (P1 + 3));
                for (int k = 0; k < 8; k++) op[k] = v;
                continue;
            }
            long z2 = wp[2], z3 = wp[6];
            long z1 = (z2 + z3) * F0_541;
            long tmp2 = z1 + z3 * -F1_847;
            long tmp3 = z1 + z2 * F0_765;
            long tmp0 = ((long)wp[0] + wp[4]) * (1L << CB);
            long tmp1 = ((long)wp[0] - wp[4]) * (1L << CB);
            long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = wp[7];
            tmp1 = wp[5];
            tmp2 = wp[3];
            tmp3 = wp[1];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            long z4 = tmp1 + tmp3;
            long z5 = (z3 + z4) * F1_175;
            tmp0 *= F0_298;
            tmp1 *= F2_053;
            tmp2 *= F3_072;
            tmp3 *= F1_501;
            z1 *= -F0_899;
            z2 *= -F2_562;
            z3 *= -F1_961;
            z4 *= -F0_390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            op[0] = range_limit((tmp10 + tmp3 + r) >> sh);
            op[7] = range_limit((tmp10 - tmp3 + r) >> sh);
            op[1] = range_limit((tmp11 + tmp2 + r) >> sh);
            op[6] = range_limit((tmp11 - tmp2 + r) >> sh);
            op[2] = range_limit((tmp12 + tmp1 + r) >> sh);
            op[5] = range_limit((tmp12 - tmp1 + r) >> sh);
            op[3] = range_limit((tmp13 + tmp0 + r) >> sh);
            op[4] = range_limit((tmp13 - tmp0 + r) >> sh);
        }
    }

    void idct_all() {
        for (int i = 0; i < ncomp; i++) {
            Component& c = comp[i];
            int stride = c.bw * 8;
            c.plane.assign((size_t)stride * c.bh * 8, 0);
            for (int by = 0; by < c.bh; by++)
                for (int bx = 0; bx < c.bw; bx++)
                    idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64],
                               c.quant,
                               &c.plane[(size_t)by * 8 * stride + bx * 8],
                               stride);
            std::vector<int16_t>().swap(c.coef);
        }
    }

    // --- jdsample.c: the full-size rows of a component ------------------
    // row y of the output (fancy upsampling where a factor is 2, with the
    // edge rows replicated as jdmainct.c does, box upsampling along a row
    // of 2 samples or fewer, as jinit_upsampler picks)
    void upsampled_row(const Component& c, int y, int* out) const {
        int rh = hmax / c.h, rv = vmax / c.v;
        int stride = c.bw * 8;
        int cw = c.width;
        if (rv == 1) {
            const uint8_t* r0 = &c.plane[(size_t)y * stride];
            if (rh == 1) {
                for (int x = 0; x < width; x++) out[x] = r0[x];
            } else if (cw > 2) {        // h2v1_fancy_upsample
                for (int x = 0; x < width; x++) {
                    int i = x >> 1;
                    int v3 = r0[i] * 3;
                    if (x & 1)
                        out[x] = (i == cw - 1) ? r0[i]
                                               : (v3 + r0[i + 1] + 2) >> 2;
                    else
                        out[x] = (i == 0) ? r0[i] : (v3 + r0[i - 1] + 1) >> 2;
                }
            } else {
                for (int x = 0; x < width; x++) out[x] = r0[x >> 1];
            }
            return;
        }
        int in = y >> 1;
        int v = y & 1;
        int nb = v ? in + 1 : in - 1;
        if (nb < 0) nb = 0;
        if (nb > c.height - 1) nb = c.height - 1;
        const uint8_t* r0 = &c.plane[(size_t)in * stride];
        const uint8_t* r1 = &c.plane[(size_t)nb * stride];
        if (rh == 1) {                  // h1v2_fancy_upsample
            int bias = v ? 2 : 1;
            for (int x = 0; x < width; x++)
                out[x] = (r0[x] * 3 + r1[x] + bias) >> 2;
        } else if (cw > 2) {            // h2v2_fancy_upsample
            for (int x = 0; x < width; x++) {
                int i = x >> 1;
                int cs = r0[i] * 3 + r1[i];
                if (x & 1) {
                    out[x] = (i == cw - 1)
                                 ? (cs * 4 + 7) >> 4
                                 : (cs * 3 + r0[i + 1] * 3 + r1[i + 1] + 7)
                                       >> 4;
                } else {
                    out[x] = (i == 0)
                                 ? (cs * 4 + 8) >> 4
                                 : (cs * 3 + r0[i - 1] * 3 + r1[i - 1] + 8)
                                       >> 4;
                }
            }
        } else {                        // h2v2_upsample (box)
            for (int x = 0; x < width; x++) out[x] = r0[x >> 1];
        }
    }

    bool rgb_colorspace() const {
        // jdapimin.c default_decompress_parms
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }

    void output(uint8_t* out) {
        idct_all();
        std::vector<int> rows(3 * (size_t)width);
        if (ncomp == 1) {
            for (int y = 0; y < height; y++) {
                upsampled_row(comp[0], y, rows.data());
                for (int x = 0; x < width; x++)
                    out[(size_t)y * width + x] = (uint8_t)rows[x];
            }
            return;
        }
        // jdcolor.c build_ycc_rgb_table: 16 fractional bits
        const long ONE_HALF = 1L << 15;
        int cr_r[256], cb_b[256];
        long cr_g[256], cb_g[256];
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = (int)((91881L * x + ONE_HALF) >> 16);    // 1.40200
            cb_b[i] = (int)((116130L * x + ONE_HALF) >> 16);   // 1.77200
            cr_g[i] = -46802L * x;                             // 0.71414
            cb_g[i] = -22554L * x + ONE_HALF;                  // 0.34414
        }
        bool rgb = rgb_colorspace();
        auto clamp = [](int v) {
            return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        };
        int* r0 = rows.data();
        int* r1 = r0 + width;
        int* r2 = r1 + width;
        for (int y = 0; y < height; y++) {
            upsampled_row(comp[0], y, r0);
            upsampled_row(comp[1], y, r1);
            upsampled_row(comp[2], y, r2);
            uint8_t* op = out + (size_t)y * width * 3;
            for (int x = 0; x < width; x++) {
                if (rgb) {
                    op[3 * x] = (uint8_t)r0[x];
                    op[3 * x + 1] = (uint8_t)r1[x];
                    op[3 * x + 2] = (uint8_t)r2[x];
                    continue;
                }
                int yy = r0[x], cb = r1[x], cr = r2[x];
                op[3 * x] = clamp(yy + cr_r[cr]);
                op[3 * x + 1] =
                    clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
                op[3 * x + 2] = clamp(yy + cb_b[cb]);
            }
        }
    }
};

void set_err(char* err, int err_len, const std::string& msg) {
    if (err && err_len > 0) {
        strncpy(err, msg.c_str(), err_len - 1);
        err[err_len - 1] = 0;
    }
}

}  // namespace

extern "C" int jpeg_info(const uint8_t* data, long n, int* h, int* w, int* c,
                         char* err, int err_len) {
    try {
        Decoder dec{data, (size_t)n};
        dec.parse(true);
        *h = dec.height;
        *w = dec.width;
        *c = dec.ncomp;
        return 0;
    } catch (const Error& e) {
        set_err(err, err_len, e.msg);
        return 1;
    } catch (const std::bad_alloc&) {
        set_err(err, err_len, "out of memory");
        return 2;
    }
}

extern "C" int jpeg_decode(const uint8_t* data, long n, uint8_t* out,
                           long out_len, char* err, int err_len) {
    try {
        Decoder dec{data, (size_t)n};
        dec.parse(false);
        if ((long)dec.height * dec.width * dec.ncomp != out_len) {
            set_err(err, err_len, "output buffer of the wrong size");
            return 3;
        }
        dec.output(out);
        return 0;
    } catch (const Error& e) {
        set_err(err, err_len, e.msg);
        return 1;
    } catch (const std::bad_alloc&) {
        set_err(err, err_len, "out of memory");
        return 2;
    }
}
