/* CPU gold LZSS codec, wire-compatible with Dipperstein lzss-0.6.2 (a
 * copy of tpulc/gold/csrc/lzss_gold.c).
 *
 * Written from the format's observed behavior (reference:
 * cuda-lzss-unknown/lzss-0.6.2/{lzencode.c,lzdecode.c,brute.c,bitfile.c}):
 *
 *   - 4096-byte ring window initialized to spaces (lzencode.c:165),
 *     windowHead starts at 0 and advances per consumed byte.
 *   - Token: flag bit (1 = literal, 0 = match); literal = 8-bit char
 *     MSB-first; match = 12-bit absolute ring offset + 4-bit (length-3).
 *   - Bit order quirk (bitfile.c BitFilePutBitsLE on little-endian
 *     hosts): a 12-bit value V serializes as bits [V7..V0, V11..V8];
 *     the 4-bit length serializes as [L3..L0].  Bytes fill MSB-first;
 *     the final partial byte is zero-padded.
 *   - Match search (brute.c:92): scan ring indices from windowHead,
 *     wrapping, first strictly-longer match wins, capped at 18; the
 *     comparison reads the 18-byte lookahead ring, whose slots beyond
 *     the remaining input hold the bytes consumed 18 positions ago
 *     (or 0 for inputs shorter than 18) — reproduced exactly so this
 *     gold is a bit-exact stand-in for the reference encoder.
 *   - Matches copy from the pre-token window snapshot
 *     (lzdecode.c:205-220 buffers via the lookahead before writing).
 */

#include <stdint.h>
#include <string.h>

#define W 4096
#define MAX_CODED 18
#define MAX_UNCODED 2

typedef struct {
    uint8_t *buf;
    long cap;
    long bytepos;
    int bitpos; /* 0..7, MSB first */
} bitwriter;

static int put_bit(bitwriter *bw, int bit) {
    if (bw->bytepos >= bw->cap) return -1;
    if (bit) bw->buf[bw->bytepos] |= (uint8_t)(0x80u >> bw->bitpos);
    if (++bw->bitpos == 8) { bw->bitpos = 0; bw->bytepos++; }
    return 0;
}

static int put_bits_msb(bitwriter *bw, uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--)
        if (put_bit(bw, (v >> i) & 1)) return -1;
    return 0;
}

typedef struct {
    const uint8_t *buf;
    long nbytes;
    long bytepos;
    int bitpos;
} bitreader;

static int get_bit(bitreader *br) {
    if (br->bytepos >= br->nbytes) return -1;
    int bit = (br->buf[br->bytepos] >> (7 - br->bitpos)) & 1;
    if (++br->bitpos == 8) { br->bitpos = 0; br->bytepos++; }
    return bit;
}

static long get_bits_msb(bitreader *br, int n) {
    long v = 0;
    for (int i = 0; i < n; i++) {
        int b = get_bit(br);
        if (b < 0) return -1;
        v = (v << 1) | b;
    }
    return v;
}

/* Lookahead byte j (0-based) at input position p: the reference's
 * 18-slot ring retains stale bytes past EOF. */
static uint8_t lookahead_at(const uint8_t *in, long n, long p, int j) {
    if (p + j < n) return in[p + j];
    long q = p + j - MAX_CODED;
    return (q >= 0) ? in[q] : 0;
}

long lzss_gold_encode(const uint8_t *in, long n, uint8_t *out, long out_cap) {
    uint8_t window[W];
    memset(window, ' ', W);
    memset(out, 0, (size_t)out_cap);
    bitwriter bw = {out, out_cap, 0, 0};
    long p = 0;            /* input cursor */
    unsigned head = 0;     /* windowHead */

    while (p < n) {
        long remaining = n - p;
        /* brute.c first-longest scan from head around the ring */
        unsigned best_len = 0, best_off = 0;
        unsigned i = head;
        while (1) {
            if (window[i] == lookahead_at(in, n, p, 0)) {
                unsigned j = 1;
                while (window[(i + j) % W] == lookahead_at(in, n, p, (int)j)) {
                    if (j >= MAX_CODED) break;
                    j++;
                }
                if (j > best_len) { best_len = j; best_off = i; }
                if (j >= MAX_CODED) { best_len = MAX_CODED; break; }
            }
            i = (i + 1) % W;
            if (i == head) break;
        }
        if ((long)best_len > remaining) best_len = (unsigned)remaining;

        unsigned toklen;
        if (best_len <= MAX_UNCODED) {
            if (put_bit(&bw, 1)) return -1;
            if (put_bits_msb(&bw, in[p], 8)) return -1;
            toklen = 1;
        } else {
            unsigned adj = best_len - (MAX_UNCODED + 1);
            if (put_bit(&bw, 0)) return -1;
            /* BitFilePutBitsLE order: low byte MSB-first, then high nibble */
            if (put_bits_msb(&bw, best_off & 0xFF, 8)) return -1;
            if (put_bits_msb(&bw, (best_off >> 8) & 0xF, 4)) return -1;
            if (put_bits_msb(&bw, adj, 4)) return -1;
            toklen = best_len;
        }
        for (unsigned k = 0; k < toklen; k++) {
            window[head] = in[p + k];
            head = (head + 1) % W;
        }
        p += toklen;
    }
    return bw.bytepos + (bw.bitpos ? 1 : 0);
}

long lzss_gold_decode(const uint8_t *in, long nbytes, uint8_t *out,
                      long out_cap) {
    uint8_t window[W], tmp[MAX_CODED];
    memset(window, ' ', W);
    bitreader br = {in, nbytes, 0, 0};
    unsigned head = 0;
    long outp = 0;

    while (1) {
        int flag = get_bit(&br);
        if (flag < 0) break;
        if (flag == 1) {
            long c = get_bits_msb(&br, 8);
            if (c < 0) break;
            if (outp >= out_cap) return -1;
            out[outp++] = (uint8_t)c;
            window[head] = (uint8_t)c;
            head = (head + 1) % W;
        } else {
            long lo = get_bits_msb(&br, 8);
            long hi = get_bits_msb(&br, 4);
            long adj = get_bits_msb(&br, 4);
            if (lo < 0 || hi < 0 || adj < 0) break;
            unsigned off = (unsigned)((hi << 8) | lo);
            unsigned len = (unsigned)adj + MAX_UNCODED + 1;
            /* copy from the pre-token snapshot via a temp buffer */
            for (unsigned k = 0; k < len; k++)
                tmp[k] = window[(off + k) % W];
            if (outp + (long)len > out_cap) return -1;
            for (unsigned k = 0; k < len; k++) {
                out[outp++] = tmp[k];
                window[head] = tmp[k];
                head = (head + 1) % W;
            }
        }
    }
    return outp;
}
