/* LZP long-range match preprocessor (native host stage).
 *
 * Role model: libbsc's LZP (`cuda-bsc/libbsc/lzp/lzp.cpp:53-412`) —
 * an order-8 context hash predictor that replaces long repeats with
 * escape-coded lengths, run on the host CPU even in bsc's GPU mode
 * (only the sort transform is offloaded).  tpulc keeps the same
 * arrangement: LZP on host feeding the device block-sorting pipeline.
 *
 * Wire format (tpulc's own): literals pass through verbatim except in
 * "predicted" states (the context hash table has an entry), where the
 * escape byte 0xF2 introduces either an escaped literal (0x00) or a
 * match length as a base-128 varint of (len - min_len + 1).  The
 * decoder reconstructs the same table from decoded output, so no
 * offsets are stored — that is the entire point of LZP.
 *
 * tpulc_torch's copy of tpulc/gold/csrc/lzp.c: the same bytes on the
 * wire, but its encoder decides most steps from a fingerprint kept in the
 * table entry and compares 8 bytes at a time, and its decoder keeps the
 * context in a register; built by tpulc_torch/gold/lzp.py at first use.
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define LZP_ESC 0xF2
#define CTX_BYTES 8

static inline uint32_t ctx_mix(uint64_t x, int hash_bits) {
    return (uint32_t)((x * 0x9E3779B97F4A7C15ull) >> (64 - hash_bits));
}

static inline uint64_t ctx_load(const uint8_t *p) {
    uint64_t x;
    memcpy(&x, p - CTX_BYTES, 8);
    return x;
}

static inline uint32_t ctx_hash(const uint8_t *p, int hash_bits) {
    return ctx_mix(ctx_load(p), hash_bits);
}

/* The context after byte c is appended: on a little-endian host, the
 * value ctx_load reads one byte further on, without reading the bytes
 * just stored. */
static inline uint64_t ctx_push(uint64_t ctx, uint8_t c) {
    return (ctx >> 8) | ((uint64_t)c << 56);
}

/* The encoder's table entry is 32 bits: the position in the low
 * `pos_bits` bits, the bit length of n, so that every position fits and
 * the all-ones entry the table starts as (EMPTY) is no position; above
 * it a fingerprint of the 4 bytes at p + min_len - 4 (the top bits of
 * their multiplicative hash).  A step whose fingerprint differs from
 * its entry's cannot reach min_len, since the two positions differ
 * within their first min_len bytes, so it takes the literal path
 * without reading the earlier position's bytes; only a step whose
 * fingerprint agrees is compared, 8 bytes at a time.  With min_len < 4
 * there is no tail: every fingerprint is 0, and every predicted step is
 * compared.  An EMPTY entry fails the test unless the fingerprint is all
 * ones, so the common step branches neither on EMPTY nor on a match. */
#define EMPTY 0xFFFFFFFFu
#define PREFETCH_AHEAD 8  /* positions: the entry of p + 8 is fetched at p */

static inline uint32_t load32(const uint8_t *p) {
    uint32_t x;
    memcpy(&x, p, 4);
    return x;
}

/* The common prefix of a and b, at most maxl bytes: 8 bytes a word, the
 * first differing byte found from the lowest set bit of their XOR (the
 * lowest-addressed byte on a little-endian host). */
static inline long match_len(const uint8_t *a, const uint8_t *b, long maxl) {
    long l = 0;
    for (; l + 8 <= maxl; l += 8) {
        uint64_t x, y;
        memcpy(&x, a + l, 8);
        memcpy(&y, b + l, 8);
        if (x != y) return l + (__builtin_ctzll(x ^ y) >> 3);
    }
    while (l < maxl && a[l] == b[l]) l++;
    return l;
}

/* `counts`, when not NULL, receives the steps, the predicted steps (the
 * table had an entry), the compared steps and the matches.  The loop
 * counts only the last two, off its hot path: a step advances p by 1 or
 * by its match, and each entry is filled by one unpredicted step, so the
 * rest follow from p, the matched bytes and the table at the end. */
long lzp_gold_encode(const uint8_t *in, long n, uint8_t *out, long cap,
                     int hash_bits, int min_len, int64_t *counts) {
    /* positions are int32 in the decoder's table */
    if (n < CTX_BYTES + 1 || n > INT32_MAX) return -1;
    long tsize = 1L << hash_bits;
    uint32_t *table = (uint32_t *)malloc(tsize * sizeof(uint32_t));
    if (!table) return -1;
    memset(table, 0xFF, tsize * sizeof(uint32_t));  /* EMPTY */
    const int pos_bits = 64 - __builtin_clzll((unsigned long long)n);
    const uint32_t fp_mask = ~(uint32_t)0 << pos_bits;  /* pos_bits <= 31 */
    /* without a tail the 4 bytes before p are read (p >= 8), times 0 */
    const uint32_t fp_mul = min_len >= 4 ? 0x9E3779B1u : 0;
    const long tail = min_len >= 4 ? min_len - 4 : -4;
    const long lim = n - min_len;  /* a match needs p <= lim */
    long checked = 0, matches = 0, matched = 0;
    long o = 0;
    long p = 0;
    /* first CTX_BYTES bytes are always literal (no context yet) */
    while (p < CTX_BYTES) {
        if (o >= cap) goto fail;
        out[o++] = in[p++];
    }
    while (p < n) {
        if (p + PREFETCH_AHEAD <= n)
            __builtin_prefetch(
                &table[ctx_hash(in + p + PREFETCH_AHEAD, hash_bits)], 1);
        uint32_t h = ctx_hash(in + p, hash_bits);
        uint32_t e = table[h];
        uint32_t fp = 0;
        if (p <= lim) fp = (load32(in + p + tail) * fp_mul) & fp_mask;
        table[h] = (uint32_t)p | fp;
        if (p <= lim && (e & fp_mask) == fp && e != EMPTY) {
            checked++;
            long l = match_len(in + (e & ~fp_mask), in + p, n - p);
            if (l >= min_len) {
                long v = l - min_len + 1;
                if (o + 6 > cap) goto fail;
                matches++;
                matched += l;
                out[o++] = LZP_ESC;
                while (v >= 128) {
                    out[o++] = (uint8_t)(0x80 | (v & 0x7F));
                    v >>= 7;
                }
                out[o++] = (uint8_t)v;
                p += l;
                continue;
            }
        }
        /* predicted state: escape a literal ESC byte */
        if (in[p] == LZP_ESC && e != EMPTY) {
            if (o + 2 > cap) goto fail;
            out[o++] = LZP_ESC;
            out[o++] = 0x00;
            p++;
            continue;
        }
        if (o >= cap) goto fail;
        out[o++] = in[p++];
    }
    goto done;
fail:
    o = -1;
done:
    if (counts) {
        /* a step that failed is counted, and not as a match */
        long steps = p < CTX_BYTES ? 0 : p - CTX_BYTES - matched + matches
                                             + (o < 0);
        long filled = 0;
        for (long i = 0; i < tsize; i++) filled += table[i] != EMPTY;
        counts[0] = steps;
        counts[1] = steps - filled;
        counts[2] = checked;
        counts[3] = matches;
    }
    free(table);
    return o;
}

long lzp_gold_decode(const uint8_t *in, long m, uint8_t *out, long cap,
                     int hash_bits, int min_len) {
    if (m < CTX_BYTES) return -1;
    long tsize = 1L << hash_bits;
    int32_t *table = (int32_t *)malloc(tsize * sizeof(int32_t));
    if (!table) return -1;
    memset(table, 0xFF, tsize * sizeof(int32_t));
    long i = 0;
    long p = 0;
    while (p < CTX_BYTES && i < m) {
        if (p >= cap) goto fail;
        out[p++] = in[i++];
    }
    /* The context lives in a register: an 8-byte load across the last
     * eight 1-byte stores would wait for them at every byte, since
     * store-to-load forwarding cannot join several stores. */
    uint64_t ctx = ctx_load(out + p);
    while (i < m) {
        uint32_t h = ctx_mix(ctx, hash_bits);
        long q = table[h];
        table[h] = (int32_t)p;
        uint8_t c = in[i++];
        if (q >= 0 && c == LZP_ESC) {
            if (i >= m) goto fail;
            uint8_t b = in[i++];
            if (b == 0x00) {
                if (p >= cap) goto fail;
                out[p++] = LZP_ESC;
                ctx = ctx_push(ctx, LZP_ESC);
                continue;
            }
            long v = 0;
            int shift = 0;
            while (b & 0x80) {
                v |= (long)(b & 0x7F) << shift;
                shift += 7;
                if (i >= m) goto fail;
                b = in[i++];
            }
            v |= (long)b << shift;
            long l = v - 1 + min_len;
            if (p + l > cap) goto fail;
            /* byte by byte: the source may overlap the destination */
            for (long k = 0; k < l; k++) out[p + k] = out[q + k];
            p += l;
            if (i < m) ctx = ctx_load(out + p);  /* only a next step reads it */
            continue;
        }
        if (p >= cap) goto fail;
        out[p++] = c;
        ctx = ctx_push(ctx, c);
    }
    free(table);
    return p;
fail:
    free(table);
    return -1;
}
