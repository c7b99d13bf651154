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
 * tpulc_torch's copy of tpulc/gold/csrc/lzp.c (the same bytes on the
 * wire; its decoder keeps the context in a register); built by
 * tpulc_torch/gold/lzp.py at first use.
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

long lzp_gold_encode(const uint8_t *in, long n, uint8_t *out, long cap,
                     int hash_bits, int min_len) {
    if (n < CTX_BYTES + 1) return -1;
    long tsize = 1L << hash_bits;
    int32_t *table = (int32_t *)malloc(tsize * sizeof(int32_t));
    if (!table) return -1;
    memset(table, 0xFF, tsize * sizeof(int32_t));
    long o = 0;
    long p = 0;
    /* first CTX_BYTES bytes are always literal (no context yet) */
    while (p < CTX_BYTES) {
        if (o >= cap) goto fail;
        out[o++] = in[p++];
    }
    while (p < n) {
        uint32_t h = ctx_hash(in + p, hash_bits);
        long q = table[h];
        table[h] = (int32_t)p;
        if (q >= 0) {
            long l = 0;
            long maxl = n - p;
            while (l < maxl && in[q + l] == in[p + l]) l++;
            if (l >= min_len) {
                long v = l - min_len + 1;
                if (o + 6 > cap) goto fail;
                out[o++] = LZP_ESC;
                while (v >= 128) {
                    out[o++] = (uint8_t)(0x80 | (v & 0x7F));
                    v >>= 7;
                }
                out[o++] = (uint8_t)v;
                p += l;
                continue;
            }
            /* predicted state: escape a literal ESC byte */
            if (in[p] == LZP_ESC) {
                if (o + 2 > cap) goto fail;
                out[o++] = LZP_ESC;
                out[o++] = 0x00;
                p++;
                continue;
            }
        }
        if (o >= cap) goto fail;
        out[o++] = in[p++];
    }
    free(table);
    return o;
fail:
    free(table);
    return -1;
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
