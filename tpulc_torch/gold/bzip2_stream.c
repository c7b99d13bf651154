/* The .bz2 decoder, run on the host CPU (the bzip2 codec decompresses
 * there, as the reference's cuda-bzip2 does: its GPU only compresses).
 *
 * tpulc_torch's copy of the decoder of tpulc/gold/csrc/bzip2_stream.c
 * (the CRC table, the bit reader, the Huffman tables,
 * `decode_block_data`, `unbwt_unrle` and `bz2_gold_decompress`), with
 * one guard a hostile stream needs: a run of RUNA/RUNB digits longer
 * than any block returns -1 where tpulc's copy shifts `runbit` past 63
 * bits and overflows `runlen`.  Built by tpulc_torch/gold/bzip2.py at
 * first use.
 *
 * Stream format: header BZh<level>, per-block 0x314159265359 magic,
 * CRC, origPtr, symbol map, selectors, delta-coded length tables,
 * 50-symbol groups, MTF + RUNA/RUNB, inverse BWT via the LF walk, then
 * inverse RLE1.
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

/* bzip2's CRC32 (poly 0x04c11db7, MSB-first, init/final 0xffffffff) —
 * the reference decoder verifies each block CRC and the stream's
 * combined CRC (decompress.c); table built on first use. */
static uint32_t crc_tab[256];
static int crc_tab_ready = 0;
static void crc_init(void) {
    if (crc_tab_ready) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i << 24;
        for (int j = 0; j < 8; j++)
            c = (c << 1) ^ ((c & 0x80000000u) ? 0x04c11db7u : 0);
        crc_tab[i] = c;
    }
    crc_tab_ready = 1;
}
static uint32_t crc_update(uint32_t crc, const uint8_t *p, long n) {
    for (long i = 0; i < n; i++)
        crc = (crc << 8) ^ crc_tab[(crc >> 24) ^ p[i]];
    return crc;
}

typedef struct {
    const uint8_t *buf;
    long nbytes;
    long bytepos;
    int bitpos;
} bzreader;

static long rbits(bzreader *r, int n) {
    long v = 0;
    for (int i = 0; i < n; i++) {
        if (r->bytepos >= r->nbytes) return -1;
        v = (v << 1) | ((r->buf[r->bytepos] >> (7 - r->bitpos)) & 1);
        if (++r->bitpos == 8) { r->bitpos = 0; r->bytepos++; }
    }
    return v;
}

#define MAXG 6
#define GSIZE 50
#define MAXSEL (2 + (900000 / GSIZE))
#define MAXALPHA 258

/* canonical decode tables in the bzip2 style */
typedef struct {
    int limit[24], base[24], perm[MAXALPHA], minlen, maxlen;
} htab;

static void build_tab(htab *t, const int *len, int alpha) {
    int mn = 32, mx = 0;
    for (int i = 0; i < alpha; i++) {
        if (len[i] > mx) mx = len[i];
        if (len[i] < mn) mn = len[i];
    }
    t->minlen = mn;
    t->maxlen = mx;
    int pp = 0;
    for (int l = mn; l <= mx; l++)
        for (int i = 0; i < alpha; i++)
            if (len[i] == l) t->perm[pp++] = i;
    int cnt[24];
    memset(cnt, 0, sizeof cnt);
    for (int i = 0; i < alpha; i++) cnt[len[i] + 1]++;
    for (int l = 1; l < 23; l++) cnt[l] += cnt[l - 1];
    for (int l = 0; l < 24; l++) t->base[l] = (l < 23) ? cnt[l] : 0;
    int vec = 0;
    for (int l = mn; l <= mx; l++) {
        vec += cnt[l + 1] - cnt[l];
        t->limit[l] = vec - 1;
        vec <<= 1;
    }
    for (int l = mn + 1; l <= mx; l++)
        t->base[l] = ((t->limit[l - 1] + 1) << 1) - cnt[l];
}

static int read_sym(bzreader *r, const htab *t) {
    int l = t->minlen;
    long v = rbits(r, l);
    if (v < 0) return -1;
    while (l <= t->maxlen && v > t->limit[l]) {
        long b = rbits(r, 1);
        if (b < 0) return -1;
        v = (v << 1) | b;
        l++;
    }
    if (l > t->maxlen) return -1;
    return t->perm[v - t->base[l]];
}

/* decode one block's MTF/RLE2 symbol stream into `block`; returns
 * block length or -1 */
static long decode_block_data(bzreader *r, uint8_t *block, long blockmax,
                              int *origptr_out) {
    long origptr = rbits(r, 24);
    if (origptr < 0) return -1;
    *origptr_out = (int)origptr;

    /* symbol map */
    long used16 = rbits(r, 16);
    if (used16 < 0) return -1;
    uint8_t seq_to_unseq[256];
    int n_in_use = 0;
    for (int i = 0; i < 16; i++) {
        if ((used16 >> (15 - i)) & 1) {
            long m = rbits(r, 16);
            if (m < 0) return -1;
            for (int j = 0; j < 16; j++)
                if ((m >> (15 - j)) & 1)
                    seq_to_unseq[n_in_use++] = (uint8_t)(i * 16 + j);
        }
    }
    if (n_in_use == 0) return -1;
    int alpha = n_in_use + 2;
    int eob = alpha - 1;

    long ngroups = rbits(r, 3);
    long nsel = rbits(r, 15);
    if (ngroups < 2 || ngroups > 6 || nsel < 1) return -1;
    uint8_t sel[MAXSEL + 8];
    uint8_t pos[MAXG];
    for (int i = 0; i < ngroups; i++) pos[i] = (uint8_t)i;
    for (long i = 0; i < nsel; i++) {
        int j = 0;
        while (1) {
            long b = rbits(r, 1);
            if (b < 0) return -1;
            if (!b) break;
            j++;
            if (j >= ngroups) return -1;
        }
        uint8_t v = pos[j];
        memmove(pos + 1, pos, (size_t)j);
        pos[0] = v;
        if (i < MAXSEL) sel[i] = v;
    }

    /* length tables */
    htab tabs[MAXG];
    for (int t = 0; t < ngroups; t++) {
        int len[MAXALPHA];
        long curr = rbits(r, 5);
        if (curr < 0) return -1;
        for (int i = 0; i < alpha; i++) {
            while (1) {
                long b = rbits(r, 1);
                if (b < 0) return -1;
                if (!b) break;
                long d = rbits(r, 1);
                if (d < 0) return -1;
                curr += d ? -1 : 1;
            }
            if (curr < 1 || curr > 20) return -1;
            len[i] = (int)curr;
        }
        build_tab(&tabs[t], len, alpha);
    }

    /* MTF decode with RUNA/RUNB runs */
    uint8_t mtf[256];
    for (int i = 0; i < n_in_use; i++) mtf[i] = (uint8_t)i;
    long nblock = 0;
    long grpcount = 0;
    long selidx = -1;
    const htab *cur = 0;
    long runlen = 0;
    long runbit = 1;
    while (1) {
        if (grpcount == 0) {
            selidx++;
            if (selidx >= nsel || selidx >= MAXSEL) return -1;
            cur = &tabs[sel[selidx]];
            grpcount = GSIZE;
        }
        grpcount--;
        int s = read_sym(r, cur);
        if (s < 0) return -1;
        if (s == eob) break;
        if (s <= 1) {
            if (runbit > blockmax) return -1;
            runlen += (long)(s + 1) * runbit;
            runbit <<= 1;
            continue;
        }
        if (runlen) {
            uint8_t ch = seq_to_unseq[mtf[0]];
            if (nblock + runlen > blockmax) return -1;
            memset(block + nblock, ch, (size_t)runlen);
            nblock += runlen;
            runlen = 0;
            runbit = 1;
        }
        /* s in 2..n_in_use: mtf rank s-1 */
        int j = s - 1;
        uint8_t v = mtf[j];
        memmove(mtf + 1, mtf, (size_t)j);
        mtf[0] = v;
        if (nblock >= blockmax) return -1;
        block[nblock++] = seq_to_unseq[v];
    }
    if (runlen) {
        uint8_t ch = seq_to_unseq[mtf[0]];
        if (nblock + runlen > blockmax) return -1;
        memset(block + nblock, ch, (size_t)runlen);
        nblock += runlen;
    }
    return nblock;
}

/* inverse BWT (LF walk) + inverse RLE1, appending to out */
static long unbwt_unrle(const uint8_t *block, long n, int origptr,
                        uint8_t *out, long outcap, long outpos,
                        int32_t *tt, uint8_t *scratch, long scratchcap) {
    long counts[256];
    memset(counts, 0, sizeof counts);
    for (long i = 0; i < n; i++) counts[block[i]]++;
    long cf[256], acc = 0;
    for (int c = 0; c < 256; c++) { cf[c] = acc; acc += counts[c]; }
    long seen[256];
    memset(seen, 0, sizeof seen);
    for (long i = 0; i < n; i++) {
        uint8_t c = block[i];
        tt[i] = (int32_t)(cf[c] + seen[c]);
        seen[c]++;
    }
    /* backward walk writes last->first; then inverse RLE1 forward */
    long p = origptr;
    /* out needs RLE1 expansion, so decode the BWT order into a
       caller-provided scratch buffer first. */
    if (n > scratchcap) return -1;
    for (long k = 0; k < n; k++) {
        scratch[n - 1 - k] = block[p];
        p = tt[p];
    }
    /* inverse RLE1 */
    long i = 0;
    while (i < n) {
        uint8_t c = scratch[i];
        long run = 1;
        while (i + run < n && run < 4 && scratch[i + run] == c) run++;
        if (run == 4) {
            long extra = (i + 4 < n) ? scratch[i + 4] : 0;
            if (outpos + 4 + extra > outcap) return -2; /* buffer too small */
            memset(out + outpos, c, (size_t)(4 + extra));
            outpos += 4 + extra;
            i += 5;
        } else {
            if (outpos + run > outcap) return -2; /* buffer too small */
            memset(out + outpos, c, (size_t)run);
            outpos += run;
            i += run;
        }
    }
    return outpos;
}

/* Decode a .bz2 stream.  Returns decoded length, or -1 (malformed),
 * -2 (output buffer too small), -3 (block or combined CRC mismatch —
 * the reference decoder's BZ_DATA_ERROR behavior, decompress.c).
 * Reentrant: all block-sized state is heap-allocated per call. */
long bz2_gold_decompress(const uint8_t *in, long n, uint8_t *out,
                         long outcap) {
    bzreader r = {in, n, 0, 0};
    if (rbits(&r, 8) != 'B' || rbits(&r, 8) != 'Z' || rbits(&r, 8) != 'h')
        return -1;
    long level = rbits(&r, 8) - '0';
    if (level < 1 || level > 9) return -1;
    long blockmax = 100000 * level + 16;
    crc_init();
    uint8_t *block = (uint8_t *)malloc((size_t)blockmax);
    int32_t *tt = (int32_t *)malloc((size_t)blockmax * sizeof(int32_t));
    uint8_t *scratch = (uint8_t *)malloc((size_t)blockmax);
    long outpos = 0;
    uint32_t combined = 0;
    long ret = -1;
    if (!block || !tt || !scratch) goto done;
    while (1) {
        long hi = rbits(&r, 24), lo = rbits(&r, 24);
        if (hi < 0 || lo < 0) { ret = -1; goto done; }
        if (hi == 0x177245 && lo == 0x385090) {
            long stored = rbits(&r, 32);
            if (stored < 0 || (uint32_t)stored != combined) {
                ret = -3; goto done;   /* combined CRC mismatch */
            }
            ret = outpos;
            goto done;
        }
        if (hi != 0x314159 || lo != 0x265359) { ret = -1; goto done; }
        long stored_crc = rbits(&r, 32);
        if (stored_crc < 0) { ret = -1; goto done; }
        if (rbits(&r, 1) != 0) { ret = -1; goto done; } /* randomised */
        int origptr = 0;
        long nblock = decode_block_data(&r, block, blockmax, &origptr);
        if (nblock < 0 || origptr >= nblock) { ret = -1; goto done; }
        long prev = outpos;
        outpos = unbwt_unrle(block, nblock, origptr, out, outcap, outpos,
                             tt, scratch, blockmax);
        if (outpos < 0) { ret = outpos; goto done; }
        uint32_t bcrc = ~crc_update(0xffffffffu, out + prev, outpos - prev);
        if (bcrc != (uint32_t)stored_crc) { ret = -3; goto done; }
        combined = ((combined << 1) | (combined >> 31)) ^ bcrc;
    }
done:
    free(block); free(tt); free(scratch);
    return ret;
}
