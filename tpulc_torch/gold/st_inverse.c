/* The inverse Schindler transform's serial backward walk, run on the
 * host CPU (the hybrid ST-k decode of the bsc codec).
 *
 * tpulc_torch's copy of `st_gold_inverse` from
 * tpulc/gold/csrc/bzip2_stream.c (the function alone, unchanged); built
 * by tpulc_torch/gold/st_inverse.py at first use.  The caller checks
 * 0 <= idx0 < n first: the walk reads L[idx0] before it checks
 * anything.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- inverse Schindler transform (ST-k) backward walk ----
 *
 * Slots carry left-aligned 64-bit context keys (hi:lo), sorted
 * nondecreasing.  A slot's predecessor context is L[slot] prepended to
 * its first k-1 context bytes — fully known — and equal-full-context
 * slots are position-ordered, so walking positions in DECREASING order
 * and consuming each context group from its end resolves every
 * occurrence exactly (the reason bsc's inverse ST is CPU-side,
 * st.cpp:1029+). */
long st_gold_inverse(const uint8_t *L, long n, const uint32_t *hi,
                     const uint32_t *lo, long idx0, int k, uint8_t *out) {
    if (n <= 0) return 0;
    uint64_t kmask = (k >= 8) ? ~0ull : (~0ull << (8 * (8 - k)));
    int32_t *consumed = (int32_t *)malloc((size_t)n * sizeof(int32_t));
    if (!consumed) return -1;
    memset(consumed, 0, (size_t)n * sizeof(int32_t));
    long cur = idx0;
    for (long t = n - 1; t >= 0; t--) {
        out[t] = L[cur];
        uint64_t key = ((uint64_t)hi[cur] << 32) | lo[cur];
        uint64_t pk = (((uint64_t)L[cur] << 56) | (key >> 8)) & kmask;
        /* find the group [a, b) of slots with key == pk */
        long a = 0, b = n;
        while (a < b) {
            long m = (a + b) >> 1;
            uint64_t km = ((uint64_t)hi[m] << 32) | lo[m];
            if (km < pk) a = m + 1; else b = m;
        }
        long a2 = a, b2 = n;
        while (a2 < b2) {
            long m = (a2 + b2) >> 1;
            uint64_t km = ((uint64_t)hi[m] << 32) | lo[m];
            if (km <= pk) a2 = m + 1; else b2 = m;
        }
        long group_end = a2;
        long slot = group_end - 1 - consumed[a];
        if (slot < a || slot >= group_end) { free(consumed); return -1; }
        consumed[a]++;
        cur = slot;
    }
    free(consumed);
    return n;
}
