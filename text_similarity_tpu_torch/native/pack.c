/* First-fit-decreasing placement for sequence packing (data/packing.py).
 *
 * The host-side packer is on the corpus-ingestion hot path (encode of a
 * 1M-document corpus routes through packed encode); the previous pure-
 * Python first-fit scan was O(n * rows) and effectively hung at 1M rows.
 * This is the same placement policy — lowest-indexed row with free space
 * >= len, else a new row — found in O(log n) per sequence with a segment
 * tree of per-row free space. Uncreated rows start at full `width`, so
 * "first fit else new row" is a single leftmost-leaf query.
 *
 * Replaces the torch smart-batching dataloader's host-side role
 * (reference src/dataset/dataset.py:386-418) at corpus scale.
 */
#include <stdint.h>
#include <stdlib.h>

/* lens: sequence lengths in placement (longest-first) order, each clamped
 * by the caller to [0, width]. Outputs, all length n:
 *   out_row[i]  — packed row index of sequence i
 *   out_slot[i] — 0-based segment slot within that row
 *   out_off[i]  — token offset within the row
 * Returns number of rows used, or -1 on allocation failure. */
int64_t ffd_place(const int32_t *lens, int64_t n, int32_t width,
                  int32_t *out_row, int32_t *out_slot, int32_t *out_off) {
    if (n <= 0) return 0;
    int64_t P = 1;
    while (P < n) P <<= 1;
    int32_t *tree = (int32_t *)malloc(sizeof(int32_t) * 2 * P);
    int32_t *nseg = (int32_t *)calloc((size_t)n, sizeof(int32_t));
    if (!tree || !nseg) {
        free(tree);
        free(nseg);
        return -1;
    }
    for (int64_t i = 0; i < 2 * P; i++) tree[i] = width;
    int64_t max_row = -1;
    for (int64_t i = 0; i < n; i++) {
        int32_t L = lens[i];
        if (L > width) L = width;
        if (L < 0) L = 0;
        /* leftmost leaf with free space >= L */
        int64_t node = 1;
        while (node < P) {
            node <<= 1;
            if (tree[node] < L) node |= 1;
        }
        int64_t row = node - P;
        int32_t freev = tree[node];
        out_row[i] = (int32_t)row;
        out_slot[i] = nseg[row];
        out_off[i] = width - freev;
        nseg[row] += 1;
        tree[node] = freev - L;
        for (node >>= 1; node >= 1; node >>= 1) {
            int32_t l = tree[2 * node], r = tree[2 * node + 1];
            tree[node] = l > r ? l : r;
        }
        if (row > max_row) max_row = row;
    }
    free(tree);
    free(nseg);
    return max_row + 1;
}
