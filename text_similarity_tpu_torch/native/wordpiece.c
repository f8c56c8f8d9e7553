/* Native WordPiece matcher — the host-side tokenization hot loop.
 *
 * Role parity with the reference's native tokenization dependencies (MeCab
 * C library, utils/tokenizers.py:1-12; HF fast tokenizers' Rust core):
 * tokenization stays a CPU concern in a TPU pipeline (SURVEY.md §2.1), and
 * at 1M-sentence corpus scale the pure-Python greedy matcher becomes the
 * encode-path bottleneck. This file implements the greedy
 * longest-match-first WordPiece inner loop in C; Unicode normalization and
 * word splitting stay in Python (exact parity with the Python matcher is
 * asserted in tests).
 *
 * Interface (ctypes, no pybind11 — see native/__init__.py):
 *   wp_create(tokens_buf, offsets, n, unk_id)  -> handle
 *   wp_encode_words(handle, words_buf, word_offsets, n_words,
 *                   out_ids, out_ends, max_out) -> n_ids (or -1 overflow)
 *   wp_free(handle)
 *
 * The vocab hash map is open-addressing FNV-1a over length-prefixed keys;
 * continuation pieces are stored with a "##" prefix exactly as in vocab
 * files.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    const char *key;   /* not owned; points into the vocab buffer copy */
    int32_t keylen;
    int32_t id;        /* -1 = empty slot */
} Slot;

typedef struct {
    Slot *slots;
    int64_t capacity;  /* power of two */
    char *buf;         /* owned copy of all token strings */
    int32_t unk_id;
    int32_t max_token_chars;
} Vocab;

static uint64_t fnv1a(const char *s, int32_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (int32_t i = 0; i < n; i++) {
        h ^= (uint8_t)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static int32_t vocab_lookup(const Vocab *v, const char *s, int32_t n) {
    uint64_t mask = (uint64_t)v->capacity - 1;
    uint64_t idx = fnv1a(s, n) & mask;
    for (;;) {
        const Slot *sl = &v->slots[idx];
        if (sl->id == -1) return -1;
        if (sl->keylen == n && memcmp(sl->key, s, (size_t)n) == 0)
            return sl->id;
        idx = (idx + 1) & mask;
    }
}

static void vocab_insert(Vocab *v, const char *s, int32_t n, int32_t id) {
    uint64_t mask = (uint64_t)v->capacity - 1;
    uint64_t idx = fnv1a(s, n) & mask;
    while (v->slots[idx].id != -1) {
        /* last insert wins on duplicates (matches dict semantics) */
        if (v->slots[idx].keylen == n &&
            memcmp(v->slots[idx].key, s, (size_t)n) == 0) {
            v->slots[idx].id = id;
            return;
        }
        idx = (idx + 1) & mask;
    }
    v->slots[idx].key = s;
    v->slots[idx].keylen = n;
    v->slots[idx].id = id;
}

/* tokens_buf: concatenated utf-8 tokens; offsets: n+1 byte offsets */
void *wp_create(const char *tokens_buf, const int64_t *offsets, int64_t n,
                int32_t unk_id, int32_t max_token_chars) {
    Vocab *v = (Vocab *)calloc(1, sizeof(Vocab));
    if (!v) return NULL;
    int64_t cap = 16;
    while (cap < n * 2) cap <<= 1;
    v->capacity = cap;
    v->slots = (Slot *)malloc((size_t)cap * sizeof(Slot));
    if (!v->slots) { free(v); return NULL; }
    for (int64_t i = 0; i < cap; i++) v->slots[i].id = -1;
    int64_t total = offsets[n];
    v->buf = (char *)malloc((size_t)(total > 0 ? total : 1));
    if (!v->buf) { free(v->slots); free(v); return NULL; }
    memcpy(v->buf, tokens_buf, (size_t)total);
    for (int64_t i = 0; i < n; i++) {
        vocab_insert(v, v->buf + offsets[i],
                     (int32_t)(offsets[i + 1] - offsets[i]), (int32_t)i);
    }
    v->unk_id = unk_id;
    v->max_token_chars = max_token_chars;
    return v;
}

void wp_free(void *handle) {
    Vocab *v = (Vocab *)handle;
    if (!v) return;
    free(v->slots);
    free(v->buf);
    free(v);
}

/* greedy longest-match-first wordpiece for one word (bytes, utf-8).
 * scratch must hold >= wlen entries. returns count, or -1 if word maps to
 * UNK (caller emits unk_id), or -2 scratch overflow (impossible: <= wlen).
 */
static int32_t wp_word(const Vocab *v, const char *w, int32_t wlen,
                       int32_t *out) {
    /* continuation candidate buffer: "##" + suffix */
    char cont[1024 + 2];
    if (wlen > 1024 || wlen > v->max_token_chars) return -1;
    int32_t count = 0;
    int32_t start = 0;
    while (start < wlen) {
        int32_t end = wlen;
        int32_t cur = -1;
        while (start < end) {
            int32_t id;
            if (start > 0) {
                cont[0] = '#'; cont[1] = '#';
                memcpy(cont + 2, w + start, (size_t)(end - start));
                id = vocab_lookup(v, cont, end - start + 2);
            } else {
                id = vocab_lookup(v, w, end);
            }
            if (id >= 0) { cur = id; break; }
            /* step back one utf-8 character (skip continuation bytes) */
            end--;
            while (end > start && ((uint8_t)w[end] & 0xC0) == 0x80) end--;
        }
        if (cur < 0) return -1;
        out[count++] = cur;
        start = end;
    }
    return count;
}

/* words_buf: concatenated utf-8 words; word_offsets: n_words+1 offsets.
 * out_ids: token ids; out_ends[i] = #ids after word i (prefix sums).
 * returns total ids, or -1 if max_out exceeded. */
int64_t wp_encode_words(void *handle, const char *words_buf,
                        const int64_t *word_offsets, int64_t n_words,
                        int32_t *out_ids, int64_t *out_ends,
                        int64_t max_out) {
    Vocab *v = (Vocab *)handle;
    int64_t total = 0;
    int32_t scratch[4096];
    for (int64_t i = 0; i < n_words; i++) {
        const char *w = words_buf + word_offsets[i];
        int32_t wlen = (int32_t)(word_offsets[i + 1] - word_offsets[i]);
        int32_t cnt;
        if (wlen > 4096) {
            cnt = -1;
        } else {
            cnt = wp_word(v, w, wlen, scratch);
        }
        if (cnt < 0) {
            if (total + 1 > max_out) return -1;
            out_ids[total++] = v->unk_id;
        } else {
            if (total + cnt > max_out) return -1;
            memcpy(out_ids + total, scratch, (size_t)cnt * sizeof(int32_t));
            total += cnt;
        }
        out_ends[i] = total;
    }
    return total;
}

/* Marshalling-free batch entry: words are joined with a separator byte
 * (never part of a word — the Python splitter removed whitespace). One
 * Python-side encode + one call. out_ends gets one entry per word, bounded
 * by max_words (the caller-allocated out_ends capacity; a word containing
 * the separator byte splits into extra words, which must NOT write past
 * the buffer). Returns total ids; n_words written to *out_n_words;
 * -1 on id-buffer overflow; -2 on word-count overflow. */
int64_t wp_encode_joined(void *handle, const char *buf, int64_t buf_len,
                         char sep, int32_t *out_ids, int64_t *out_ends,
                         int64_t max_out, int64_t max_words,
                         int64_t *out_n_words) {
    Vocab *v = (Vocab *)handle;
    int64_t total = 0;
    int64_t n_words = 0;
    int32_t scratch[4096];
    int64_t start = 0;
    for (int64_t i = 0; i <= buf_len; i++) {
        if (i == buf_len || buf[i] == sep) {
            int64_t wlen = i - start;
            if (wlen > 0) {
                int32_t cnt;
                if (n_words + 1 > max_words) return -2;
                cnt = (wlen > 4096)
                    ? -1
                    : wp_word(v, buf + start, (int32_t)wlen, scratch);
                if (cnt < 0) {
                    if (total + 1 > max_out) return -1;
                    out_ids[total++] = v->unk_id;
                } else {
                    if (total + cnt > max_out) return -1;
                    memcpy(out_ids + total, scratch,
                           (size_t)cnt * sizeof(int32_t));
                    total += cnt;
                }
                out_ends[n_words++] = total;
            }
            start = i + 1;
        }
    }
    *out_n_words = n_words;
    return total;
}

/* ------------------------------------------------------------------ */
/* Parallel padded-batch encoding — the host data-loader hot path.
 *
 * One call tokenizes a whole document batch into ready-to-ship
 * (n_docs, max_len) id/mask arrays: whitespace split + punctuation
 * isolation + greedy wordpiece + [CLS]/[SEP]/pad, fanned out over
 * pthreads (each thread owns a disjoint doc range, so no locking).
 *
 * The C path is byte-exact with the Python path for pure-ASCII docs
 * (ASCII lowercase == unicode lowercase, NFKC == identity, and
 * python's ([\W_]) splitter on ASCII == runs of [A-Za-z0-9] with every
 * other non-space byte a single-char token). Docs containing any byte
 * >= 0x80 are flagged in needs_python and left pad-filled for the
 * caller to handle with the full-unicode Python path.            */

#include <pthread.h>

static int wp_is_word_byte(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9');
}

static int wp_is_space_byte(unsigned char c) {
    /* python str.split() whitespace within ASCII: \t\n\v\f\r space AND
     * the separator control bytes 0x1c-0x1f (all str.isspace() True) */
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
           c == '\f' || c == '\v' || (c >= 0x1c && c <= 0x1f);
}

typedef struct {
    const Vocab *v;
    const char *buf;
    const int64_t *offs;
    int64_t start, end;
    int32_t max_len, lowercase, max_word_chars;
    int32_t cls_id, sep_id, pad_id;
    int32_t *out_ids;
    int32_t *out_mask;
    int32_t *out_lens;
    unsigned char *needs_py;
    int64_t n_py;   /* per-thread count of python-fallback docs */
} BatchTask;

static void wp_encode_one_doc(const Vocab *v, const char *doc, int64_t len,
                              int32_t max_len, int lower,
                              int32_t max_word_chars,
                              int32_t cls, int32_t sep, int32_t pad,
                              int32_t *row_ids, int32_t *row_mask,
                              int32_t *row_len, unsigned char *needs_py) {
    int64_t i;
    int32_t count = 0, budget = max_len - 2, t, total;
    char word[1024];
    int32_t scratch[4096];

    for (i = 0; i < len; i++) {
        if ((unsigned char)doc[i] >= 0x80) {
            *needs_py = 1;
            for (t = 0; t < max_len; t++) { row_ids[t] = pad; row_mask[t] = 0; }
            *row_len = 0;
            return;
        }
    }
    *needs_py = 0;
    row_ids[0] = cls;
    i = 0;
    while (i < len && count < budget) {
        unsigned char c = (unsigned char)doc[i];
        int32_t wlen = 0, cnt;
        if (wp_is_space_byte(c)) { i++; continue; }
        if (wp_is_word_byte(c)) {
            while (i < len && wp_is_word_byte((unsigned char)doc[i])) {
                if (wlen < 1024) {
                    char ch = doc[i];
                    if (lower && ch >= 'A' && ch <= 'Z') ch += 32;
                    word[wlen] = ch;
                }
                wlen++;
                i++;
            }
            if (wlen > 1024) wlen = -1;     /* over buffer: force UNK */
        } else {
            word[0] = (char)c;
            wlen = 1;
            i++;
        }
        cnt = (wlen < 0 || wlen > max_word_chars)
            ? -1
            : wp_word(v, word, wlen, scratch);
        if (cnt < 0) { scratch[0] = v->unk_id; cnt = 1; }
        for (t = 0; t < cnt && count < budget; t++) {
            row_ids[1 + count] = scratch[t];
            count++;
        }
    }
    row_ids[1 + count] = sep;
    total = count + 2;
    for (t = 0; t < total; t++) row_mask[t] = 1;
    for (t = total; t < max_len; t++) { row_ids[t] = pad; row_mask[t] = 0; }
    *row_len = total;
}

static void *wp_batch_worker(void *arg) {
    BatchTask *task = (BatchTask *)arg;
    int64_t d;
    task->n_py = 0;
    for (d = task->start; d < task->end; d++) {
        wp_encode_one_doc(
            task->v,
            task->buf + task->offs[d],
            task->offs[d + 1] - task->offs[d],
            task->max_len, task->lowercase, task->max_word_chars,
            task->cls_id, task->sep_id, task->pad_id,
            task->out_ids + d * task->max_len,
            task->out_mask + d * task->max_len,
            task->out_lens + d,
            task->needs_py + d);
        task->n_py += task->needs_py[d];
    }
    return NULL;
}

/* Returns the number of docs needing the Python fallback (>=0), or -1 on
 * thread-spawn failure (caller falls back entirely). */
int64_t wp_encode_batch(void *handle, const char *buf,
                        const int64_t *doc_offsets, int64_t n_docs,
                        int32_t max_len, int32_t lowercase,
                        int32_t max_word_chars,
                        int32_t cls_id, int32_t sep_id, int32_t pad_id,
                        int32_t *out_ids, int32_t *out_mask,
                        int32_t *out_lens, unsigned char *needs_python,
                        int32_t n_threads) {
    Vocab *v = (Vocab *)handle;
    if (max_len < 2) return -2;   /* rows need at least [CLS][SEP] */
    BatchTask tasks[64];
    pthread_t threads[64];
    int32_t nt = n_threads, ti;
    int64_t chunk, total_py = 0;
    if (nt < 1) nt = 1;
    if (nt > 64) nt = 64;
    if (nt > n_docs) nt = (int32_t)(n_docs > 0 ? n_docs : 1);
    chunk = (n_docs + nt - 1) / nt;
    for (ti = 0; ti < nt; ti++) {
        tasks[ti].v = v;
        tasks[ti].buf = buf;
        tasks[ti].offs = doc_offsets;
        tasks[ti].start = ti * chunk;
        tasks[ti].end = (ti + 1) * chunk < n_docs ? (ti + 1) * chunk : n_docs;
        tasks[ti].max_len = max_len;
        tasks[ti].lowercase = lowercase;
        tasks[ti].max_word_chars = max_word_chars;
        tasks[ti].cls_id = cls_id;
        tasks[ti].sep_id = sep_id;
        tasks[ti].pad_id = pad_id;
        tasks[ti].out_ids = out_ids;
        tasks[ti].out_mask = out_mask;
        tasks[ti].out_lens = out_lens;
        tasks[ti].needs_py = needs_python;
    }
    if (nt == 1) {
        wp_batch_worker(&tasks[0]);
        return tasks[0].n_py;
    }
    for (ti = 0; ti < nt; ti++) {
        if (pthread_create(&threads[ti], NULL, wp_batch_worker, &tasks[ti])) {
            int32_t tj;
            for (tj = 0; tj < ti; tj++) pthread_join(threads[tj], NULL);
            return -1;
        }
    }
    for (ti = 0; ti < nt; ti++) pthread_join(threads[ti], NULL);
    for (ti = 0; ti < nt; ti++) total_py += tasks[ti].n_py;
    return total_py;
}
