/*
 * htscodecs_tpu_torch native host kernels (the port's own copy of the
 * host C runtime of htscodecs_tpu/native/hostkernels.c).
 *
 * Host-side runtime for the batched codec engine: frequency-table
 * construction/parsing and scalar 4-state rANS block coding (16-bit
 * renormalisation, CRAM 3.1 "4x16" layout).  The device path
 * (ops/rans_vmem.py) consumes the tables these produce and runs the
 * batched payload scans on-device; these scalar coders are the host
 * fallback and the oracle's fast twin.
 *
 * Behavioural parity with the reference C library (rANS_static4x16pr.c /
 * rANS_word.h semantics) is bit-exact; the implementation is original:
 * planar tables, no macro pasting, single translation unit, ctypes ABI.
 *
 * Build: gcc -O3 -shared -fPIC -o _hostkernels.so hostkernels.c
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#include <math.h>

#define API __attribute__((visibility("default")))

enum { SHIFT0 = 12, TOT0 = 1 << 12, LBOUND = 1u << 15 };

/* ---------------------------------------------------------------- */
/* big-endian 7-bit varints                                          */

static int vput(uint8_t *p, uint32_t v) {
    int s = 0;
    uint32_t t = v;
    do { s += 7; t >>= 7; } while (t);
    int n = 0;
    while (s) {
        s -= 7;
        p[n++] = ((v >> s) & 0x7f) | (s ? 0x80 : 0);
    }
    return n;
}

static int vget(const uint8_t *p, const uint8_t *end, uint32_t *v) {
    uint32_t acc = 0;
    int n = 0;
    if (p >= end) { *v = 0; return 0; }
    for (;;) {
        uint8_t c = p[n++];
        acc = (acc << 7) | (c & 0x7f);
        if (!(c & 0x80) || p + n >= end) break;
    }
    *v = acc;
    return n;
}

/* ---------------------------------------------------------------- */
/* power-of-two helpers and frequency normalisation                  */

static uint32_t pow2_ceil(uint32_t v) {
    if (!v) return 0;
    v--;
    v |= v >> 1; v |= v >> 2; v |= v >> 4; v |= v >> 8; v |= v >> 16;
    return v + 1;
}

/* Scale counts in F so they sum exactly to tot (largest-symbol
 * adjustment with one retry pass). */
static int norm_freq(uint32_t *F, uint32_t size, uint32_t tot) {
    if (!size) return 0;
    int pass = 0;
    for (;;) {
        uint64_t tr = (((uint64_t)tot << 31) / size) + ((1u << 30) / size);
        uint32_t acc = 0, fmax = 0;
        int imax = 0, j;
        for (j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (fmax < F[j]) { fmax = F[j]; imax = j; }
            F[j] = (uint32_t)(((uint64_t)F[j] * tr) >> 31);
            if (!F[j]) F[j] = 1;
            acc += F[j];
        }
        int64_t adj = (int64_t)tot - acc;
        if (adj > 0) {
            F[imax] += adj;
        } else if (adj < 0) {
            if ((int64_t)F[imax] > -adj && (pass == 1 || F[imax] / 2 >= -adj)) {
                F[imax] += adj;
            } else if (pass < 1) {
                pass++;
                size = acc;
                continue;
            } else {
                adj += F[imax] - 1;
                F[imax] = 1;
                for (j = 0; adj && j < 256; j++) {
                    if (F[j] < 2) continue;
                    int64_t d = F[j] > -adj ? adj : 1 - (int64_t)F[j];
                    F[j] += d;
                    adj -= d;
                }
            }
        }
        return F[imax] > 0 ? 0 : -1;
    }
}

static void norm_shift(uint32_t *F, uint32_t size, uint32_t want) {
    if (!size || size == want) return;
    int sh = 0;
    while (size < want) { size <<= 1; sh++; }
    for (int i = 0; i < 256; i++) F[i] <<= sh;
}

/* ---------------------------------------------------------------- */
/* alphabet / frequency serialisation                                */

static int put_alphabet(uint8_t *p, const uint32_t *F) {
    int n = 0, run = 0, j;
    for (j = 0; j < 256; j++) {
        if (!F[j]) continue;
        if (run) { run--; continue; }
        p[n++] = j;
        if (j && F[j - 1]) {
            int r = j + 1;
            while (r < 256 && F[r]) r++;
            run = r - (j + 1);
            p[n++] = run;
        }
    }
    p[n++] = 0;
    return n;
}

static int get_alphabet(const uint8_t *p, const uint8_t *end, uint32_t *F) {
    memset(F, 0, 256 * sizeof(*F));
    if (p == end) return 0;
    const uint8_t *op = p;
    int run = 0, j = *p++;
    if (p + 2 < end) {
        do {
            F[j] = 1;
            if (!run && j + 1 == *p) { j = p[0]; run = p[1]; p += 2; }
            else if (run) { run--; if (++j > 255) return -1; }
            else j = *p++;
        } while (j && p + 2 < end);
    }
    if (j) {
        do {
            F[j] = 1;
            if (p >= end) return -1;
            if (!run && j + 1 == *p) {
                if (p + 1 >= end) return -1;
                j = p[0]; run = p[1]; p += 2;
            } else if (run) {
                run--; if (++j > 255) return -1;
            } else {
                j = *p++;
            }
        } while (j && p < end);
    }
    return (int)(p - op);
}

static int put_freq0(uint8_t *p, const uint32_t *F) {
    int n = put_alphabet(p, F);
    for (int j = 0; j < 256; j++)
        if (F[j]) n += vput(p + n, F[j]);
    return n;
}

static int get_freq0(const uint8_t *p, const uint8_t *end, uint32_t *F,
                     uint32_t *sum) {
    int n = get_alphabet(p, end, F);
    if (n <= 0) return -1;
    uint32_t tot = 0;
    for (int j = 0; j < 256; j++) {
        if (F[j]) {
            n += vget(p + n, end, &F[j]);
            tot += F[j];
        }
    }
    *sum = tot;
    return n;
}

/* delta row against the order-0 alphabet, zero runs folded */
static int put_freq_row(uint8_t *p, const uint32_t *A, const uint32_t *F) {
    int n = 0, dz = 0;
    for (int j = 0; j < 256; j++) {
        if (!A[j]) continue;
        if (F[j]) {
            if (dz) { n -= dz - 1; p[n++] = dz - 1; }
            dz = 0;
            n += vput(p + n, F[j]);
        } else {
            dz++;
            p[n++] = 0;
        }
    }
    if (dz) { n -= dz - 1; p[n++] = dz - 1; }
    return n;
}

static int get_freq_row(const uint8_t *p, const uint8_t *end,
                        const uint32_t *A, uint32_t *F, uint32_t *sum) {
    int n = 0, dz = 0;
    uint32_t tot = 0;
    memset(F, 0, 256 * sizeof(*F));
    for (int j = 0; j < 256 && p + n < end; j++) {
        if (!A[j]) continue;
        uint32_t f;
        if (dz) {
            f = 0;
            dz--;
        } else {
            if (p + n >= end) return -1;
            n += vget(p + n, end, &f);
            if (!f) {
                if (p + n >= end) return -1;
                dz = p[n++];
            }
        }
        F[j] = f;
        tot += f;
    }
    *sum = tot;
    return n;
}

/* ---------------------------------------------------------------- */
/* entropy estimate for the 10 vs 12 bit order-1 table choice        */

static double logbits(double a) {
    union { double d; int64_t i; } u = { a };
    return (u.i - 4606921278410026770LL) * 1.539095918623324e-16;
}

static int pick_shift(const uint32_t *A, uint32_t (*F)[256],
                      const uint32_t *T, uint32_t *S) {
    double e10 = 0, e12 = 0;
    uint32_t max_tot = 0;
    for (int i = 0; i < 256; i++) {
        if (!A[i]) continue;
        uint32_t cap = pow2_ceil(T[i]);
        int ns = 0, sm10 = 0, sm12 = 0, j;
        for (j = 0; j < 256; j++) {
            if (F[i][j] && cap / F[i][j] > 1024) sm10++;
            if (F[i][j] && cap / F[i][j] > 4096) sm12++;
        }
        double l10 = log(1024 + sm10), l12 = log(4096 + sm12);
        for (j = 0; j < 256; j++) {
            if (!F[i][j]) continue;
            ns++;
            int x = (int)(1024.0 * F[i][j] / T[i]);
            e10 -= F[i][j] * (logbits(x > 1 ? x : 1) - l10);
            x = (int)(4096.0 * F[i][j] / T[i]);
            e12 -= F[i][j] * (logbits(x > 1 ? x : 1) - l12);
            e10 += 4;
            e12 += 6;
        }
        if (ns < 64 && cap > 128) cap /= 2;
        if (cap > 1024) cap /= 2;
        if (cap > 4096) cap = 4096;
        S[i] = cap;
        if (max_tot < cap) max_tot = cap;
    }
    return (e10 / e12 < 1.01 || max_tot <= 1024) ? 10 : 12;
}

/* ---------------------------------------------------------------- */
/* 4-state rANS, 16-bit renorm: scalar coder                         */

typedef struct { uint32_t x[4]; } rstate;

static inline uint16_t *eput(uint32_t *x, uint16_t *wp,
                             uint32_t start, uint32_t freq, int shift) {
    uint32_t v = *x;
    if (v >= ((LBOUND >> shift) << 16) * freq) {
        *--wp = (uint16_t)v;
        v >>= 16;
    }
    *x = (v / freq << shift) + v % freq + start;
    return wp;
}

/* Encode payload (4 LE u32 flushes + renorm words) into out; returns
 * payload byte count.  starts/freqs are planar 256-entry tables. */
static int64_t enc_payload_o0(const uint8_t *in, int64_t n,
                              const uint32_t *starts, const uint32_t *freqs,
                              uint8_t *out, int64_t cap) {
    uint16_t *base = (uint16_t *)malloc(n * 2 + 64), *wp;
    if (!base) return -1;
    wp = base + n + 16;
    uint16_t *end16 = wp;
    uint32_t X[4] = { LBOUND, LBOUND, LBOUND, LBOUND };
    for (int64_t i = n - 1; i >= 0; i--) {
        uint8_t s = in[i];
        wp = eput(&X[i & 3], wp, starts[s], freqs[s], SHIFT0);
    }
    int64_t nw = end16 - wp;
    if (16 + nw * 2 > cap) { free(base); return -1; }
    for (int j = 0; j < 4; j++) {
        uint32_t v = X[j];
        out[j * 4 + 0] = v;
        out[j * 4 + 1] = v >> 8;
        out[j * 4 + 2] = v >> 16;
        out[j * 4 + 3] = v >> 24;
    }
    for (int64_t k = 0; k < nw; k++) {
        out[16 + k * 2] = wp[k] & 0xff;
        out[16 + k * 2 + 1] = wp[k] >> 8;
    }
    free(base);
    return 16 + nw * 2;
}

static int64_t enc_payload_o1(const uint8_t *in, int64_t n,
                              const uint32_t *starts, const uint32_t *freqs,
                              int shift, uint8_t *out, int64_t cap) {
    uint16_t *base = (uint16_t *)malloc(n * 2 + 64), *wp;
    if (!base) return -1;
    wp = base + n + 16;
    uint16_t *end16 = wp;
    uint32_t X[4] = { LBOUND, LBOUND, LBOUND, LBOUND };
    int64_t q = n >> 2;

    int lt = in[n - 1];
    for (int64_t i = n - 2; i > 4 * q - 2; i--) {
        int c = in[i];
        wp = eput(&X[3], wp, starts[c * 256 + lt], freqs[c * 256 + lt], shift);
        lt = c;
    }
    int last[4] = { in[q - 1], in[2 * q - 1], in[3 * q - 1], lt };
    for (int64_t k = q - 2; k >= 0; k--) {
        for (int j = 3; j >= 0; j--) {
            int c = in[j * q + k];
            int l = last[j];
            wp = eput(&X[j], wp, starts[c * 256 + l], freqs[c * 256 + l], shift);
            last[j] = c;
        }
    }
    for (int j = 3; j >= 0; j--)
        wp = eput(&X[j], wp, starts[last[j]], freqs[last[j]], shift);

    int64_t nw = end16 - wp;
    if (16 + nw * 2 > cap) { free(base); return -1; }
    for (int j = 0; j < 4; j++) {
        uint32_t v = X[j];
        out[j * 4 + 0] = v;
        out[j * 4 + 1] = v >> 8;
        out[j * 4 + 2] = v >> 16;
        out[j * 4 + 3] = v >> 24;
    }
    for (int64_t k = 0; k < nw; k++) {
        out[16 + k * 2] = wp[k] & 0xff;
        out[16 + k * 2 + 1] = wp[k] >> 8;
    }
    free(base);
    return 16 + nw * 2;
}

/* ---------------------------------------------------------------- */
/* public: order-0 block encode (freq header + payload)              */

/* Worst-case serialised table sizes.  Builders write the header into
 * hdr before measuring it, so callers MUST provide at least this much
 * capacity; the upfront guards below make an undersized buffer a clean
 * error instead of an overflow. */
/* O0 worst case: 256 sym bytes + <=86 run bytes + 256 freq bytes +
 * <=32 second freq bytes (freqs sum to 4096 so few need 2 varint
 * bytes) + marker -- comfortably under 257*3. */
#define HDR_CAP_O0 (257 * 3 + 16)
#define HDR_CAP_O1 (257 * 257 * 3)

API int64_t r16_build_tables_o0(const uint8_t *in, int64_t n,
                                uint8_t *hdr, int64_t hdr_cap,
                                uint32_t *starts, uint32_t *freqs) {
    /* returns header length; fills normalised (start,freq) tables */
    if (hdr_cap < HDR_CAP_O0) return -1;
    uint32_t F[256];
    memset(F, 0, sizeof F);
    for (int64_t i = 0; i < n; i++) F[in[i]]++;
    uint32_t cap = pow2_ceil((uint32_t)n);
    if (cap > TOT0) cap = TOT0;
    if (norm_freq(F, (uint32_t)n, cap) < 0) return -1;
    int hl = put_freq0(hdr, F);
    if (hl > hdr_cap) return -1;
    norm_shift(F, cap, TOT0);
    uint32_t x = 0;
    for (int j = 0; j < 256; j++) {
        starts[j] = x;
        x += F[j];
        freqs[j] = F[j];
    }
    return hl;
}

API int64_t r16_enc_o0(const uint8_t *in, int64_t n,
                       uint8_t *out, int64_t cap) {
    if (n == 0) return 0;
    uint32_t starts[256], freqs[256];
    int64_t hl = r16_build_tables_o0(in, n, out, cap, starts, freqs);
    if (hl < 0) return -1;
    int64_t pl = enc_payload_o0(in, n, starts, freqs, out + hl, cap - hl);
    if (pl < 0) return -1;
    return hl + pl;
}

/* order-1 tables; returns header length (header includes the
 * shift/compressed-marker byte and the possibly rANS-packed rows). */
API int64_t r16_build_tables_o1(const uint8_t *in, int64_t n,
                                uint8_t *hdr, int64_t hdr_cap,
                                uint32_t *starts, uint32_t *freqs,
                                int32_t *shift_out) {
    if (hdr_cap < HDR_CAP_O1) return -1;
    uint32_t (*F)[256] = calloc(256, sizeof(*F));
    uint32_t T[256], A[256], S[256];
    if (!F) return -1;
    memset(T, 0, sizeof T);
    memset(A, 0, sizeof A);
    memset(S, 0, sizeof S);
    memset(starts, 0, 65536 * sizeof(*starts));
    memset(freqs, 0, 65536 * sizeof(*freqs));

    /* order-1 histogram, initial context 0 */
    {
        uint8_t l = 0;
        for (int64_t i = 0; i < n; i++) {
            F[l][in[i]]++;
            T[l]++;
            l = in[i];
        }
    }
    int64_t q = n >> 2;
    F[0][in[q]]++; F[0][in[2 * q]]++; F[0][in[3 * q]]++;
    T[0] += 3;

    for (int64_t i = 0; i < n; i++) A[in[i]] = 1;
    A[0] = 1;

    int hl = 1;
    hl += put_alphabet(hdr + hl, A);

    int shift = pick_shift(A, F, T, S);
    *shift_out = shift;

    for (int i = 0; i < 256; i++) {
        if (!A[i]) continue;
        uint32_t cap = S[i];
        if (shift == 10 && cap > 1024) cap = 1024;
        if (norm_freq(F[i], T[i], cap) < 0) { free(F); return -1; }
        hl += put_freq_row(hdr + hl, A, F[i]);
        norm_shift(F[i], cap, 1u << shift);
        uint32_t x = 0;
        for (int j = 0; j < 256; j++) {
            starts[i * 256 + j] = x;
            x += F[i][j];
            freqs[i * 256 + j] = F[i][j];
        }
    }
    free(F);

    hdr[0] = shift << 4;
    if (hl > 1000) {
        /* try packing the table block itself with order-0 rANS */
        int64_t u_sz = hl - 1;
        uint8_t *cbuf = malloc(u_sz + 1024);
        if (cbuf) {
            int64_t c_sz = r16_enc_o0(hdr + 1, u_sz, cbuf, u_sz + 1024);
            if (c_sz > 0 && c_sz + 6 < hl) {
                uint8_t tmp[16];
                int m = 0;
                tmp[m++] = hdr[0] | 1;
                m += vput(tmp + m, (uint32_t)u_sz);
                m += vput(tmp + m, (uint32_t)c_sz);
                memcpy(hdr, tmp, m);
                memcpy(hdr + m, cbuf, c_sz);
                hl = m + c_sz;
            }
            free(cbuf);
        }
    }
    if (hl > hdr_cap) return -1;
    return hl;
}

/* ---------------------------------------------------------------- */
/* rANS 4x8 (CRAM 3.0) dense table builders.  Bit-exact ports of the
 * models/rans4x8.py builders (themselves golden-tested against
 * rANS_static.c:106-133,461-543): u64 fixed-point O0 normalisation
 * and DOUBLE-arithmetic per-row O1 normalisation, both with the *0.98
 * retry, plus the interleaved [sym][run?][freq] table serialiser. */

static int put_freq8(uint8_t *p, uint32_t f) {
    if (f < 128) { p[0] = (uint8_t)f; return 1; }
    p[0] = (uint8_t)(128 | (f >> 8));
    p[1] = (uint8_t)(f & 0xFF);
    return 2;
}

typedef struct { uint8_t *out; int64_t pos; int rle; } twriter;

static void tw_put_sym(twriter *w, int j, const uint32_t *present) {
    if (w->rle) { w->rle--; return; }
    w->out[w->pos++] = (uint8_t)j;
    if (j && present[j - 1]) {
        int run = j + 1;
        while (run < 256 && present[run]) run++;
        w->rle = run - (j + 1);
        w->out[w->pos++] = (uint8_t)w->rle;
    }
}

static void r8_norm_o0(uint32_t *F, int64_t n) {
    uint64_t tr = (((uint64_t)4096 << 31) / (uint64_t)n)
        + ((uint64_t)(1u << 30) / (uint64_t)n);
    for (;;) {
        uint32_t fsum = 0, m = 0;
        int M = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (m < F[j]) { m = F[j]; M = j; }
            F[j] = (uint32_t)(((uint64_t)F[j] * tr) >> 31);
            if (!F[j]) F[j] = 1;
            fsum += F[j];
        }
        fsum++;
        if (fsum < 4096) {
            F[M] += 4096 - fsum;
        } else if (fsum - 4096 > F[M] / 2) {
            tr = 2104533975u;
            continue;
        } else {
            F[M] -= fsum - 4096;
        }
        break;
    }
}

static void r8_norm_o1_row(uint32_t *F, uint32_t T) {
    double p = 4096.0 / (double)T;
    for (;;) {
        uint32_t t2 = 0, m = 0;
        int M = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (m < F[j]) { m = F[j]; M = j; }
            F[j] = (uint32_t)((double)F[j] * p);
            if (!F[j]) F[j] = 1;
            t2 += F[j];
        }
        t2++;
        if (t2 < 4096) {
            F[M] += 4096 - t2;
        } else if (t2 - 4096 >= F[M] / 2) {
            p = 0.98;
            continue;
        } else {
            F[M] -= t2 - 4096;
        }
        break;
    }
}

API int64_t r8_build_tables_o0_dense(const uint8_t *in, int64_t n,
                                     uint8_t *tab, int64_t tab_cap,
                                     uint8_t *alpha_out, int32_t *packed_out,
                                     int32_t max_a, int32_t *a_out) {
    if (n < 1 || tab_cap < 258 * 4) return -1;
    uint32_t F[256];
    memset(F, 0, sizeof F);
    for (int64_t i = 0; i < n; i++) F[in[i]]++;
    r8_norm_o0(F, n);
    uint32_t used[256];
    int a = 0;
    for (int j = 0; j < 256; j++) used[j] = F[j] > 0;
    used[0] = 1;
    for (int j = 0; j < 256; j++) a += used[j] != 0;
    if (a > max_a) return -2;
    *a_out = a;
    twriter w = { tab, 0, 0 };
    uint32_t x = 0;
    int aj = 0;
    for (int j = 0; j < 256; j++) {
        if (used[j]) {
            alpha_out[aj] = (uint8_t)j;
            packed_out[aj] = (int32_t)((x << 13) | F[j]);
            aj++;
        }
        if (F[j]) {
            tw_put_sym(&w, j, F);
            w.pos += put_freq8(w.out + w.pos, F[j]);
            x += F[j];
        }
    }
    tab[w.pos++] = 0;
    return w.pos;
}

API int64_t r8_build_tables_o1_dense(const uint8_t *in, int64_t n,
                                     uint8_t *tab, int64_t tab_cap,
                                     uint8_t *alpha_out, int32_t *packed_out,
                                     int32_t max_a, int32_t *a_out) {
    /* worst case: max_a rows of <=256 [sym freq16] pairs + terminators */
    if (n < 4 || tab_cap < (int64_t)(max_a + 2) * (256 * 4 + 4)) return -1;
    static __thread uint32_t (*F0)[256] = NULL;
    static __thread uint32_t (*F1)[256] = NULL;
    if (!F0) {
        F0 = calloc(256, sizeof(*F0));
        F1 = calloc(256, sizeof(*F1));
        if (!F0 || !F1) { free(F0); F0 = NULL; free(F1); F1 = NULL; return -1; }
    }
    uint32_t T[256], used[256];
    int aidx[256];
    memset(T, 0, sizeof T);
    memset(used, 0, sizeof used);

    {
        int64_t i = 1;
        F0[0][in[0]]++;
        used[in[0]] = 1;
        for (; i + 1 < n; i += 2) {
            F0[in[i - 1]][in[i]]++;
            F1[in[i]][in[i + 1]]++;
            used[in[i]] = 1;
            used[in[i + 1]] = 1;
        }
        for (; i < n; i++) {
            F0[in[i - 1]][in[i]]++;
            used[in[i]] = 1;
        }
    }
    used[0] = 1;
    int a = 0;
    for (int j = 0; j < 256; j++) aidx[j] = used[j] ? a++ : -1;
    /* merge + totals over rows that can be contexts (data bytes + 0) */
    for (int i = 0; i < 256; i++) {
        if (!used[i]) continue;
        uint32_t t = 0;
        for (int j = 0; j < 256; j++) {
            F0[i][j] += F1[i][j];
            t += F0[i][j];
        }
        T[i] = t;
        memset(F1[i], 0, sizeof(F1[i]));
    }
    if (a > max_a) {
        for (int i = 0; i < 256; i++)
            if (used[i]) memset(F0[i], 0, sizeof(F0[i]));
        return -2;
    }
    *a_out = a;
    int64_t q = n >> 2;
    F0[0][in[q]]++; F0[0][in[2 * q]]++; F0[0][in[3 * q]]++;
    T[0] += 3;

    memset(packed_out, 0, (size_t)a * a * sizeof(*packed_out));
    {
        int k = 0;
        for (int j = 0; j < 256; j++)
            if (used[j]) alpha_out[k++] = (uint8_t)j;
    }

    twriter wi = { tab, 0, 0 };
    for (int i = 0; i < 256; i++) {
        if (!used[i]) continue;
        if (!T[i]) { memset(F0[i], 0, sizeof(F0[i])); continue; }
        r8_norm_o1_row(F0[i], T[i]);
        tw_put_sym(&wi, i, T);
        twriter wj = { tab, wi.pos, 0 };
        uint32_t x = 0;
        int32_t *row = packed_out + (int64_t)aidx[i] * a;
        for (int j = 0; j < 256; j++) {
            if (!F0[i][j]) continue;
            tw_put_sym(&wj, j, F0[i]);
            wj.pos += put_freq8(wj.out + wj.pos, F0[i][j]);
            row[aidx[j]] = (int32_t)((x << 13) | F0[i][j]);
            x += F0[i][j];
        }
        wi.pos = wj.pos;
        tab[wi.pos++] = 0;
        memset(F0[i], 0, sizeof(F0[i]));
    }
    tab[wi.pos++] = 0;
    return wi.pos;
}

/* Dense-output variant for the TPU v2 engines: writes the block's
 * sorted alphabet and an (a x a) packed (base << 13 | freq) table
 * directly, skipping the 512 KB sparse (256x256) outputs and the
 * caller-side extraction.  Histogram is 2-way unrolled into two
 * accumulator tables (the bit-exact analogue of the reference's
 * hist1_4, htscodecs/utils.h:137-202).
 * Returns header length; -2 if the alphabet exceeds max_a. */
API int64_t r16_build_tables_o1_dense(const uint8_t *in, int64_t n,
                                      uint8_t *hdr, int64_t hdr_cap,
                                      uint8_t *alpha_out, int32_t *packed_out,
                                      int32_t max_a, int32_t *a_out,
                                      int32_t *shift_out) {
    if (n < 1 || hdr_cap < HDR_CAP_O1) return -1;
    /* thread-local accumulators, cleared per-row after use: avoids a
     * 512 KB calloc per block (a third of the build cost at 64 KiB) */
    static __thread uint32_t (*F0)[256] = NULL;
    static __thread uint32_t (*F1)[256] = NULL;
    if (!F0) {
        F0 = calloc(256, sizeof(*F0));
        F1 = calloc(256, sizeof(*F1));
        if (!F0 || !F1) { free(F0); F0 = NULL; free(F1); F1 = NULL; return -1; }
    }
    uint32_t T[256], A[256], S[256];
    memset(T, 0, sizeof T);
    memset(A, 0, sizeof A);
    memset(S, 0, sizeof S);

    /* order-1 histogram, initial context 0; two tables break the
     * store-to-load dependency chain */
    {
        int64_t i = 1;
        F0[0][in[0]]++;
        A[in[0]] = 1;
        for (; i + 1 < n; i += 2) {
            F0[in[i - 1]][in[i]]++;
            F1[in[i]][in[i + 1]]++;
            A[in[i]] = 1;
            A[in[i + 1]] = 1;
        }
        for (; i < n; i++) {
            F0[in[i - 1]][in[i]]++;
            A[in[i]] = 1;
        }
    }
    A[0] = 1;
    int a = 0;
    for (int i = 0; i < 256; i++) a += A[i];
    if (a > max_a) {
        for (int i = 0; i < 256; i++) {
            if (A[i]) { memset(F0[i], 0, sizeof(F0[i]));
                        memset(F1[i], 0, sizeof(F1[i])); }
        }
        return -2;
    }
    *a_out = a;

    /* merge + row totals over alphabet rows only; clear F1 as we go */
    for (int i = 0; i < 256; i++) {
        if (!A[i]) continue;
        uint32_t t = 0;
        for (int j = 0; j < 256; j++) {
            F0[i][j] += F1[i][j];
            t += F0[i][j];
        }
        T[i] = t;
        memset(F1[i], 0, sizeof(F1[i]));
    }
    int64_t q = n >> 2;
    F0[0][in[q]]++; F0[0][in[2 * q]]++; F0[0][in[3 * q]]++;
    T[0] += 3;

    int hl = 1;
    hl += put_alphabet(hdr + hl, A);
    int shift = pick_shift(A, F0, T, S);
    *shift_out = shift;

    int ai = 0;
    for (int i = 0; i < 256; i++) {
        if (!A[i]) continue;
        alpha_out[ai] = (uint8_t)i;
        uint32_t cap = S[i];
        if (shift == 10 && cap > 1024) cap = 1024;
        if (norm_freq(F0[i], T[i], cap) < 0) {
            for (int k = 0; k < 256; k++)
                if (A[k]) memset(F0[k], 0, sizeof(F0[k]));
            return -1;
        }
        hl += put_freq_row(hdr + hl, A, F0[i]);
        norm_shift(F0[i], cap, 1u << shift);
        uint32_t x = 0;
        int aj = 0;
        int32_t *row = packed_out + (int64_t)ai * a;
        for (int j = 0; j < 256; j++) {
            if (!A[j]) continue;
            row[aj++] = (int32_t)((x << 13) | F0[i][j]);
            x += F0[i][j];
        }
        memset(F0[i], 0, sizeof(F0[i]));
        ai++;
    }

    hdr[0] = shift << 4;
    if (hl > 1000) {
        int64_t u_sz = hl - 1;
        uint8_t *cbuf = malloc(u_sz + 1024);
        if (cbuf) {
            int64_t c_sz = r16_enc_o0(hdr + 1, u_sz, cbuf, u_sz + 1024);
            if (c_sz > 0 && c_sz + 6 < hl) {
                uint8_t tmp[16];
                int m = 0;
                tmp[m++] = hdr[0] | 1;
                m += vput(tmp + m, (uint32_t)u_sz);
                m += vput(tmp + m, (uint32_t)c_sz);
                memcpy(hdr, tmp, m);
                memcpy(hdr + m, cbuf, c_sz);
                hl = m + c_sz;
            }
            free(cbuf);
        }
    }
    if (hl > hdr_cap) return -1;
    return hl;
}

API int64_t r16_enc_o1(const uint8_t *in, int64_t n,
                       uint8_t *out, int64_t cap) {
    if (n < 4) return -1;
    uint32_t *starts = malloc(65536 * sizeof(uint32_t));
    uint32_t *freqs = malloc(65536 * sizeof(uint32_t));
    int32_t shift = 12;
    if (!starts || !freqs) { free(starts); free(freqs); return -1; }
    int64_t hl = r16_build_tables_o1(in, n, out, cap, starts, freqs, &shift);
    int64_t pl = hl < 0 ? -1
        : enc_payload_o1(in, n, starts, freqs, shift, out + hl, cap - hl);
    free(starts);
    free(freqs);
    return pl < 0 ? -1 : hl + pl;
}

/* ---------------------------------------------------------------- */
/* decode                                                            */

static inline uint32_t dget(const uint8_t *p) {
    return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

/* order-0: parse tables into slot LUTs; returns bytes consumed */
API int64_t r16_parse_tables_o0(const uint8_t *in, int64_t n,
                                uint8_t *ssym, uint16_t *sfreq,
                                uint16_t *sbase) {
    uint32_t F[256], sum;
    const uint8_t *end = in + n - 8;
    int hl = get_freq0(in, end, F, &sum);
    if (hl < 0) return -1;
    norm_shift(F, sum, TOT0);
    uint32_t x = 0;
    for (int j = 0; j < 256; j++) {
        if (!F[j]) continue;
        if (F[j] > TOT0 - x) return -1;
        memset(ssym + x, j, F[j]);
        for (uint32_t y = 0; y < F[j]; y++) {
            sfreq[x + y] = F[j];
            sbase[x + y] = y;
        }
        x += F[j];
    }
    if (x != TOT0) return -1;
    return hl;
}

API int64_t r16_dec_o0(const uint8_t *in, int64_t n,
                       uint8_t *out, int64_t out_sz) {
    if (n < 16) return -1;
    static __thread uint8_t ssym[TOT0];
    static __thread uint16_t sfreq[TOT0], sbase[TOT0];
    int64_t hl = r16_parse_tables_o0(in, n, ssym, sfreq, sbase);
    if (hl < 0 || hl + 16 > n) return -1;
    const uint8_t *p = in + hl, *pend = in + n;
    uint32_t X[4];
    for (int j = 0; j < 4; j++) {
        X[j] = dget(p);
        p += 4;
        if (X[j] < LBOUND) return -1;
    }
    for (int64_t i = 0; i < out_sz; i++) {
        uint32_t *x = &X[i & 3];
        uint32_t m = *x & (TOT0 - 1);
        out[i] = ssym[m];
        *x = sfreq[m] * (*x >> SHIFT0) + sbase[m];
        if (*x < LBOUND && p + 1 < pend) {
            *x = (*x << 16) | (p[0] | (p[1] << 8));
            p += 2;
        }
    }
    return out_sz;
}

/* order-1: parse tables; sfb is (256 << shift) u8, fb is 2*65536 u16
 * pairs (freq, base).  Returns payload offset, sets *shift_out. */
API int64_t r16_parse_tables_o1(const uint8_t *in, int64_t n,
                                uint8_t *sfb, uint16_t *f2d, uint16_t *b2d,
                                int32_t *shift_out) {
    if (n < 16) return -1;
    const uint8_t *p = in, *end = in + n;
    int shift = *p >> 4;
    int packed = *p & 1;
    p++;
    if (shift != 10 && shift != 12) return -1;
    *shift_out = shift;
    uint32_t tot = 1u << shift;

    const uint8_t *tp = p, *tend = end;
    uint8_t *ubuf = NULL;
    const uint8_t *resume = NULL;
    if (packed) {
        uint32_t u_sz, c_sz;
        p += vget(p, end, &u_sz);
        p += vget(p, end, &c_sz);
        if ((int64_t)c_sz >= end - p - 16) return -1;
        ubuf = malloc(u_sz);
        if (!ubuf) return -1;
        if (r16_dec_o0(p, c_sz, ubuf, u_sz) < 0) { free(ubuf); return -1; }
        resume = p + c_sz;
        tp = ubuf;
        tend = ubuf + u_sz;
    }

    uint32_t A[256];
    int al = get_alphabet(tp, tend, A);
    if (al <= 0 || tp + al >= tend) { free(ubuf); return -1; }
    tp += al;

    memset(sfb, 0, (size_t)256 << shift);
    memset(f2d, 0, 65536 * sizeof(*f2d));
    memset(b2d, 0, 65536 * sizeof(*b2d));

    for (int i = 0; i < 256; i++) {
        if (!A[i]) continue;
        uint32_t F[256], sum;
        int rl = get_freq_row(tp, tend, A, F, &sum);
        if (rl < 0) { free(ubuf); return -1; }
        tp += rl;
        if (!sum) continue;
        norm_shift(F, sum, tot);
        uint32_t x = 0;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (F[j] > tot - x) { free(ubuf); return -1; }
            memset(sfb + ((size_t)i << shift) + x, j, F[j]);
            f2d[i * 256 + j] = F[j];
            b2d[i * 256 + j] = x;
            x += F[j];
        }
        if (x != tot) { free(ubuf); return -1; }
    }

    int64_t off;
    if (packed) {
        off = resume - in;
        free(ubuf);
    } else {
        off = tp - in;
    }
    return off;
}

/* Dense parse for the TPU v2 decoder: the stored alphabet plus an
 * (a x a) packed (base << 13 | freq) table, no 4096-slot LUT and no
 * sparse (256x256) outputs.  Returns payload offset; -2 if the
 * alphabet exceeds max_a. */
API int64_t r16_parse_tables_o1_dense(const uint8_t *in, int64_t n,
                                      uint8_t *alpha_out, int32_t *packed_out,
                                      int32_t max_a, int32_t *a_out,
                                      int32_t *shift_out) {
    if (n < 16) return -1;
    const uint8_t *p = in, *end = in + n;
    int shift = *p >> 4;
    int packed = *p & 1;
    p++;
    if (shift != 10 && shift != 12) return -1;
    *shift_out = shift;
    uint32_t tot = 1u << shift;

    const uint8_t *tp = p, *tend = end;
    uint8_t *ubuf = NULL;
    const uint8_t *resume = NULL;
    if (packed) {
        uint32_t u_sz, c_sz;
        p += vget(p, end, &u_sz);
        p += vget(p, end, &c_sz);
        if ((int64_t)c_sz >= end - p - 16) return -1;
        ubuf = malloc(u_sz);
        if (!ubuf) return -1;
        if (r16_dec_o0(p, c_sz, ubuf, u_sz) < 0) { free(ubuf); return -1; }
        resume = p + c_sz;
        tp = ubuf;
        tend = ubuf + u_sz;
    }

    uint32_t A[256];
    int al = get_alphabet(tp, tend, A);
    if (al <= 0 || tp + al >= tend) { free(ubuf); return -1; }
    tp += al;

    int aidx[256], a = 0;
    for (int i = 0; i < 256; i++)
        aidx[i] = A[i] ? a++ : -1;
    if (a > max_a) { free(ubuf); return -2; }
    *a_out = a;
    memset(packed_out, 0, (size_t)a * a * sizeof(*packed_out));
    {
        int k = 0;
        for (int i = 0; i < 256; i++)
            if (A[i]) alpha_out[k++] = (uint8_t)i;
    }

    for (int i = 0; i < 256; i++) {
        if (!A[i]) continue;
        uint32_t F[256], sum;
        int rl = get_freq_row(tp, tend, A, F, &sum);
        if (rl < 0) { free(ubuf); return -1; }
        tp += rl;
        if (!sum) continue;
        norm_shift(F, sum, tot);
        uint32_t x = 0;
        int32_t *row = packed_out + (int64_t)aidx[i] * a;
        for (int j = 0; j < 256; j++) {
            if (!F[j]) continue;
            if (F[j] > tot - x) { free(ubuf); return -1; }
            row[aidx[j]] = (int32_t)((x << 13) | F[j]);
            x += F[j];
        }
        if (x != tot) { free(ubuf); return -1; }
    }

    int64_t off;
    if (packed) {
        off = resume - in;
        free(ubuf);
    } else {
        off = tp - in;
    }
    return off;
}

API int64_t r16_dec_o1(const uint8_t *in, int64_t n,
                       uint8_t *out, int64_t out_sz) {
    if (n < 16) return -1;
    uint8_t *sfb = malloc((size_t)256 << 12);
    uint16_t *f2d = malloc(65536 * sizeof(uint16_t));
    uint16_t *b2d = malloc(65536 * sizeof(uint16_t));
    int32_t shift = 12;
    int64_t off = (sfb && f2d && b2d)
        ? r16_parse_tables_o1(in, n, sfb, f2d, b2d, &shift) : -1;
    if (off < 0 || off + 16 > n) { free(sfb); free(f2d); free(b2d); return -1; }

    const uint8_t *p = in + off, *pend = in + n;
    uint32_t X[4];
    int rc = 0;
    for (int j = 0; j < 4; j++) {
        X[j] = dget(p);
        p += 4;
        if (X[j] < LBOUND) rc = -1;
    }
    if (!rc) {
        uint32_t mask = (1u << shift) - 1;
        int64_t q = out_sz >> 2;
        int ctx[4] = { 0, 0, 0, 0 };
        for (int64_t k = 0; k < q; k++) {
            for (int j = 0; j < 4; j++) {
                uint32_t x = X[j];
                uint32_t m = x & mask;
                uint8_t c = sfb[((size_t)ctx[j] << shift) + m];
                out[j * q + k] = c;
                x = f2d[ctx[j] * 256 + c] * (x >> shift) + m
                    - b2d[ctx[j] * 256 + c];
                if (x < LBOUND && p + 1 < pend) {
                    x = (x << 16) | (p[0] | (p[1] << 8));
                    p += 2;
                }
                X[j] = x;
                ctx[j] = c;
            }
        }
        int l3 = ctx[3];
        uint32_t x = X[3];
        for (int64_t i = 4 * q; i < out_sz; i++) {
            uint32_t m = x & mask;
            uint8_t c = sfb[((size_t)l3 << shift) + m];
            out[i] = c;
            x = f2d[l3 * 256 + c] * (x >> shift) + m - b2d[l3 * 256 + c];
            if (x < LBOUND && p + 1 < pend) {
                x = (x << 16) | (p[0] | (p[1] << 8));
                p += 2;
            }
            l3 = c;
        }
    }
    free(sfb); free(f2d); free(b2d);
    return rc ? rc : out_sz;
}

/* ---------------------------------------------------------------- */
/* Encode coding-parameter gather for the batched TPU engine.        */
/* Fills per-step (start, freq) pairs in processing order            */
/* (k = q-2..0, states 3..0; then the 4 context-0 leaders), matching */
/* ops/rans_jax.enc_o1_batch for N % 4 == 0 blocks.                  */

API int64_t r16_gather_params_o1(const uint8_t *in, int64_t n,
                                 const uint32_t *starts,
                                 const uint32_t *freqs,
                                 uint16_t *st_out, uint16_t *fr_out) {
    if (n < 8 || (n & 3)) return -1;
    int64_t q = n >> 2, w = 0;
    for (int64_t k = q - 2; k >= 0; k--) {
        for (int j = 3; j >= 0; j--) {
            int idx = in[j * q + k] * 256 + in[j * q + k + 1];
            st_out[w] = (uint16_t)starts[idx];
            fr_out[w] = (uint16_t)freqs[idx];
            w++;
        }
    }
    for (int j = 3; j >= 0; j--) {
        int idx = in[j * q];
        st_out[w] = (uint16_t)starts[idx];
        fr_out[w] = (uint16_t)freqs[idx];
        w++;
    }
    return w;
}

/* ================================================================ */
/* Adaptive range codec (arith_dynamic / fqzcomp hot loops)          */
/*                                                                   */
/* Carry-counting byte range coder + adaptive approximately-sorted   */
/* frequency models (c_range_coder.h / c_simple_model.h semantics,   */
/* reimplemented with planar runtime-sized models).                  */

typedef struct {
    uint32_t low, range, code, ffnum, cache, carry;
    uint8_t *out;
    int64_t opos, ocap;
    const uint8_t *in;
    int64_t ipos, iend;
    int err;
} rcoder;

static void rc_enc_init(rcoder *rc, uint8_t *out, int64_t cap) {
    memset(rc, 0, sizeof *rc);
    rc->range = 0xFFFFFFFFu;
    rc->out = out;
    rc->ocap = cap;
}

static void rc_shift_low(rcoder *rc) {
    if (rc->low < 0xFF000000u || rc->carry) {
        if (rc->opos + 1 + (int64_t)rc->ffnum > rc->ocap) { rc->err = 1; return; }
        rc->out[rc->opos++] = (uint8_t)(rc->cache + rc->carry);
        while (rc->ffnum) {
            rc->out[rc->opos++] = (uint8_t)(rc->carry - 1);
            rc->ffnum--;
        }
        rc->cache = rc->low >> 24;
        rc->carry = 0;
    } else {
        rc->ffnum++;
    }
    rc->low <<= 8;
}

/* Exact floor(n/d) for d in [1, 65536) without the hardware divide.
 *
 * The two u32 divisions per coded symbol (range/tot here and
 * code/range in the decoders) are the serial critical path of the
 * fqz/arith loops (~25 cycles each on this host, between dependent
 * 3-cycle multiplies).  magic[d] = floor(2^48/d)+1 gives
 * floor(n/d) == (n*magic[d])>>48 exactly for all n < 2^32: the
 * excess e = magic[d]-2^48/d <= 1 contributes n*e/2^48 < 2^-16
 * <= 1/d, which cannot carry frac(n/d) <= 1-1/d across 1.  The
 * reference pays the divides (c_range_coder.h RC_GetFreq/Encode);
 * beating its fqz throughput per VERDICT r2 item 3 starts here. */
static uint64_t rc_magic[65536];

__attribute__((constructor)) static void rc_magic_init(void) {
    for (uint32_t d = 1; d < 65536; d++)
        rc_magic[d] = (uint64_t)((((unsigned __int128)1) << 48) / d) + 1;
}

static inline uint32_t rc_div16(uint32_t n, uint32_t d) {
    return (uint32_t)(((unsigned __int128)n * rc_magic[d]) >> 48);
}

static void rc_encode(rcoder *rc, uint32_t cum, uint32_t freq, uint32_t tot) {
    uint32_t r = tot < 65536 ? rc_div16(rc->range, tot) : rc->range / tot;
    uint32_t old = rc->low;
    rc->range = r;
    rc->low += cum * r;
    rc->carry += rc->low < old;
    rc->range *= freq;
    while (rc->range < (1u << 24)) {
        rc->range <<= 8;
        rc_shift_low(rc);
    }
}

static void rc_enc_finish(rcoder *rc) {
    for (int i = 0; i < 5; i++) rc_shift_low(rc);
}

static void rc_dec_init(rcoder *rc, const uint8_t *in, int64_t pos,
                        int64_t end) {
    memset(rc, 0, sizeof *rc);
    rc->range = 0xFFFFFFFFu;
    rc->in = in;
    rc->ipos = pos;
    rc->iend = end;
    if (pos + 5 >= end) { rc->ipos = end; return; }  /* prevent decode */
    for (int i = 0; i < 5; i++)
        rc->code = (rc->code << 8) | in[rc->ipos++];
}

static void rc_decode(rcoder *rc, uint32_t cum, uint32_t freq) {
    rc->code -= cum * rc->range;
    rc->range *= freq;
    while (rc->range < (1u << 24)) {
        if (rc->ipos >= rc->iend) return;
        rc->code = (rc->code << 8) | rc->in[rc->ipos++];
        rc->range <<= 8;
    }
}

/* Adaptive model: symbol list approximately sorted by frequency with a
 * one-step bubble per use; +16 per hit, halving normalisation above
 * 65519.  The search order is part of the bitstream contract.
 *
 * Interleaved packed entries {cnt u16 | sym u16} in one u32 stream —
 * the split cnt[]/sym[] arrays made every search walk two lines 516 B
 * apart.  e[0] is a permanent cnt=65535 sentinel so the move-to-front
 * swap needs no bound check (cnt never exceeds 65519+16 = 65535, and
 * the swap condition is strict >); e[nsym+1] is a terminal slot the
 * encoder overwrites with the searched symbol so the walk needs no
 * per-iteration bound and stays in-bounds even for symbols absent
 * from the model (rc->err flags that malformed case). */
#define AMODEL_MAXSYM 258
#define AM_CNT(x) ((x) >> 16)
#define AM_SYM(x) ((x) & 0xFFFFu)
typedef struct {
    uint32_t tot;
    int nsym;
    uint32_t e[AMODEL_MAXSYM + 2];
} amodel;

static void am_init(amodel *m, int nsym, int max_sym) {
    m->tot = max_sym;
    m->nsym = nsym;
    m->e[0] = 0xFFFF0000u;                 /* sentinel */
    for (int i = 0; i < nsym; i++)
        m->e[i + 1] = ((uint32_t)(i < max_sym) << 16) | (uint32_t)i;
    m->e[nsym + 1] = 0;                    /* terminal */
}

static void am_renorm(amodel *m) {
    uint32_t tot = 0;
    for (int i = 1; i <= m->nsym; i++) {
        uint32_t c = AM_CNT(m->e[i]);
        if (!c) break;
        c -= c >> 1;
        m->e[i] = (c << 16) | AM_SYM(m->e[i]);
        tot += c;
    }
    m->tot = tot;
}

static void am_encode(amodel *m, rcoder *rc, int symbol) {
    uint32_t sy = (uint32_t)symbol, acc = 0;
    uint32_t *s = m->e + 1, *end = m->e + m->nsym + 1;
    *end = sy;                             /* terminal = search key */
    while (AM_SYM(*s) != sy) acc += *s++ >> 16;
    if (s == end) {          /* symbol absent: fail the coder */
        rc->err = 1;
        return;
    }
    rc_encode(rc, acc, *s >> 16, m->tot);
    *s += 16u << 16;
    m->tot += 16;
    if (m->tot > 65519) am_renorm(m);
    if ((*s >> 16) > (s[-1] >> 16)) {      /* e[0] sentinel guards */
        uint32_t t = s[0]; s[0] = s[-1]; s[-1] = t;
    }
}

static int am_decode(amodel *m, rcoder *rc) {
    /* Division-free search: with r = range/tot and f = code/r, the
     * reference condition acc+c > f (RC_GetFreq + SIMPLE_MODEL
     * decodeSymbol) is exactly (acc+c)*r > code for integer acc+c.
     * This removes the code/r divide from the serial chain; range/tot
     * goes through the rc_div16 magic table.  Entries are 1-based
     * (e[0] is the sentinel). */
    uint32_t tot = m->tot, acc = 0, c;
    int p = 1, n = m->nsym;
    if (tot && rc->range >= tot) {
        uint32_t r = tot < 65536 ? rc_div16(rc->range, tot)
                                 : rc->range / tot;
        uint64_t code = rc->code;
        rc->range = r;
        if (code >= 65520ull * r) return 0;        /* f > 65519 */
        for (;;) {
            c = p <= n ? AM_CNT(m->e[p]) : (p == n + 1 ? 0 : 65519u);
            if ((uint64_t)(acc + c) * r > code) break;
            acc += c;
            if (++p > n + 2) return 0;
        }
    } else {
        /* malformed stream: rc_get_freq would return f=0 and leave
         * range undivided; replicate that path bit for bit. */
        for (;;) {
            c = p <= n ? AM_CNT(m->e[p]) : (p == n + 1 ? 0 : 65519u);
            if (acc + c > 0) break;
            if (++p > n + 2) return 0;
        }
    }
    if (p > n + 1) return 0;
    int symbol = (int)AM_SYM(m->e[p]);
    rc_decode(rc, acc, c);
    m->e[p] += 16u << 16;
    m->tot += 16;
    if (m->tot > 65519) am_renorm(m);
    if (AM_CNT(m->e[p]) > AM_CNT(m->e[p - 1])) {
        uint32_t t = m->e[p]; m->e[p] = m->e[p - 1]; m->e[p - 1] = t;
    }
    return symbol;
}

/* Compact 64-symbol variant of amodel for the fqz quality contexts.
 * 3-byte packed entries {cnt u16 LE, sym u8} keep tot plus the ~20
 * hottest (move-to-front) entries inside ONE cache line: the context
 * arena is 16 MB (65536 x 256 B) and never fits cache, so decode is
 * line-miss bound — the earlier split cnt[64]/sym[64] layout touched
 * two lines per symbol (cnt in line 0, sym at offset 130+).
 * Bitstream behaviour is identical to amodel for any valid stream
 * whose alphabet fits (the frequency-sorted search order and renorm
 * rules are the contract; zero-count tail entries never participate). */
typedef struct {
    uint16_t tot;      /* <= 65535 == 65519 max + one +16 step        */
    uint8_t e[192];    /* 64 x {uint16 cnt LE, uint8 sym}              */
    uint8_t pad[62];   /* exactly 256 B: line-aligned element stride   */
} am64;

static inline uint32_t am64_cnt(const am64 *m, int p) {
    uint16_t c;
    memcpy(&c, m->e + 3 * p, 2);
    return c;
}

static inline void am64_setcnt(am64 *m, int p, uint32_t c) {
    uint16_t v = (uint16_t)c;
    memcpy(m->e + 3 * p, &v, 2);
}

static inline int am64_sym(const am64 *m, int p) {
    return m->e[3 * p + 2];
}

static inline void am64_swap1(am64 *m, int p) {      /* p <-> p-1 */
    uint8_t t[3];
    memcpy(t, m->e + 3 * p, 3);
    memcpy(m->e + 3 * p, m->e + 3 * (p - 1), 3);
    memcpy(m->e + 3 * (p - 1), t, 3);
}

static void am64_renorm(am64 *m) {
    uint32_t tot = 0;
    for (int i = 0; i < 64; i++) {
        uint32_t c = am64_cnt(m, i);
        if (!c) break;
        c -= c >> 1;
        am64_setcnt(m, i, c);
        tot += c;
    }
    m->tot = (uint16_t)tot;
}

static inline void am64_encode(am64 *m, rcoder *rc, int symbol) {
    uint32_t acc = 0;
    int p = 0;
    while (p < 64 && am64_sym(m, p) != symbol) acc += am64_cnt(m, p++);
    if (p >= 64) {        /* inconsistent qmap/max_sym: fail the coder */
        rc->err = 1;
        return;
    }
    uint32_t cp = am64_cnt(m, p);
    rc_encode(rc, acc, cp, m->tot);
    am64_setcnt(m, p, cp + 16);
    m->tot += 16;
    if (m->tot > 65519) am64_renorm(m);
    if (p && am64_cnt(m, p) > am64_cnt(m, p - 1)) am64_swap1(m, p);
}

static inline int am64_decode(am64 *m, rcoder *rc) {
    /* Same division-free search as am_decode (see there); tot is a
     * uint16 so the magic path always applies. */
    uint32_t tot = m->tot, acc = 0, c;
    int p = 0;
    if (tot && rc->range >= tot) {
        uint32_t r = rc_div16(rc->range, tot);
        uint64_t code = rc->code;
        rc->range = r;
        if (code >= 65520ull * r) return 0;        /* f > 65519 */
        for (;;) {
            c = p < 64 ? am64_cnt(m, p) : (p == 64 ? 0 : 65519u);
            if ((uint64_t)(acc + c) * r > code) break;
            acc += c;
            if (++p > 65) return 0;
        }
    } else {
        for (;;) {                       /* rc_get_freq f=0 path */
            c = p < 64 ? am64_cnt(m, p) : (p == 64 ? 0 : 65519u);
            if (acc + c > 0) break;
            if (++p > 65) return 0;
        }
    }
    if (p > 64) return 0;
    int symbol = am64_sym(m, p);
    rc_decode(rc, acc, c);
    am64_setcnt(m, p, c + 16);
    m->tot += 16;
    if (m->tot > 65519) am64_renorm(m);
    if (p && am64_cnt(m, p) > am64_cnt(m, p - 1)) am64_swap1(m, p);
    return symbol;
}

/* ---------------------------------------------------------------- */
/* arith_dynamic entropy payloads: [max_sym byte][range-coded data]  */

static int arith_maxp1(const uint8_t *in, int64_t n) {
    int m = 0;
    for (int64_t i = 0; i < n; i++)
        if (m < in[i]) m = in[i];
    return m + 1;
}

API int64_t arith_enc_o0(const uint8_t *in, int64_t n,
                         uint8_t *out, int64_t cap) {
    int m = arith_maxp1(in, n);
    amodel *md = malloc(sizeof *md);
    if (!md || cap < 1) { free(md); return -1; }
    am_init(md, 256, m);
    out[0] = (uint8_t)m;
    rcoder rc;
    rc_enc_init(&rc, out + 1, cap - 1);
    for (int64_t i = 0; i < n; i++) am_encode(md, &rc, in[i]);
    rc_enc_finish(&rc);
    free(md);
    return rc.err ? -1 : rc.opos + 1;
}

API int64_t arith_dec_o0(const uint8_t *in, int64_t n,
                         uint8_t *out, int64_t out_sz) {
    if (n < 1) return -1;
    int m = in[0] ? in[0] : 256;
    amodel *md = malloc(sizeof *md);
    if (!md) return -1;
    am_init(md, 256, m);
    rcoder rc;
    rc_dec_init(&rc, in, 1, n);
    for (int64_t i = 0; i < out_sz; i++) out[i] = (uint8_t)am_decode(md, &rc);
    free(md);
    return out_sz;
}

API int64_t arith_enc_o1(const uint8_t *in, int64_t n,
                         uint8_t *out, int64_t cap) {
    int m = arith_maxp1(in, n);
    amodel *md = malloc(256 * sizeof *md);
    if (!md || cap < 1) { free(md); return -1; }
    for (int i = 0; i < 256; i++) am_init(&md[i], 256, m);
    out[0] = (uint8_t)m;
    rcoder rc;
    rc_enc_init(&rc, out + 1, cap - 1);
    uint8_t last = 0;
    for (int64_t i = 0; i < n; i++) {
        am_encode(&md[last], &rc, in[i]);
        last = in[i];
    }
    rc_enc_finish(&rc);
    free(md);
    return rc.err ? -1 : rc.opos + 1;
}

API int64_t arith_dec_o1(const uint8_t *in, int64_t n,
                         uint8_t *out, int64_t out_sz) {
    if (n < 1) return -1;
    int m = in[0] ? in[0] : 256;
    amodel *md = malloc(256 * sizeof *md);
    if (!md) return -1;
    for (int i = 0; i < 256; i++) am_init(&md[i], 256, m);
    rcoder rc;
    rc_dec_init(&rc, in, 1, n);
    uint8_t last = 0;
    for (int64_t i = 0; i < out_sz; i++) {
        last = (uint8_t)am_decode(&md[last], &rc);
        out[i] = last;
    }
    free(md);
    return out_sz;
}

/* RLE variants: literal model(s) + 258-symbol run models over an
 * escalating context chain, MAX_RUN = 4. */
static int64_t arith_enc_rle(const uint8_t *in, int64_t n,
                             uint8_t *out, int64_t cap, int order1) {
    int m = arith_maxp1(in, n);
    amodel *lit = malloc((order1 ? 256 : 1) * sizeof *lit);
    amodel *run = malloc(258 * sizeof *run);
    if (!lit || !run || cap < 1) { free(lit); free(run); return -1; }
    for (int i = 0; i < (order1 ? 256 : 1); i++) am_init(&lit[i], 256, m);
    for (int i = 0; i < 258; i++) am_init(&run[i], 258, 4);
    out[0] = (uint8_t)m;
    rcoder rc;
    rc_enc_init(&rc, out + 1, cap - 1);
    uint8_t last = 0;
    int64_t i = 0;
    while (i < n) {
        uint8_t b = in[i];
        am_encode(&lit[order1 ? last : 0], &rc, b);
        int64_t r = 0;
        last = b;
        i++;
        while (i < n && in[i] == last) { r++; i++; }
        int rctx = last;
        for (;;) {
            int c = r < 4 ? (int)r : 3;
            am_encode(&run[rctx], &rc, c);
            r -= c;
            if (rctx == last) rctx = 256;
            else rctx += rctx < 257;
            if (c == 3 && r == 0) am_encode(&run[rctx], &rc, 0);
            if (!r) break;
        }
    }
    rc_enc_finish(&rc);
    free(lit); free(run);
    return rc.err ? -1 : rc.opos + 1;
}

static int64_t arith_dec_rle(const uint8_t *in, int64_t n,
                             uint8_t *out, int64_t out_sz, int order1) {
    if (n < 1) return -1;
    int m = in[0] ? in[0] : 256;
    amodel *lit = malloc((order1 ? 256 : 1) * sizeof *lit);
    amodel *run = malloc(258 * sizeof *run);
    if (!lit || !run) { free(lit); free(run); return -1; }
    for (int i = 0; i < (order1 ? 256 : 1); i++) am_init(&lit[i], 256, m);
    for (int i = 0; i < 258; i++) am_init(&run[i], 258, 4);
    rcoder rc;
    rc_dec_init(&rc, in, 1, n);
    uint8_t last = 0;
    for (int64_t i = 0; i < out_sz; i++) {
        uint8_t b = (uint8_t)am_decode(&lit[order1 ? last : 0], &rc);
        out[i] = b;
        last = b;
        int64_t r = 0;
        int rv, rctx = last;
        do {
            rv = am_decode(&run[rctx], &rc);
            if (rctx == last) rctx = 256;
            else rctx += rctx < 257;
            r += rv;
        } while (rv == 3 && r < out_sz);
        while (r-- && i + 1 < out_sz) out[++i] = last;
    }
    free(lit); free(run);
    return out_sz;
}

API int64_t arith_enc_o0_rle(const uint8_t *in, int64_t n, uint8_t *out,
                             int64_t cap) { return arith_enc_rle(in, n, out, cap, 0); }
API int64_t arith_enc_o1_rle(const uint8_t *in, int64_t n, uint8_t *out,
                             int64_t cap) { return arith_enc_rle(in, n, out, cap, 1); }
API int64_t arith_dec_o0_rle(const uint8_t *in, int64_t n, uint8_t *out,
                             int64_t sz) { return arith_dec_rle(in, n, out, sz, 0); }
API int64_t arith_dec_o1_rle(const uint8_t *in, int64_t n, uint8_t *out,
                             int64_t sz) { return arith_dec_rle(in, n, out, sz, 1); }

/* ---------------------------------------------------------------- */
/* fqzcomp_qual per-byte model scan.                                 */
/*                                                                   */
/* The parameter picker / serialisation stay host-Python; this is    */
/* the range-coded payload loop over 65536 mixed-context adaptive    */
/* models (quality history, position, delta, selector sub-contexts). */

#define FQZ_PM_WORDS 12
/* pm_ints layout per param:
   0 context, 1 pflags, 2 qbits, 3 qshift, 4 qloc, 5 sloc, 6 ploc,
   7 dloc, 8 max_sym(stored), 9 fixed_len, 10 do_sel, 11 do_dedup */

typedef struct {
    amodel *qual;      /* 65536 contexts (wide-alphabet fallback)     */
    am64 *qual64;      /* 65536 contexts, compact path (max_sym < 64) */
    amodel len[4], revcomp, dup, sel;
    int has_sel;
} fqz_models;

/* The 65536-context arrays are the dominant per-block cost (alloc +
 * init touch 17-68 MB); cache them per-thread and re-init by memcpy
 * of a one-context template (mirrors the reference's TLS model reuse,
 * fqzcomp_qual.c:317-327). */
static __thread am64 *tls_qual64 = NULL;
static __thread amodel *tls_qual = NULL;

static int fqz_models_init(fqz_models *m, int max_sym_p1, int max_sel) {
    m->qual = NULL;
    m->qual64 = NULL;
    if (max_sym_p1 <= 64) {
        if (!tls_qual64)
            tls_qual64 = aligned_alloc(256, (size_t)65536 * sizeof(am64));
        if (!tls_qual64) return -1;
        am64 tmpl;
        memset(&tmpl, 0, sizeof tmpl);
        tmpl.tot = (uint16_t)max_sym_p1;
        for (int i = 0; i < 64; i++) {
            tmpl.e[3 * i + 2] = (uint8_t)i;
            am64_setcnt(&tmpl, i, i < max_sym_p1 ? 1 : 0);
        }
        m->qual64 = tls_qual64;
        for (int i = 0; i < 65536; i++) m->qual64[i] = tmpl;
    } else {
        if (!tls_qual) tls_qual = malloc((size_t)65536 * sizeof(amodel));
        if (!tls_qual) return -1;
        m->qual = tls_qual;
        for (int i = 0; i < 65536; i++)
            am_init(&m->qual[i], 256, max_sym_p1);
    }
    for (int i = 0; i < 4; i++) am_init(&m->len[i], 256, 256);
    am_init(&m->revcomp, 2, 2);
    am_init(&m->dup, 2, 2);
    m->has_sel = max_sel > 0;
    if (m->has_sel) am_init(&m->sel, 256, max_sel + 1);
    return 0;
}

API int64_t fqz_enc(const uint8_t *in, int64_t n,
                    const uint32_t *lens, const uint32_t *flags,
                    int64_t nrec,
                    int gflags, int nparam, int max_sel, int gmax_sym,
                    const uint8_t *stab,
                    const uint32_t *pm_ints, const uint32_t *qmaps,
                    const uint32_t *qtabs, const uint32_t *ptabs,
                    const uint32_t *dtabs,
                    uint8_t *out, int64_t cap) {
    fqz_models md;
    if (fqz_models_init(&md, gmax_sym + 1, max_sel) < 0) return -1;
    rcoder rc;
    rc_enc_init(&rc, out, cap);

    int x = 0;
    const uint32_t *pm = pm_ints;
    const uint32_t *qmap = qmaps, *qtab = qtabs, *ptab = ptabs, *dtab = dtabs;
    uint32_t qctx = 0, p = 0, delta = 0, prevq = 0, sval = 0, ctx = 0;
    uint32_t qsh = 0, qmask = 0, qloc = 0, svs = 0;
    am64 *q64 = md.qual64;
    int first_len = 1;
    int64_t rec = 0, last_len = 0;

    for (int64_t i = 0; i < n && !rc.err; i++) {
        if (p == 0) {
            if (rec >= nrec) { return -1; }
            if (pm[10] || (gflags & 1)) {
                sval = flags[rec] >> 16;
                if (!md.has_sel) { return -1; }
                am_encode(&md.sel, &rc, (int)sval);
            } else {
                sval = 0;
            }
            x = (gflags & 2) ? stab[sval] : (int)sval;
            if (x >= nparam) { return -1; }
            pm = pm_ints + (size_t)x * FQZ_PM_WORDS;
            qmap = qmaps + (size_t)x * 256;
            qtab = qtabs + (size_t)x * 256;
            ptab = ptabs + (size_t)x * 1024;
            dtab = dtabs + (size_t)x * 256;

            uint32_t len = lens[rec];
            if (!pm[9] || first_len) {
                am_encode(&md.len[0], &rc, len & 0xff);
                am_encode(&md.len[1], &rc, (len >> 8) & 0xff);
                am_encode(&md.len[2], &rc, (len >> 16) & 0xff);
                am_encode(&md.len[3], &rc, (len >> 24) & 0xff);
                first_len = 0;
            }
            if (gflags & 4)
                am_encode(&md.revcomp, &rc, (flags[rec] & 16) ? 1 : 0);
            rec++;
            p = len;
            delta = 0; qctx = 0; prevq = 0;
            ctx = pm[0];
            qsh = pm[3]; qmask = (1u << pm[2]) - 1;
            qloc = pm[4]; svs = sval << pm[5];

            if (pm[11]) {
                if (i && (int64_t)len == last_len &&
                    !memcmp(in + i - last_len, in + i, len)) {
                    am_encode(&md.dup, &rc, 1);
                    i += len - 1;
                    p = 0;
                    continue;
                }
                am_encode(&md.dup, &rc, 0);
                last_len = len;
            }
        }

        uint32_t qm = qmap[in[i]];
        if (q64)
            am64_encode(&q64[ctx & 0xffff], &rc, (int)qm);
        else
            am_encode(&md.qual[ctx & 0xffff], &rc, (int)qm);

        qctx = (qctx << qsh) + qtab[qm];
        ctx = ((qctx & qmask) << qloc)
            + ptab[p < 1023 ? p : 1023]
            + dtab[delta < 255 ? delta : 255]
            + svs;
        ctx &= 0xffff;
        delta += prevq != qm;
        prevq = qm;
        p--;
    }
    rc_enc_finish(&rc);
    return rc.err ? -1 : rc.opos;
}

/* ---- encode replay: per-event (acc, freq, tot) triples, no coder ----
 *
 * Identical model evolution to fqz_enc with the range coder removed:
 * the triples stream to the device VMEM range-coder kernel
 * (ops/rc_vmem.py), which reproduces the reference byte stream exactly
 * (c_range_coder.h:46-89).  One event per model encode in stream order
 * — the per-record sel/len/rev/dup events included — so the RC pass
 * needs nothing but the triples.  This splits the serial per-byte work
 * in two: the context/model walk stays on the host (it is pointer-
 * chasing over a 16 MB arena the TPU cannot hold), the carry-counting
 * coder chain moves to the device where 128 blocks run per tile. */

static inline int am_replay(amodel *m, int symbol,
                            uint16_t *pacc, uint16_t *pf,
                            uint16_t *ptot) {
    uint32_t sy = (uint32_t)symbol, acc = 0;
    uint32_t *s = m->e + 1, *end = m->e + m->nsym + 1;
    *end = sy;                             /* terminal = search key */
    while (AM_SYM(*s) != sy) acc += *s++ >> 16;
    if (s == end) return -1;               /* symbol absent */
    *pacc = (uint16_t)acc;
    *pf = (uint16_t)(*s >> 16);
    *ptot = (uint16_t)m->tot;
    *s += 16u << 16;
    m->tot += 16;
    if (m->tot > 65519) am_renorm(m);
    if ((*s >> 16) > (s[-1] >> 16)) {
        uint32_t t = s[0]; s[0] = s[-1]; s[-1] = t;
    }
    return 0;
}

static inline int am64_replay(am64 *m, int symbol,
                              uint16_t *pacc, uint16_t *pf,
                              uint16_t *ptot) {
    uint32_t acc = 0;
    int p = 0;
    while (p < 64 && am64_sym(m, p) != symbol) acc += am64_cnt(m, p++);
    if (p >= 64) return -1;
    uint32_t cp = am64_cnt(m, p);
    *pacc = (uint16_t)acc;
    *pf = (uint16_t)cp;
    *ptot = m->tot;
    am64_setcnt(m, p, cp + 16);
    m->tot += 16;
    if (m->tot > 65519) am64_renorm(m);
    if (p && am64_cnt(m, p) > am64_cnt(m, p - 1)) am64_swap1(m, p);
    return 0;
}

API int64_t fqz_enc_replay(const uint8_t *in, int64_t n,
                           const uint32_t *lens, const uint32_t *flags,
                           int64_t nrec,
                           int gflags, int nparam, int max_sel,
                           int gmax_sym, const uint8_t *stab,
                           const uint32_t *pm_ints, const uint32_t *qmaps,
                           const uint32_t *qtabs, const uint32_t *ptabs,
                           const uint32_t *dtabs,
                           uint16_t *acc_out, uint16_t *f_out,
                           uint16_t *tot_out, int64_t cap_ev) {
    fqz_models md;
    if (fqz_models_init(&md, gmax_sym + 1, max_sel) < 0) return -1;

    int x = 0;
    const uint32_t *pm = pm_ints;
    const uint32_t *qmap = qmaps, *qtab = qtabs, *ptab = ptabs, *dtab = dtabs;
    uint32_t qctx = 0, p = 0, delta = 0, prevq = 0, sval = 0, ctx = 0;
    uint32_t qsh = 0, qmask = 0, qloc = 0, svs = 0;
    am64 *q64 = md.qual64;
    int first_len = 1;
    int64_t rec = 0, last_len = 0, ne = 0;

#define FQZ_EMIT(m_, sym_) do { \
        if (ne >= cap_ev) return -1; \
        if (am_replay((m_), (sym_), acc_out + ne, f_out + ne, \
                      tot_out + ne) < 0) return -1; \
        ne++; \
    } while (0)

    for (int64_t i = 0; i < n; i++) {
        if (p == 0) {
            if (rec >= nrec) return -1;
            if (pm[10] || (gflags & 1)) {
                sval = flags[rec] >> 16;
                if (!md.has_sel) return -1;
                FQZ_EMIT(&md.sel, (int)sval);
            } else {
                sval = 0;
            }
            x = (gflags & 2) ? stab[sval] : (int)sval;
            if (x >= nparam) return -1;
            pm = pm_ints + (size_t)x * FQZ_PM_WORDS;
            qmap = qmaps + (size_t)x * 256;
            qtab = qtabs + (size_t)x * 256;
            ptab = ptabs + (size_t)x * 1024;
            dtab = dtabs + (size_t)x * 256;

            uint32_t len = lens[rec];
            if (!pm[9] || first_len) {
                FQZ_EMIT(&md.len[0], (int)(len & 0xff));
                FQZ_EMIT(&md.len[1], (int)((len >> 8) & 0xff));
                FQZ_EMIT(&md.len[2], (int)((len >> 16) & 0xff));
                FQZ_EMIT(&md.len[3], (int)((len >> 24) & 0xff));
                first_len = 0;
            }
            if (gflags & 4)
                FQZ_EMIT(&md.revcomp, (flags[rec] & 16) ? 1 : 0);
            rec++;
            p = len;
            delta = 0; qctx = 0; prevq = 0;
            ctx = pm[0];
            qsh = pm[3]; qmask = (1u << pm[2]) - 1;
            qloc = pm[4]; svs = sval << pm[5];

            if (pm[11]) {
                if (i && (int64_t)len == last_len &&
                    !memcmp(in + i - last_len, in + i, len)) {
                    FQZ_EMIT(&md.dup, 1);
                    i += len - 1;
                    p = 0;
                    continue;
                }
                FQZ_EMIT(&md.dup, 0);
                last_len = len;
            }
        }

        uint32_t qm = qmap[in[i]];
        if (ne >= cap_ev) return -1;
        if (q64) {
            if (am64_replay(&q64[ctx & 0xffff], (int)qm, acc_out + ne,
                            f_out + ne, tot_out + ne) < 0) return -1;
        } else {
            if (am_replay(&md.qual[ctx & 0xffff], (int)qm, acc_out + ne,
                          f_out + ne, tot_out + ne) < 0) return -1;
        }
        ne++;

        qctx = (qctx << qsh) + qtab[qm];
        ctx = ((qctx & qmask) << qloc)
            + ptab[p < 1023 ? p : 1023]
            + dtab[delta < 255 ? delta : 255]
            + svs;
        ctx &= 0xffff;
        delta += prevq != qm;
        prevq = qm;
        p--;
    }
#undef FQZ_EMIT
    return ne;
}

API int64_t fqz_dec(const uint8_t *in, int64_t n, int64_t total,
                    int gflags, int nparam, int max_sel, int gmax_sym,
                    const uint8_t *stab,
                    const uint32_t *pm_ints, const uint32_t *qmaps,
                    const uint32_t *qtabs, const uint32_t *ptabs,
                    const uint32_t *dtabs,
                    uint8_t *out, uint32_t *rec_lens, uint8_t *rec_revs,
                    int64_t max_rec) {
    fqz_models md;
    if (fqz_models_init(&md, gmax_sym + 1, max_sel) < 0) return -1;
    rcoder rc;
    rc_dec_init(&rc, in, 0, n);

    int x = 0;
    const uint32_t *pm = pm_ints;
    const uint32_t *qmap = qmaps, *qtab = qtabs, *ptab = ptabs, *dtab = dtabs;
    uint32_t qctx = 0, p = 0, delta = 0, prevq = 0, sval = 0, ctx = 0;
    uint32_t len = 0, last_len = 0;
    uint32_t qsh = 0, qmask = 0, qloc = 0, svs = 0;
    am64 *q64 = md.qual64;
    int first_len = 1, rev = 0;
    int64_t rec = 0;

    for (int64_t i = 0; i < total; i++) {
        if (p == 0) {
            if (pm[10]) {
                if (!md.has_sel) goto fail;
                sval = (uint32_t)am_decode(&md.sel, &rc);
            } else {
                sval = 0;
            }
            x = (gflags & 2) ? stab[sval < 255 ? sval : 255] : (int)sval;
            if (x >= nparam) goto fail;
            pm = pm_ints + (size_t)x * FQZ_PM_WORDS;
            qmap = qmaps + (size_t)x * 256;
            qtab = qtabs + (size_t)x * 256;
            ptab = ptabs + (size_t)x * 1024;
            dtab = dtabs + (size_t)x * 256;

            len = last_len;
            if (!pm[9] || first_len) {
                len = (uint32_t)am_decode(&md.len[0], &rc);
                len |= (uint32_t)am_decode(&md.len[1], &rc) << 8;
                len |= (uint32_t)am_decode(&md.len[2], &rc) << 16;
                len |= (uint32_t)am_decode(&md.len[3], &rc) << 24;
                first_len = 0;
                last_len = len;
            }
            if (len > (uint64_t)(total - i) || len == 0) goto fail;
            if (rec < max_rec) rec_lens[rec] = len;

            if (gflags & 4) {
                rev = am_decode(&md.revcomp, &rc);
                if (rec < max_rec) rec_revs[rec] = (uint8_t)rev;
            }

            if (pm[11]) {
                if (am_decode(&md.dup, &rc)) {
                    if ((int64_t)len > i) goto fail;
                    memcpy(out + i, out + i - len, len);
                    i += len - 1;
                    p = 0;
                    rec++;
                    continue;
                }
            }
            rec++;
            p = len;
            delta = 0; prevq = 0; qctx = 0;
            ctx = pm[0];
            qsh = pm[3]; qmask = (1u << pm[2]) - 1;
            qloc = pm[4]; svs = sval << pm[5];
        }

        uint32_t Q = q64
            ? (uint32_t)am64_decode(&q64[ctx & 0xffff], &rc)
            : (uint32_t)am_decode(&md.qual[ctx & 0xffff], &rc);
        out[i] = (uint8_t)qmap[Q];
        qctx = (qctx << qsh) + qtab[Q];
        ctx = ((qctx & qmask) << qloc)
            + ptab[p < 1023 ? p : 1023]
            + dtab[delta < 255 ? delta : 255]
            + svs;
        ctx &= 0xffff;
        delta += prevq != Q;
        prevq = Q;
        p--;
    }
    return rec;
 fail:
    return -1;
}

/* ---------------------------------------------------------------- */
/* tokenise_name3: native tokenizer + token replay.
 *
 * Exact port of the models/tok3.py tokenizer (itself golden-tested
 * against tokenise_name3.c:505-712,729-1002 and :1018-1190): trie
 * diff search with platform prefix heuristics, typed column tokens,
 * the DDELTA (5+dcount)>icount heuristic, and the decoder's token
 * replay against the lc[] history.  Descriptor framing/compression
 * stays in Python. */

enum { T_TYPE = 0, T_ALPHA, T_CHAR, T_DIGITS0, T_DZLEN, T_DUP, T_DIFF,
       T_DIGITS, T_DDELTA, T_DDELTA0, T_MATCH, T_NOP, T_END };
enum { TK_MAX_TOKENS = 128, TK_MAX_TBLOCKS = 128 * 16 };

typedef struct { uint8_t *p; int64_t len, cap; } gbuf;

static int gput(gbuf *g, const uint8_t *src, int64_t n) {
    if (g->len + n > g->cap) {
        int64_t nc = g->cap ? g->cap * 2 : 64;
        while (nc < g->len + n) nc *= 2;
        uint8_t *np = realloc(g->p, nc);
        if (!np) return -1;
        g->p = np;
        g->cap = nc;
    }
    memcpy(g->p + g->len, src, n);
    g->len += n;
    return 0;
}

static int gputc(gbuf *g, uint8_t c) { return gput(g, &c, 1); }

static int gput_u32le(gbuf *g, uint32_t v) {
    uint8_t b[4] = { (uint8_t)v, (uint8_t)(v >> 8), (uint8_t)(v >> 16),
                     (uint8_t)(v >> 24) };
    return gput(g, b, 4);
}

/* Trie with open-addressed (node, char) -> child hashing.
 *
 * The previous sibling-list layout (with move-to-front) cost 2-3
 * dependent cache misses per character and was 63% of tokenizer time
 * (gprof, r3); one hash probe per character halves the misses.  Edge
 * order is internal-only -- the (node, c) match is unique -- so the
 * emitted token stream is unchanged (reference keeps sibling lists,
 * tokenise_name3.c:507-616; this is the TPU-host redesign of the same
 * structure).  Each table entry packs (node<<7|c) << 26 | child into
 * a u64: child ids are capped at 2^26 (a 64M-node name block fails
 * over to the caller's fallback path). */
typedef struct {
    int32_t *nodes; int64_t nn, ncap;   /* per-node last-name id      */
    uint64_t *tab; int64_t tn;          /* open-addressed edge table  */
    int tbits;
} trie;

#define TRIE_MAX_NODE (1 << 26)

static int32_t trie_node(trie *t, int32_t n) {
    if (t->nn == t->ncap) {
        t->ncap = t->ncap ? t->ncap * 2 : 4096;
        int32_t *np = realloc(t->nodes, t->ncap * sizeof(int32_t));
        if (!np) return -1;
        t->nodes = np;
    }
    if (t->nn >= TRIE_MAX_NODE) return -1;
    t->nodes[t->nn] = n;
    return (int32_t)t->nn++;
}

static int trie_grow(trie *t) {
    int nb = t->tbits ? t->tbits + 1 : 16;
    if (nb > 34) return -1;
    uint64_t *nt = calloc((size_t)1 << nb, sizeof(uint64_t));
    if (!nt) return -1;
    uint64_t nmask = ((uint64_t)1 << nb) - 1;
    if (t->tab) {
        int64_t cap = (int64_t)1 << t->tbits;
        for (int64_t i = 0; i < cap; i++) {
            uint64_t e = t->tab[i];
            if (!e) continue;
            uint64_t h = ((e >> 26) * 0x9E3779B97F4A7C15ull) >> (64 - nb);
            while (nt[h]) h = (h + 1) & nmask;
            nt[h] = e;
        }
        free(t->tab);
    }
    t->tab = nt;
    t->tbits = nb;
    return 0;
}

static inline int32_t trie_child(trie *t, int32_t node, uint8_t c,
                                 int32_t nameid, int create) {
    uint64_t key = ((uint64_t)node << 7) | c;
    uint64_t mask = ((uint64_t)1 << t->tbits) - 1;
    uint64_t h = (key * 0x9E3779B97F4A7C15ull) >> (64 - t->tbits);
    for (;;) {
        uint64_t e = t->tab[h];
        if (!e) break;
        if ((e >> 26) == key) {
            int32_t child = (int32_t)(e & (TRIE_MAX_NODE - 1));
            /* creator id == min toucher: a no-op for the sequential
             * build, and what makes the 8-way interleaved build
             * order-independent */
            if (create && t->nodes[child] > nameid)
                t->nodes[child] = nameid;
            return child;
        }
        h = (h + 1) & mask;
    }
    if (!create) return -1;
    if ((t->tn + 1) * 2 > (int64_t)1 << t->tbits) {
        if (trie_grow(t) < 0) return -1;
        mask = ((uint64_t)1 << t->tbits) - 1;
        h = (key * 0x9E3779B97F4A7C15ull) >> (64 - t->tbits);
        while (t->tab[h]) h = (h + 1) & mask;
    }
    int32_t nn = trie_node(t, nameid);
    if (nn < 0) return -1;
    t->tab[h] = (key << 26) | (uint32_t)nn;
    t->tn++;
    return nn;
}

typedef struct {
    int32_t name_off, name_len, ntok;
    uint8_t *types;
    int32_t *ints, *strs;
} lcrec;

typedef struct {
    gbuf desc[TK_MAX_TBLOCKS];
    int32_t dcount[TK_MAX_TOKENS], icount[TK_MAX_TOKENS];
    int32_t max_tok;
    trie tr;
    lcrec *lc;
    uint8_t *tarena;   /* types/ints/strs backing store */
    const uint8_t *blk;
    int32_t *paths;    /* pass-1 node id per input char (starts[] layout) */
} tok3ctx;

static int tk_is_alpha(uint8_t c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z');
}
static int tk_is_alpha_punct(uint8_t c) {
    return c >= 33 && c <= 126 && !(c >= '0' && c <= '9');
}
static int tk_is_digit(uint8_t c) { return c >= '0' && c <= '9'; }

/* returns (end<<32)|value packed via out params */
static int64_t tk_scan_digits(const uint8_t *name, int64_t i, int64_t length,
                              uint32_t *vout) {
    int64_t s = i;
    uint32_t v = 0;
    while (s < length && tk_is_digit(name[s]) && s - i < 9) {
        v = v * 10 + (uint32_t)(name[s] - '0');
        s++;
    }
    *vout = v;
    return s;
}

/* trie search with platform prefix heuristics; returns pnum (or -1),
 * sets exact/is_fixed/fixed_len */
static int64_t tk_search(tok3ctx *cx, const uint8_t *name, int64_t length,
                         int64_t n, int *exact, int *is_fixed,
                         int64_t *fixed_len) {
    const uint8_t *d = name;
    int64_t l = length;
    *exact = 0;
    *fixed_len = 0;
    *is_fixed = 0;
    if (length && name[0] == '@') { d = name + 1; l = length - 1; }
    int f = (length && name[0] == '>') ? 1 : 0;
    int64_t prefix_len;
    if (l > 70 && d[f + 0] == 'm' && d[7] == '_' && d[f + 14] == '_'
            && d[f + 61] == '/') {
        prefix_len = 60;
    } else if (l == 17 && d[f + 5] == ':' && d[f + 11] == ':') {
        prefix_len = 6; *fixed_len = 6; *is_fixed = 1;
    } else if (l > 37 && d[f + 8] == '-' && d[f + 13] == '-'
            && d[f + 18] == '-' && d[f + 23] == '-'
            && ((d[f + 0] >= '0' && d[f + 0] <= '9')
                || (d[f + 0] >= 'a' && d[f + 0] <= 'f'))
            && ((d[f + 35] >= '0' && d[f + 35] <= '9')
                || (d[f + 35] >= 'a' && d[f + 35] <= 'f'))) {
        prefix_len = 37; *fixed_len = 37; *is_fixed = 1;
    } else {
        int64_t i = 0;
        while (i < length && name[i] > ' ') i++;
        int colons = 0;
        while (i > 0 && colons < 4) {
            i--;
            if (name[i] == ':') colons++;
        }
        if (colons == 4) {
            *fixed_len = i + 1; prefix_len = i + 1; *is_fixed = 1;
        } else {
            prefix_len = 0x7FFFFFFF;
        }
    }
    /* Replay the node ids recorded during the pass-1 build: the walk
     * here needs no hash probes, and the loads have precomputed
     * addresses so they pipeline instead of forming a dependent
     * pointer chain (the old walk was the tokenizer's main cost). */
    int64_t from = -1, p3 = -1;
    const int32_t *path = cx->paths + (name - cx->blk);
    int32_t *nodes = cx->tr.nodes;
    for (int64_t k = 0; k < length; k++) {
        int32_t t = path[k];
        int32_t old = nodes[t];
        nodes[t] = (int32_t)n;
        if (k == length - 1) from = old;
        if (k + 1 == prefix_len) p3 = old;
    }
    *exact = (n != from && length) ? 1 : 0;
    return *exact ? from : p3;
}

static int tk_put(tok3ctx *cx, int tid, const uint8_t *b, int64_t n) {
    return gput(&cx->desc[tid], b, n);
}
static int tk_putc(tok3ctx *cx, int tid, uint8_t c) {
    return gputc(&cx->desc[tid], c);
}

static void tk_bump(tok3ctx *cx, int32_t nt) {
    if (nt >= cx->max_tok) {
        cx->dcount[cx->max_tok] = 0;
        cx->icount[cx->max_tok] = 0;
        cx->max_tok = nt + 1;
    }
}

static int tk_encode_name(tok3ctx *cx, int64_t cnum, const uint8_t *name,
                          int64_t length) {
    int exact, is_fixed;
    int64_t fixed_len;
    int64_t pnum = tk_search(cx, name, length, cnum, &exact, &is_fixed,
                             &fixed_len);
    if (pnum == -2) return -1;
    if (pnum < 0) pnum = cnum ? cnum - 1 : 0;

    lcrec *plc = &cx->lc[pnum];
    lcrec empty = { 0, 0, 0, NULL, NULL, NULL };
    if (pnum == cnum) plc = &empty;   /* self-reference, never read */
    const uint8_t *p_name = cx->blk + plc->name_off;

    if (exact && length == plc->name_len) {
        if (tk_putc(cx, 0, T_DUP)) return -1;
        if (gput_u32le(&cx->desc[T_DUP], (uint32_t)(cnum - pnum))) return -1;
        lcrec *me = &cx->lc[cnum];
        *me = *plc;
        me->name_off = (int32_t)(name - cx->blk);
        me->name_len = (int32_t)length;
        return 0;
    }

    if (tk_putc(cx, 0, T_DIFF)) return -1;
    if (gput_u32le(&cx->desc[T_DIFF], (uint32_t)(cnum - pnum))) return -1;

    lcrec *me = &cx->lc[cnum];
    me->name_off = (int32_t)(name - cx->blk);
    me->name_len = (int32_t)length;
    me->types = cx->tarena + (size_t)cnum * TK_MAX_TOKENS * 9;
    me->ints = (int32_t *)(me->types + TK_MAX_TOKENS);
    me->strs = me->ints + TK_MAX_TOKENS;
    memset(me->types, 0, TK_MAX_TOKENS);
    uint8_t *types = me->types;
    int32_t *ints = me->ints;
    int32_t *strs = me->strs;

    int usable_prev = pnum < cnum;
    int32_t p_ntok = plc->ntok;
    const uint8_t *p_types = plc->types;
    const int32_t *p_ints = plc->ints;
    const int32_t *p_strs = plc->strs;

    int32_t ntok = 1;
    int64_t i = 0;

    if (is_fixed) {
        if (ntok >= TK_MAX_TOKENS) return -1;
        tk_bump(cx, ntok);
        if (usable_prev && ntok < p_ntok && p_types[ntok] == T_ALPHA
                && p_ints[ntok] == fixed_len
                && !memcmp(name, p_name, fixed_len)) {
            if (tk_putc(cx, ntok << 4, T_MATCH)) return -1;
        } else {
            if (tk_putc(cx, ntok << 4, T_ALPHA)) return -1;
            if (tk_put(cx, (ntok << 4) | T_ALPHA, name, fixed_len)) return -1;
            if (tk_putc(cx, (ntok << 4) | T_ALPHA, 0)) return -1;
        }
        ints[ntok] = (int32_t)fixed_len;
        strs[ntok] = 0;
        types[ntok] = T_ALPHA;
        ntok++;
        i = fixed_len;
    }

    while (i < length) {
        if (ntok >= TK_MAX_TOKENS) return -1;
        tk_bump(cx, ntok);
        uint8_t c = name[i];
        int as_digits0 = 0;

        if (tk_is_alpha(c)) {
            int64_t s = i + 1;
            while (s < length && tk_is_alpha_punct(name[s])) s++;
            if (s - i == 1) {
                if (usable_prev && ntok < p_ntok && p_types[ntok] == T_CHAR
                        && c == p_ints[ntok]) {
                    if (tk_putc(cx, ntok << 4, T_MATCH)) return -1;
                } else {
                    if (tk_putc(cx, ntok << 4, T_CHAR)) return -1;
                    if (tk_putc(cx, (ntok << 4) | T_CHAR, c)) return -1;
                }
                ints[ntok] = c;
                types[ntok] = T_CHAR;
            } else {
                if (usable_prev && ntok < p_ntok && p_types[ntok] == T_ALPHA
                        && s - i == p_ints[ntok]
                        && !memcmp(name + i, p_name + p_strs[ntok], s - i)) {
                    if (tk_putc(cx, ntok << 4, T_MATCH)) return -1;
                } else {
                    if (tk_putc(cx, ntok << 4, T_ALPHA)) return -1;
                    if (tk_put(cx, (ntok << 4) | T_ALPHA, name + i, s - i))
                        return -1;
                    if (tk_putc(cx, (ntok << 4) | T_ALPHA, 0)) return -1;
                }
                ints[ntok] = (int32_t)(s - i);
                strs[ntok] = (int32_t)i;
                types[ntok] = T_ALPHA;
                i = s - 1;
            }
        } else if (c == '0') {
            as_digits0 = 1;
        } else if (tk_is_digit(c)) {
            uint32_t v;
            int64_t s = tk_scan_digits(name, i, length, &v);
            if (usable_prev && ntok < p_ntok && p_types[ntok] == T_DIGITS0
                    && p_strs[ntok] == s - i) {
                as_digits0 = 1;
            } else {
                if (usable_prev && ntok < p_ntok
                        && p_types[ntok] == T_DIGITS) {
                    int64_t dd = (int64_t)v - p_ints[ntok];
                    if (dd == 0) {
                        if (tk_putc(cx, ntok << 4, T_MATCH)) return -1;
                    } else if (dd >= 0 && dd < 256
                               && (5 + cx->dcount[ntok]) > cx->icount[ntok]) {
                        if (tk_putc(cx, ntok << 4, T_DDELTA)) return -1;
                        if (tk_putc(cx, (ntok << 4) | T_DDELTA, (uint8_t)dd))
                            return -1;
                        cx->dcount[ntok]++;
                    } else {
                        if (tk_putc(cx, ntok << 4, T_DIGITS)) return -1;
                        if (gput_u32le(&cx->desc[(ntok << 4) | T_DIGITS], v))
                            return -1;
                        cx->icount[ntok]++;
                    }
                } else {
                    if (tk_putc(cx, ntok << 4, T_DIGITS)) return -1;
                    if (gput_u32le(&cx->desc[(ntok << 4) | T_DIGITS], v))
                        return -1;
                }
                ints[ntok] = (int32_t)v;
                types[ntok] = T_DIGITS;
                i = s - 1;
            }
        } else {
            if (usable_prev && ntok < p_ntok && p_types[ntok] == T_CHAR
                    && c == p_ints[ntok]) {
                if (tk_putc(cx, ntok << 4, T_MATCH)) return -1;
            } else {
                if (tk_putc(cx, ntok << 4, T_CHAR)) return -1;
                if (tk_putc(cx, (ntok << 4) | T_CHAR, c)) return -1;
            }
            ints[ntok] = c;
            types[ntok] = T_CHAR;
        }

        if (as_digits0) {
            uint32_t v;
            int64_t s = tk_scan_digits(name, i, length, &v);
            if (usable_prev && ntok < p_ntok && p_types[ntok] == T_DIGITS0) {
                int64_t dd = (int64_t)v - p_ints[ntok];
                if (dd == 0 && p_strs[ntok] == s - i) {
                    if (tk_putc(cx, ntok << 4, T_MATCH)) return -1;
                } else if (dd >= 0 && dd < 256 && p_strs[ntok] == s - i) {
                    if (tk_putc(cx, ntok << 4, T_DDELTA0)) return -1;
                    if (tk_putc(cx, (ntok << 4) | T_DDELTA0, (uint8_t)dd))
                        return -1;
                } else {
                    if (tk_putc(cx, (ntok << 4) | T_DZLEN, (uint8_t)(s - i)))
                        return -1;
                    if (tk_putc(cx, ntok << 4, T_DIGITS0)) return -1;
                    if (gput_u32le(&cx->desc[(ntok << 4) | T_DIGITS0], v))
                        return -1;
                }
            } else {
                if (tk_putc(cx, (ntok << 4) | T_DZLEN, (uint8_t)(s - i)))
                    return -1;
                if (tk_putc(cx, ntok << 4, T_DIGITS0)) return -1;
                if (gput_u32le(&cx->desc[(ntok << 4) | T_DIGITS0], v))
                    return -1;
            }
            strs[ntok] = (int32_t)(s - i);
            ints[ntok] = (int32_t)v;
            types[ntok] = T_DIGITS0;
            i = s - 1;
        }

        ntok++;
        i++;
    }

    if (ntok >= TK_MAX_TOKENS) return -1;
    tk_bump(cx, ntok);
    if (tk_putc(cx, ntok << 4, T_END)) return -1;
    me->ntok = ntok;
    return 0;
}

/* Tokenise a block of names.  starts/lens: per-name slices into blk.
 * On success fills dlens[TK_MAX_TBLOCKS] and writes the descriptor
 * streams concatenated in tid order into arena; returns total bytes
 * (or the required size if > arena_cap, negated - caller retries).
 * Returns -1 on unsupported input (8-bit bytes, token overflow). */
API int64_t tok3_tokenize(const uint8_t *blk, const int64_t *starts,
                          const int64_t *lens, int64_t nreads,
                          uint8_t *arena, int64_t arena_cap,
                          int64_t *dlens, int32_t *max_tok_out) {
    /* the paths buffer below indexes by starts[n]+k: require at least
     * one name and an ascending, non-overlapping layout whose last
     * name ends last (models/tok3.py always satisfies this; reject
     * anything else rather than read/write out of bounds) */
    if (nreads < 1) return -1;
    for (int64_t n = 0; n < nreads; n++) {
        if (starts[n] < 0 || lens[n] < 0) return -1;
        if (n && starts[n] < starts[n - 1] + lens[n - 1]) return -1;
    }
    tok3ctx *cx = calloc(1, sizeof(tok3ctx));
    if (!cx) return -1;
    cx->max_tok = 1;
    cx->blk = blk;
    cx->lc = calloc(nreads + 1, sizeof(lcrec));
    cx->tarena = malloc((size_t)(nreads + 1) * TK_MAX_TOKENS * 9);
    int64_t ret = -1;
    if (!cx->lc || !cx->tarena) goto done;
    if (trie_node(&cx->tr, 0) != 0 || trie_grow(&cx->tr) < 0) goto done;

    /* pass 1: build the trie, 8 names in flight.  Each lane's walk is
     * an independent load chain, hiding the ~1 cache miss/char latency
     * that dominated the sequential build; the trie-edge set and the
     * creator ids (min toucher, see trie_child) are order-independent.
     * Resolved node ids are recorded per char for the pass-2 replay. */
    {
        int64_t pend = starts[nreads - 1] + lens[nreads - 1];
        cx->paths = malloc((size_t)pend * sizeof(int32_t));
        if (!cx->paths) goto done;
        enum { TK_LANES = 8 };
        for (int64_t base = 0; base < nreads; base += TK_LANES) {
            int nl = nreads - base < TK_LANES ? (int)(nreads - base)
                                              : TK_LANES;
            int32_t cur[TK_LANES];
            int64_t maxl = 0;
            for (int l = 0; l < nl; l++) {
                cur[l] = 0;
                if (lens[base + l] > maxl) maxl = lens[base + l];
            }
            for (int64_t k = 0; k < maxl; k++) {
                for (int l = 0; l < nl; l++) {
                    int64_t n = base + l;
                    if (k >= lens[n]) continue;
                    uint8_t c = blk[starts[n] + k];
                    if (c & 0x80) goto done;    /* 8-bit: python path */
                    int32_t t = trie_child(&cx->tr, cur[l], c,
                                           (int32_t)n, 1);
                    if (t < 0) goto done;
                    cur[l] = t;
                    cx->paths[starts[n] + k] = t;
                }
            }
        }
    }
    /* pass 2: encode */
    for (int64_t n = 0; n < nreads; n++) {
        if (tk_encode_name(cx, n, blk + starts[n], lens[n]) < 0)
            goto done;
    }
    {
        int64_t tot = 0;
        for (int t = 0; t < TK_MAX_TBLOCKS; t++) {
            dlens[t] = cx->desc[t].len;
            tot += cx->desc[t].len;
        }
        *max_tok_out = cx->max_tok;
        if (tot > arena_cap) {
            ret = -tot - 10;       /* signal required size */
            goto done;
        }
        int64_t off = 0;
        for (int t = 0; t < TK_MAX_TBLOCKS; t++) {
            if (cx->desc[t].len) {
                memcpy(arena + off, cx->desc[t].p, cx->desc[t].len);
                off += cx->desc[t].len;
            }
        }
        ret = tot;
    }
done:
    for (int t = 0; t < TK_MAX_TBLOCKS; t++) free(cx->desc[t].p);
    free(cx->tr.nodes);
    free(cx->tr.tab);
    free(cx->paths);
    free(cx->lc);
    free(cx->tarena);
    free(cx);
    return ret;
}

/* token replay: decode names from decompressed descriptor streams.
 * doffs/dls: per-tid slices into arena (dls=-1 for absent).
 * Returns bytes written to out (NUL-terminated names), or -1. */
API int64_t tok3_detokenize(const uint8_t *arena, const int64_t *doffs,
                            const int64_t *dls, int32_t max_tok,
                            int64_t nreads, uint8_t *out, int64_t out_cap) {
    int64_t *cur = calloc(TK_MAX_TBLOCKS, sizeof(int64_t));
    lcrec *lc = calloc(nreads + 1, sizeof(lcrec));
    /* per-record token store sized by the stream's real max_tok (the
     * 128-token worst case is 1.2 KB/record of cold cache misses) */
    int mt_s = max_tok < 1 ? 1 : (max_tok > TK_MAX_TOKENS
                                  ? TK_MAX_TOKENS : max_tok);
    size_t stride = ((size_t)mt_s * 9 + 15) & ~(size_t)15;
    uint8_t *tarena = malloc((size_t)(nreads + 1) * stride + 16);
    int64_t olen = 0, ret = -1;
    if (!cur || !lc || !tarena) goto done;

#define TK_GET_TYPE(ntok, v) do { \
        int _t = (ntok) << 4; \
        if (dls[_t] < 0 || cur[_t] >= dls[_t]) { v = -1; } \
        else { v = arena[doffs[_t] + cur[_t]++]; } \
    } while (0)

    int64_t counter = 0;
    for (;;) {
        int64_t cnum = counter;
        if (cnum >= nreads + 1) goto done;
        counter++;
        int t0;
        TK_GET_TYPE(0, t0);
        if (t0 < 0 || t0 >= max_tok * 16) { counter--; break; }
        int dtid = t0;     /* 0<<4 | t0 */
        if (dls[dtid] < 0 || cur[dtid] + 4 > dls[dtid]) goto done;
        const uint8_t *dp = arena + doffs[dtid] + cur[dtid];
        cur[dtid] += 4;
        uint32_t dist = dp[0] | (dp[1] << 8) | (dp[2] << 16)
            | ((uint32_t)dp[3] << 24);
        if (dist > (uint64_t)cnum) goto done;
        int64_t pnum = cnum - dist;
        if (pnum < 0) pnum = 0;

        if (t0 == T_DUP) {
            if (pnum == cnum || lc[pnum].types == NULL) goto done;
            lcrec *plc = &lc[pnum];
            if (olen + plc->name_len + 1 > out_cap) goto done;
            memcpy(out + olen, out + plc->name_off, plc->name_len);
            lc[cnum] = *plc;
            lc[cnum].name_off = (int32_t)olen;
            olen += plc->name_len;
            out[olen++] = 0;
            continue;
        }

        lcrec empty = { 0, 0, 0, NULL, NULL, NULL };
        lcrec *plc = (lc[pnum].types != NULL) ? &lc[pnum] : &empty;
        lcrec *me = &lc[cnum];
        me->name_off = (int32_t)olen;
        uint8_t *tb = tarena + (size_t)cnum * stride;
        me->ints = (int32_t *)tb;
        me->strs = me->ints + mt_s;
        me->types = (uint8_t *)(me->strs + mt_s);
        memset(me->types, 0, mt_s);
        uint8_t *types = me->types;
        int32_t *ints = me->ints;
        int32_t *strs = me->strs;
        const uint8_t *p_name = out + plc->name_off;
        int ended = 0;
        int lim = max_tok < TK_MAX_TOKENS ? max_tok : TK_MAX_TOKENS;

#define TK_NEED(n_) do { if (olen + (n_) + 1 > out_cap) goto done; } while (0)
#define TK_GET(tid_, n_, ptr_) do { \
        if (dls[tid_] < 0 || cur[tid_] + (n_) > dls[tid_]) goto done; \
        ptr_ = arena + doffs[tid_] + cur[tid_]; \
        cur[tid_] += (n_); \
    } while (0)

        for (int ntok = 1; ntok < lim; ntok++) {
            int tok;
            TK_GET_TYPE(ntok, tok);
            const uint8_t *bp;
            if (tok == T_CHAR) {
                TK_GET((ntok << 4) | T_CHAR, 1, bp);
                TK_NEED(1);
                out[olen++] = bp[0];
                types[ntok] = T_CHAR;
                ints[ntok] = bp[0];
            } else if (tok == T_ALPHA) {
                int tid = (ntok << 4) | T_ALPHA;
                if (dls[tid] < 0 || cur[tid] >= dls[tid]) goto done;
                const uint8_t *d0 = arena + doffs[tid];
                int64_t e = cur[tid];
                while (e < dls[tid] && d0[e]) e++;
                int64_t alen;
                if (e >= dls[tid]) {            /* unterminated */
                    e = dls[tid] - 1;
                    alen = e - cur[tid];
                } else {
                    alen = e - cur[tid];
                }
                TK_NEED(alen);
                types[ntok] = T_ALPHA;
                strs[ntok] = (int32_t)(olen - me->name_off);
                ints[ntok] = (int32_t)alen;
                memcpy(out + olen, d0 + cur[tid], alen);
                olen += alen;
                cur[tid] = e + 1;
            } else if (tok == T_DIGITS0) {
                const uint8_t *lp;
                TK_GET((ntok << 4) | T_DZLEN, 1, lp);
                TK_GET((ntok << 4) | T_DIGITS0, 4, bp);
                uint32_t v = bp[0] | (bp[1] << 8) | (bp[2] << 16)
                    | ((uint32_t)bp[3] << 24);
                int l = lp[0] > 9 ? 9 : lp[0];
                TK_NEED(l);
                uint32_t vv = v;
                for (int k = l; k > 0; k--) {
                    out[olen + k - 1] = (uint8_t)(48 + vv % 10);
                    vv /= 10;
                }
                olen += l;
                types[ntok] = T_DIGITS0;
                ints[ntok] = (int32_t)v;
                strs[ntok] = lp[0];
            } else if (tok == T_DDELTA0) {
                if (ntok >= plc->ntok) goto done;
                TK_GET((ntok << 4) | T_DDELTA0, 1, bp);
                uint32_t v = (uint32_t)(bp[0] + (uint32_t)plc->ints[ntok]);
                int l = plc->strs[ntok] > 9 ? 9 : plc->strs[ntok];
                if (l < 0) goto done;
                TK_NEED(l);
                uint32_t vv = v;
                for (int k = l; k > 0; k--) {
                    out[olen + k - 1] = (uint8_t)(48 + vv % 10);
                    vv /= 10;
                }
                olen += l;
                types[ntok] = T_DIGITS0;
                ints[ntok] = (int32_t)v;
                strs[ntok] = plc->strs[ntok];
            } else if (tok == T_DIGITS) {
                TK_GET((ntok << 4) | T_DIGITS, 4, bp);
                uint32_t v = bp[0] | (bp[1] << 8) | (bp[2] << 16)
                    | ((uint32_t)bp[3] << 24);
                TK_NEED(10);
                if (v) {
                    char tmp[12];
                    int tl = 0;
                    uint32_t vv = v;
                    while (vv) { tmp[tl++] = (char)('0' + vv % 10); vv /= 10; }
                    while (tl) out[olen++] = (uint8_t)tmp[--tl];
                }
                types[ntok] = T_DIGITS;
                ints[ntok] = (int32_t)v;
            } else if (tok == T_DDELTA) {
                if (ntok >= plc->ntok) goto done;
                TK_GET((ntok << 4) | T_DDELTA, 1, bp);
                uint32_t v = (uint32_t)(bp[0] + (uint32_t)plc->ints[ntok]);
                TK_NEED(10);
                if (v) {
                    char tmp[12];
                    int tl = 0;
                    uint32_t vv = v;
                    while (vv) { tmp[tl++] = (char)('0' + vv % 10); vv /= 10; }
                    while (tl) out[olen++] = (uint8_t)tmp[--tl];
                }
                types[ntok] = T_DIGITS;
                ints[ntok] = (int32_t)v;
            } else if (tok == T_NOP) {
                types[ntok] = T_NOP;
            } else if (tok == T_MATCH) {
                if (ntok >= plc->ntok) goto done;
                int pt = plc->types[ntok];
                if (pt == T_CHAR) {
                    TK_NEED(1);
                    out[olen++] = (uint8_t)(plc->ints[ntok] & 0xFF);
                    types[ntok] = T_CHAR;
                    ints[ntok] = plc->ints[ntok];
                } else if (pt == T_ALPHA) {
                    if (plc->ints[ntok] < 0) goto done;
                    int32_t alen = plc->ints[ntok];
                    TK_NEED(alen);
                    types[ntok] = T_ALPHA;
                    strs[ntok] = (int32_t)(olen - me->name_off);
                    ints[ntok] = alen;
                    memcpy(out + olen, p_name + plc->strs[ntok], alen);
                    olen += alen;
                } else if (pt == T_DIGITS) {
                    uint32_t v = (uint32_t)plc->ints[ntok];
                    TK_NEED(10);
                    if (v) {
                        char tmp[12];
                        int tl = 0;
                        uint32_t vv = v;
                        while (vv) { tmp[tl++] = (char)('0' + vv % 10); vv /= 10; }
                        while (tl) out[olen++] = (uint8_t)tmp[--tl];
                    }
                    types[ntok] = T_DIGITS;
                    ints[ntok] = plc->ints[ntok];
                } else if (pt == T_DIGITS0) {
                    uint32_t v = (uint32_t)plc->ints[ntok];
                    int l = plc->strs[ntok] > 9 ? 9 : plc->strs[ntok];
                    if (l < 0) goto done;
                    TK_NEED(l);
                    uint32_t vv = v;
                    for (int k = l; k > 0; k--) {
                        out[olen + k - 1] = (uint8_t)(48 + vv % 10);
                        vv /= 10;
                    }
                    olen += l;
                    types[ntok] = T_DIGITS0;
                    ints[ntok] = plc->ints[ntok];
                    strs[ntok] = plc->strs[ntok];
                } else {
                    goto done;
                }
            } else {    /* T_END or elided */
                types[ntok] = T_END;
                me->ntok = ntok;
                me->name_len = (int32_t)(olen - me->name_off);
                if (olen + 1 > out_cap) goto done;
                out[olen++] = 0;
                ended = 1;
                break;
            }
        }
        if (!ended) goto done;
    }
    ret = olen;
done:
    free(cur);
    free(lc);
    free(tarena);
    return ret;
#undef TK_GET_TYPE
#undef TK_GET
#undef TK_NEED
}

/* ---------------------------------------------------------------- */
/* batched header serializers for the device table builders           */
/* (ops/tables_v2.py).  The device computes histograms + normalised   */
/* frequencies (bit-exact normalise_freq replay); these emit the      */
/* byte-identical headers of r16_build_tables_o1_dense /             */
/* r16_build_tables_o0 from those frequencies in one call per batch. */

static int put_freq_row_dense(uint8_t *p, const uint16_t *Frow, int a) {
    int n = 0, dz = 0;
    for (int k = 0; k < a; k++) {
        uint32_t f = Frow[k];
        if (f) {
            if (dz) { n -= dz - 1; p[n++] = (uint8_t)(dz - 1); }
            dz = 0;
            n += vput(p + n, f);
        } else {
            dz++;
            p[n++] = 0;
        }
    }
    if (dz) { n -= dz - 1; p[n++] = (uint8_t)(dz - 1); }
    return n;
}

/* order-1 header epilogue: rANS-pack the table block when large
 * (mirrors rANS_static4x16pr.c:746-766).  Returns the new length. */
static int64_t o1_hdr_compress(uint8_t *hdr, int64_t hl) {
    if (hl <= 1000) return hl;
    int64_t u_sz = hl - 1;
    uint8_t *cbuf = malloc(u_sz + 1024);
    if (!cbuf) return hl;
    int64_t c_sz = r16_enc_o0(hdr + 1, u_sz, cbuf, u_sz + 1024);
    if (c_sz > 0 && c_sz + 6 < hl) {
        uint8_t tmp[16];
        int m = 0;
        tmp[m++] = hdr[0] | 1;
        m += vput(tmp + m, (uint32_t)u_sz);
        m += vput(tmp + m, (uint32_t)c_sz);
        memcpy(hdr, tmp, m);
        memcpy(hdr + m, cbuf, c_sz);
        hl = m + c_sz;
    }
    free(cbuf);
    return hl;
}

API int64_t r16_serialize_o1_dense_batch(
        const uint8_t *alphas,      /* (B, Apad) sorted, last-padded */
        const int32_t *asz,         /* (B,) true alphabet sizes      */
        const uint16_t *freqs,      /* (B, Apad, Apad) pre-shift     */
        const int32_t *shifts,      /* (B,) 10 or 12                 */
        int32_t B, int32_t Apad,
        uint8_t *arena, int64_t arena_cap,
        int64_t *offs /* (B+1,) */) {
    static __thread uint8_t *scratch = NULL;
    if (!scratch) {
        scratch = malloc(HDR_CAP_O1);
        if (!scratch) return -2;
    }
    int64_t pos = 0;
    for (int32_t b = 0; b < B; b++) {
        int a = asz[b];
        if (a < 1 || a > Apad || a > 256) return -2;
        const uint8_t *al = alphas + (int64_t)b * Apad;
        uint32_t A[256];
        memset(A, 0, sizeof A);
        for (int k = 0; k < a; k++) A[al[k]] = 1;
        uint8_t *hdr = scratch;
        int64_t hl = 1;
        hl += put_alphabet(hdr + hl, A);
        const uint16_t *F = freqs + (int64_t)b * Apad * Apad;
        for (int k = 0; k < a; k++)
            hl += put_freq_row_dense(hdr + hl, F + (int64_t)k * Apad, a);
        hdr[0] = (uint8_t)(shifts[b] << 4);
        hl = o1_hdr_compress(hdr, hl);
        if (pos + hl > arena_cap) return -1;
        memcpy(arena + pos, hdr, hl);
        offs[b] = pos;
        pos += hl;
    }
    offs[B] = pos;
    return pos;
}

/* Sparse 12-bit header transport consumer (tables_v2.pack_freqs_sparse12):
 * presence bitmap (LSB-first over Apad*Apad entries) + per-row-compacted
 * 12-bit values (3 bytes per value pair, possibly a prefix of the full
 * packed width).  Expands each block into a dense row buffer, restores
 * any wrapped 4096 entry via the row-sum deficit, validates that every
 * context row is normalised (power-of-two total <= 4096 — transport
 * sanity, ADVICE r3), then emits the byte-identical header of
 * r16_build_tables_o1_dense.  This replaces the numpy sparse unpack
 * (measured 8.8 s at B=12288, A=48 on this 1-core host — the reason
 * the 28 MB 's12' transport lost to the 42.5 MB 'p12' in round 4).
 * Returns the arena bytes used, or -1 (arena too small), -2 (bad
 * alphabet size / no memory), -3 (value prefix narrower than a row's
 * nonzero count), -4 (a context row not normalised), -5 (a bitmap bit
 * set past the Apad*Apad entries). */
API int64_t r16_serialize_o1_sparse12_batch(
        const uint8_t *alphas,      /* (B, Apad) sorted, last-padded */
        const int32_t *asz,         /* (B,) true alphabet sizes      */
        const uint8_t *bitmap,      /* (B, BM) presence bits         */
        const uint8_t *vals12,      /* (B, VW) packed nonzero values */
        const int32_t *shifts,      /* (B,) 10 or 12                 */
        int32_t B, int32_t Apad, int32_t BM, int32_t VW,
        uint8_t *arena, int64_t arena_cap,
        int64_t *offs /* (B+1,) */) {
    static __thread uint8_t *scratch = NULL;
    static __thread uint16_t *fbuf = NULL;
    static __thread int fbuf_n = 0;
    if (!scratch) {
        scratch = malloc(HDR_CAP_O1);
        if (!scratch) return -2;
    }
    int E = Apad * Apad;
    if (fbuf_n < E) {
        free(fbuf);
        fbuf = malloc((size_t)E * sizeof(uint16_t));
        if (!fbuf) { fbuf_n = 0; return -2; }
        fbuf_n = E;
    }
    int maxv = (VW / 3) * 2;        /* values representable in prefix */
    int64_t pos = 0;
    for (int32_t b = 0; b < B; b++) {
        int a = asz[b];
        if (a < 1 || a > Apad || a > 256) return -2;
        const uint8_t *bm = bitmap + (int64_t)b * BM;
        const uint8_t *vp = vals12 + (int64_t)b * VW;
        memset(fbuf, 0, (size_t)E * sizeof(uint16_t));
        int r = 0;
        for (int e8 = 0; e8 < BM; e8++) {
            uint32_t bits = bm[e8];
            while (bits) {
                int bit = __builtin_ctz(bits);
                bits &= bits - 1;
                int e = e8 * 8 + bit;
                if (e >= E) return -5;             /* pad bit set */
                if (r >= maxv) return -3;          /* prefix too narrow */
                const uint8_t *p3 = vp + (r >> 1) * 3;
                uint32_t v = (r & 1)
                    ? (uint32_t)(p3[1] >> 4) | ((uint32_t)p3[2] << 4)
                    : (uint32_t)p3[0] | (((uint32_t)p3[1] & 0xF) << 8);
                fbuf[e] = (uint16_t)v;
                r++;
            }
        }
        /* row totals: restore a wrapped 4096, then validate */
        for (int k = 0; k < a; k++) {
            uint16_t *Frow = fbuf + (int64_t)k * Apad;
            uint32_t rs = 0, mx = 0;
            int mi = 0;
            for (int j = 0; j < a; j++) {
                rs += Frow[j];
                if (Frow[j] > mx) { mx = Frow[j]; mi = j; }
            }
            if (rs == 4095) { Frow[mi]++; rs++; }
            if (rs && (((rs & (rs - 1)) != 0) || rs > 4096))
                return -4;
        }
        const uint8_t *al = alphas + (int64_t)b * Apad;
        uint32_t A[256];
        memset(A, 0, sizeof A);
        for (int k = 0; k < a; k++) A[al[k]] = 1;
        uint8_t *hdr = scratch;
        int64_t hl = 1;
        hl += put_alphabet(hdr + hl, A);
        for (int k = 0; k < a; k++)
            hl += put_freq_row_dense(hdr + hl, fbuf + (int64_t)k * Apad, a);
        hdr[0] = (uint8_t)(shifts[b] << 4);
        hl = o1_hdr_compress(hdr, hl);
        if (pos + hl > arena_cap) return -1;
        memcpy(arena + pos, hdr, hl);
        offs[b] = pos;
        pos += hl;
    }
    offs[B] = pos;
    return pos;
}

API int64_t r16_serialize_o0_batch(
        const uint16_t *freqs,      /* (B, 256) pre-shift            */
        int32_t B,
        uint8_t *arena, int64_t arena_cap,
        int64_t *offs /* (B+1,) */) {
    int64_t pos = 0;
    for (int32_t b = 0; b < B; b++) {
        const uint16_t *Fr = freqs + (int64_t)b * 256;
        uint32_t F[256];
        for (int j = 0; j < 256; j++) F[j] = Fr[j];
        uint8_t hdr[HDR_CAP_O0];
        int hl = put_freq0(hdr, F);
        if (pos + hl > arena_cap) return -1;
        memcpy(arena + pos, hdr, hl);
        offs[b] = pos;
        pos += hl;
    }
    offs[B] = pos;
    return pos;
}

/* ---------------------------------------------------------------- */
/* fqz parameter-picker statistics (models/fqz.py qual_stats fast    */
/* path; reference fqzcomp_qual.c:418-693).  One pass each instead   */
/* of the stack of full-length numpy temporaries.                    */

API int64_t fqz_stats1(const uint8_t *data, int64_t n,
                       const int64_t *st, const int64_t *ls, int64_t nseg,
                       int64_t nrec,     /* real records; the trailing
                                            tail pseudo-segment never
                                            counts as a duplicate     */
                       const uint8_t *d2f,
                       int64_t *hb,      /* (128,256) all            */
                       int64_t *h2,      /* (128,256) read-2 only    */
                       int64_t *sums,    /* (nseg,) byte sums        */
                       int64_t *dedup) {
    memset(hb, 0, 128 * 256 * sizeof(*hb));
    memset(h2, 0, 128 * 256 * sizeof(*h2));
    int64_t dd = 0;
    for (int64_t s = 0; s < nseg; s++) {
        const uint8_t *p = data + st[s];
        int64_t L = ls[s];
        if (st[s] < 0 || L < 0 || st[s] + L > n) return -1;
        if (s > 0 && s < nrec && L == ls[s - 1] && st[s] >= L &&
            memcmp(p - L, p, (size_t)L) == 0)
            dd++;
        int64_t acc = 0;
        int64_t *h = d2f[s] ? h2 : NULL;
        int64_t lm = L & 127;
        for (int64_t off = 0; off < L; off++) {
            int64_t pos = (lm - (off & 127)) & 127;
            int b = p[off];
            acc += b;
            hb[pos * 256 + b]++;
            if (h) h[pos * 256 + b]++;
        }
        sums[s] = acc;
    }
    *dedup = dd;
    return 0;
}

API int64_t fqz_stats2(const uint8_t *data, int64_t n,
                       const int64_t *st, const int64_t *ls, int64_t nseg,
                       const uint8_t *qb4,
                       int64_t *k4 /* (4,128,256) */) {
    memset(k4, 0, 4 * 128 * 256 * sizeof(*k4));
    for (int64_t s = 0; s < nseg; s++) {
        const uint8_t *p = data + st[s];
        int64_t L = ls[s];
        if (st[s] < 0 || L < 0 || st[s] + L > n || qb4[s] > 3) return -1;
        int64_t *k = k4 + (int64_t)qb4[s] * 128 * 256;
        int64_t lm = L & 127;
        for (int64_t off = 0; off < L; off++) {
            int64_t pos = (lm - (off & 127)) & 127;
            k[pos * 256 + p[off]]++;
        }
    }
    return 0;
}

/* ---------------------------------------------------------------- */
/* full rANS 4x16 transform wrapper (non-STRIPE): bit-pack + RLE +   */
/* framing + CAT fallback, byte-identical to models/rans4x16.py      */
/* compress() (reference rANS_static4x16pr.c:1218-1406).  Hot for    */
/* the tok3 descriptor method search (up to 9 candidate encodes per  */
/* descriptor, all previously Python+numpy per call).                */

enum { W_PACK = 0x80, W_RLE = 0x40, W_CAT = 0x20, W_NOSZ = 0x10 };

/* bit-pack per ops/pack.py pack() / reference pack.c:56-84.
 * Returns packed length (>= 0) with meta in mbuf/mlen, or -1 when the
 * alphabet is 17..255 wide (caller clears the flag). */
static int64_t w_pack(const uint8_t *in, int64_t n, uint8_t *out,
                      uint8_t *mbuf, int *mlen) {
    uint32_t present[256];
    memset(present, 0, sizeof present);
    for (int64_t i = 0; i < n; i++) present[in[i]] = 1;
    uint8_t code[256], syms[256];
    int ns = 0;
    for (int j = 0; j < 256; j++) {
        if (present[j]) {
            code[j] = (uint8_t)ns;
            syms[ns++] = (uint8_t)j;
        }
    }
    if (ns > 16) {
        mbuf[0] = (uint8_t)(ns & 0xFF);
        *mlen = 1;
        if (ns <= 255) return -1;       /* 17..255: flag cleared      */
        memcpy(out, in, n);             /* 256: verbatim, meta 0      */
        return n;
    }
    mbuf[0] = (uint8_t)ns;
    memcpy(mbuf + 1, syms, ns);
    *mlen = 1 + ns;
    int64_t o = 0;
    if (ns > 4) {                       /* 2 per byte */
        int64_t half = n / 2 * 2;
        for (int64_t i = 0; i < half; i += 2)
            out[o++] = (uint8_t)(code[in[i]] | (code[in[i + 1]] << 4));
        if (n & 1) out[o++] = code[in[half]];
    } else if (ns > 2) {                /* 4 per byte */
        int64_t q = n / 4 * 4;
        for (int64_t i = 0; i < q; i += 4)
            out[o++] = (uint8_t)(code[in[i]] | (code[in[i + 1]] << 2)
                                 | (code[in[i + 2]] << 4)
                                 | (code[in[i + 3]] << 6));
        if (n != q) {
            int t = 0;
            for (int64_t k = q; k < n; k++)
                t |= code[in[k]] << (2 * (k - q));
            out[o++] = (uint8_t)t;
        }
    } else if (ns > 1) {                /* 8 per byte */
        int64_t e = n / 8 * 8;
        for (int64_t i = 0; i < e; i += 8) {
            int t = 0;
            for (int b = 0; b < 8; b++) t |= code[in[i + b]] << b;
            out[o++] = (uint8_t)t;
        }
        if (n != e) {
            int t = 0;
            for (int64_t k = e; k < n; k++)
                t |= code[in[k]] << (k - e);
            out[o++] = (uint8_t)t;
        }
    }
    /* ns <= 1: zero payload bytes */
    return o;
}

/* RLE transform per ops/rle.py encode() / reference rle.c: scoring
 * pass picks the coded symbols, runs split into literals + varint
 * (len-1) streams.  Returns literal count; meta (nsyms byte + syms +
 * run varints) in meta/meta_len. */
static int64_t w_rle(const uint8_t *in, int64_t n, uint8_t *lits,
                     uint8_t *meta, int64_t *meta_len) {
    int64_t saved[256];
    memset(saved, 0, sizeof saved);
    for (int64_t i = 0; i < n; i++)
        saved[in[i]] += (i > 0 && in[i] == in[i - 1]) ? 1 : -1;
    uint8_t keep[256];
    int nsym = 0;
    for (int j = 0; j < 256; j++) {
        keep[j] = saved[j] > 0;
        nsym += keep[j];
    }
    meta[0] = (uint8_t)(nsym & 0xFF);
    int64_t mp = 1;
    for (int j = 0; j < 256; j++)
        if (keep[j]) meta[mp++] = (uint8_t)j;
    int64_t nl = 0;
    for (int64_t i = 0; i < n;) {
        int64_t j = i + 1;
        while (j < n && in[j] == in[i]) j++;
        if (keep[in[i]]) {
            lits[nl++] = in[i];
            mp += vput(meta + mp, (uint32_t)(j - i - 1));
        } else {
            for (int64_t k = i; k < j; k++) lits[nl++] = in[k];
        }
        i = j;
    }
    *meta_len = mp;
    return nl;
}

/* Full wrapper encode.  Returns stream length, or a negative code for
 * the cases the Python caller keeps (-3: stripe/empty/unsupported). */
API int64_t r16_compress_wrapped(const uint8_t *in, int64_t n,
                                 int32_t order, uint8_t *out,
                                 int64_t cap) {
    if ((order & 0x08) || n <= 0)
        return -3;                     /* STRIPE / empty: Python path */
    if (cap < n + 1024 + 2 * n)
        return -2;
    if (order & W_CAT) {
        int64_t o = 0;
        out[o++] = W_CAT;
        o += vput(out + o, (uint32_t)n);
        memcpy(out + o, in, n);
        return o + n;
    }
    int do_pack = order & W_PACK;
    int do_rle = order & W_RLE;
    int no_size = order & W_NOSZ;
    int64_t o = 0;
    out[o++] = (uint8_t)(order & 0xFF);
    if (!no_size) o += vput(out + o, (uint32_t)n);
    order &= 0xF;

    uint8_t *pbuf = NULL, *lbuf = NULL, *rmeta = NULL, *crm = NULL;
    const uint8_t *data = in;
    int64_t dn = n;
    int64_t ret = -1;

    if (do_pack) {
        uint8_t mbuf[17];
        int mlen = 0;
        pbuf = malloc(dn + 8);
        if (!pbuf) goto done;
        int64_t pl = w_pack(data, dn, pbuf, mbuf, &mlen);
        if (pl < 0) {
            out[0] &= (uint8_t)~W_PACK;
        } else {
            data = pbuf;
            dn = pl;
            memcpy(out + o, mbuf, mlen);
            o += mlen;
            o += vput(out + o, (uint32_t)dn);
        }
    }

    if (do_rle && dn) {
        lbuf = malloc(dn + 8);
        rmeta = malloc(dn + 300 + 8);
        if (!lbuf || !rmeta) goto done;
        int64_t mlen64 = 0;
        int64_t rl = w_rle(data, dn, lbuf, rmeta, &mlen64);
        if ((double)rl + (double)mlen64 >= 0.99 * (double)dn) {
            out[0] &= (uint8_t)~W_RLE;
        } else {
            crm = malloc(mlen64 + 1024 + 257 * 3 + 64);
            if (!crm) goto done;
            int64_t cl = r16_enc_o0(rmeta, mlen64,
                                    crm, mlen64 + 1024 + 257 * 3 + 64);
            if (cl > 0 && cl < mlen64) {
                o += vput(out + o, (uint32_t)(2 * mlen64));
                o += vput(out + o, (uint32_t)rl);
                o += vput(out + o, (uint32_t)cl);
                memcpy(out + o, crm, cl);
                o += cl;
            } else {
                o += vput(out + o, (uint32_t)(2 * mlen64 + 1));
                o += vput(out + o, (uint32_t)rl);
                memcpy(out + o, rmeta, mlen64);
                o += mlen64;
            }
            data = lbuf;
            dn = rl;
        }
    } else if (do_rle) {
        out[0] &= (uint8_t)~W_RLE;
    }

    if (order && dn < 8) {
        out[0] &= (uint8_t)~1;
        order = 0;
    }
    if (dn == 0) { ret = -3; goto done; }  /* empty body: Python path */

    {
        /* body is order-1 ONLY for order==1: the low nibble can hold
         * 2..15 and the reference codes those O0
         * (rANS_static4x16pr.c:1327) */
        int64_t bl = order == 1
            ? r16_enc_o1(data, dn, out + o, cap - o)
            : r16_enc_o0(data, dn, out + o, cap - o);
        if (bl < 0) { ret = -1; goto done; }
        if (bl >= dn) {                     /* CAT fallback */
            out[0] = (uint8_t)((out[0] & ~3) | W_CAT | no_size);
            if (o + dn > cap) { ret = -1; goto done; }
            memcpy(out + o, data, dn);
            bl = dn;
        }
        ret = o + bl;
    }
 done:
    free(pbuf);
    free(lbuf);
    free(rmeta);
    free(crm);
    return ret;
}
