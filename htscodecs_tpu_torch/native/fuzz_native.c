/*
 * Coverage-guided fuzz harness for the port's native host kernels
 * (hostkernels.c in this directory), the counterpart of the JAX
 * package's htscodecs_tpu/native/fuzz_native.c.
 *
 * It mirrors the htscodecs libFuzzer targets (rans4x16pr, rANS_static,
 * arith, fqzcomp and tokenise_name3 fuzzers under ASan) as a
 * self-contained gcc build, since clang/libFuzzer is not assumed:
 *   gcc -O1 -g -fsanitize=address -c fuzz_cov.c
 *   gcc -O1 -g -fsanitize=address -fsanitize-coverage=trace-pc \
 *       -o fuzz_native fuzz_native.c fuzz_cov.o -lm
 * (hostkernels.c is #included so its static internals are covered.)
 * `python3 -m htscodecs_tpu_torch.native.fuzz SECONDS [MAX_LEN]` builds
 * both, writes a seed corpus from the port's own encoders and runs it.
 *
 * Edge coverage comes from __sanitizer_cov_trace_pc into a global
 * bitmap; inputs that light new edges join the in-memory corpus and
 * are mutated preferentially (bit flips, byte stores, truncations,
 * splices): a minimal AFL-style loop.  Every entry of hostkernels.c
 * that parses bytes a decoder reads is dispatched on the first input
 * byte (modulo NSEL):
 *
 *    0- 1  r16_dec_o0 / r16_dec_o1 (1 MiB output)
 *    2- 4  r16_parse_tables_o0 / _o1 / _o1_dense
 *    5     tok3_detokenize, the arena carved into equal descriptors
 *    6- 9  arith_dec_o0 / _o1 / _o0_rle / _o1_rle
 *   10     fqz_dec with pseudo-random in-range parameters, one set
 *   11-12  r16_dec_o0 / _o1 under tight output caps
 *
 * as the JAX package's harness, and these, which it does not reach:
 *
 *   13     fqz_dec from a serialised parameter set (the tables
 *          models/fqz.py parses from a stream and native.fqz_dec_scan
 *          passes): up to two sets, the selector model, the symbol
 *          table, reverse-complement flags and the wide (max symbol
 *          >= 64) model path;
 *   14     r16_serialize_o1_sparse12_batch: the 12-bit header
 *          serialiser, whose presence bitmap and values are copied back
 *          from the card (native.serialize_o1_sparse12_batch), with the
 *          port's own -5 (pad bit) code;
 *   15     arith_dec_o0 / _o1 / _o0_rle / _o1_rle under tight output
 *          caps;
 *   16     tok3_detokenize from framed descriptors (real token streams
 *          with their own lengths, as models/tok3.py passes them).
 *
 * Usage: fuzz_native <seed_dir> <seconds> [max_len]
 * Each seed file is added as it is (its first byte is its selector) and
 * once behind every other selector.  Exit 0 = ran to its time budget
 * with no sanitizer report (ASan aborts the process on any finding).
 */

#include <dirent.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "hostkernels.c"

enum { NSEL = 17 };

/* ---------- coverage (callback lives in fuzz_cov.c, which is
 * compiled WITHOUT -fsanitize-coverage: gcc instruments this TU's
 * functions, including any callback defined here, which would recurse
 * forever) ---------- */
extern uint8_t cov_seen[1 << 16];
extern uint8_t cov_run[1 << 16];
extern size_t cov_new;

/* ---------- targets ---------- */
static uint8_t obuf[1 << 20];
static uint32_t lens_buf[4096];
static uint8_t revs_buf[4096];

static uint32_t le16(const uint8_t *p) { return p[0] | (p[1] << 8); }
static uint32_t le32(const uint8_t *p) {
    return le16(p) | ((uint32_t)le16(p + 2) << 16);
}

/* selector 13: gflags, nparam-1, max_sel, max_sym, total (u32) and the
 * 256-entry symbol table, then per set FQZ_PM_WORDS u16 words, qmap
 * (256 u8), then qtab, ptab (1024) and dtab as u16 (the decoder keeps
 * 16 context bits, so the tables' low 16 bits are all it reads), then
 * the range-coded payload */
enum { FQZ_HDR = 8 + 256,
       FQZ_SET = 2 * FQZ_PM_WORDS + 256 + 2 * (256 + 1024 + 256) };

static void run_fqz_serialised(const uint8_t *d, size_t n) {
    if (n < FQZ_HDR) return;
    int gflags = d[0] & 7;
    int nparam = 1 + (d[1] & 1);
    int max_sel = d[2];
    int max_sym = d[3];
    int64_t total = le32(d + 4);
    if (n < FQZ_HDR + (size_t)nparam * FQZ_SET) return;
    if (total > (int64_t)sizeof obuf) total = sizeof obuf;
    static uint32_t pm[2 * FQZ_PM_WORDS], qmap[512], qtab[512],
        ptab[2048], dtab[512];
    const uint8_t *stab = d + 8;
    const uint8_t *s = d + FQZ_HDR;
    for (int x = 0; x < nparam; x++, s += FQZ_SET) {
        const uint8_t *q = s;
        for (int i = 0; i < FQZ_PM_WORDS; i++, q += 2)
            pm[x * FQZ_PM_WORDS + i] = le16(q);
        /* shifts and flags as the parameter reader bounds them */
        pm[x * FQZ_PM_WORDS + 2] &= 15;     /* qbits  */
        pm[x * FQZ_PM_WORDS + 3] &= 15;     /* qshift */
        pm[x * FQZ_PM_WORDS + 4] &= 15;     /* qloc   */
        pm[x * FQZ_PM_WORDS + 5] &= 15;     /* sloc   */
        for (int i = 9; i < 12; i++) pm[x * FQZ_PM_WORDS + i] &= 1;
        for (int i = 0; i < 256; i++) qmap[x * 256 + i] = *q++;
        for (int i = 0; i < 256; i++, q += 2) qtab[x * 256 + i] = le16(q);
        for (int i = 0; i < 1024; i++, q += 2) ptab[x * 1024 + i] = le16(q);
        for (int i = 0; i < 256; i++, q += 2) dtab[x * 256 + i] = le16(q);
    }
    fqz_dec(s, (int64_t)(d + n - s), total, gflags, nparam, max_sel,
            max_sym, stab, pm, qmap, qtab, ptab, dtab, obuf, lens_buf,
            revs_buf, 4096);
}

/* selector 14: B (1..4), Apad (8..256), bitmap and value widths, then
 * per block its alphabet size, shift bit, alphabet, bitmap and values:
 * the shapes native.serialize_o1_sparse12_batch passes */
static void run_sparse12(const uint8_t *d, size_t n) {
    if (n < 4) return;
    int B = 1 + (d[0] & 3);
    int Apad = 8 * (1 + (d[1] & 31));
    int BM = (Apad * Apad + 7) / 8;
    int VW = 3 * (1 + d[2] + 256 * (d[3] & 7));
    size_t per = 2 + (size_t)Apad + BM + VW;
    if (n < 4 + (size_t)B * per) return;
    uint8_t *al = malloc((size_t)B * Apad), *bm = malloc((size_t)B * BM),
        *vv = malloc((size_t)B * VW);
    int32_t asz[4], sh[4];
    int64_t offs[5];
    int64_t cap = (int64_t)B * (3 * Apad * Apad + 3 * Apad + 80) + 64;
    uint8_t *arena = malloc(cap);
    const uint8_t *p = d + 4;
    for (int b = 0; b < B; b++) {
        asz[b] = p[0];      /* 0 and > Apad are refused: -2 */
        sh[b] = p[1] & 1 ? 12 : 10;
        p += 2;
        memcpy(al + (size_t)b * Apad, p, Apad); p += Apad;
        memcpy(bm + (size_t)b * BM, p, BM); p += BM;
        memcpy(vv + (size_t)b * VW, p, VW); p += VW;
    }
    if (al && bm && vv && arena)
        r16_serialize_o1_sparse12_batch(al, asz, bm, vv, sh, B, Apad, BM,
                                        VW, arena, cap, offs);
    free(al); free(bm); free(vv); free(arena);
}

/* selector 16: max_tok, nreads (u16), the descriptor count, then per
 * descriptor its token-block id (u16) and length (u24), then the arena
 * they index in order; lengths past the arena's end are cut there */
static void run_tok3_framed(const uint8_t *d, size_t n) {
    if (n < 4) return;
    int max_tok = d[0];
    int64_t nreads = 1 + le16(d + 1);
    int nd = d[3];
    size_t head = 4 + 5 * (size_t)nd;
    if (n < head) return;
    static int64_t doffs[TK_MAX_TBLOCKS], dls[TK_MAX_TBLOCKS];
    for (int i = 0; i < TK_MAX_TBLOCKS; i++) { doffs[i] = 0; dls[i] = -1; }
    const uint8_t *arena = d + head;
    size_t alen = n - head, off = 0;
    for (int k = 0; k < nd; k++) {
        const uint8_t *e = d + 4 + 5 * k;
        int tid = le16(e) % TK_MAX_TBLOCKS;
        size_t len = e[2] | (e[3] << 8) | ((size_t)e[4] << 16);
        if (len > alen - off) len = alen - off;
        doffs[tid] = (int64_t)off;
        dls[tid] = (int64_t)len;
        off += len;
    }
    tok3_detokenize(arena, doffs, dls, max_tok, nreads, obuf, sizeof obuf);
}

static void run_one(const uint8_t *d, size_t n) {
    if (n < 2) return;
    int sel = d[0] % NSEL;
    d++; n--;
    switch (sel) {
    case 0:
        r16_dec_o0((uint8_t *)d, n, obuf, sizeof obuf);
        break;
    case 1:
        r16_dec_o1((uint8_t *)d, n, obuf, sizeof obuf);
        break;
    case 2: {
        uint8_t ssym[4096];
        uint16_t sfreq[4096], sbase[4096];
        r16_parse_tables_o0((uint8_t *)d, n, ssym, sfreq, sbase);
        break;
    }
    case 3: {
        static uint8_t sfb[256 * 4096];
        static uint16_t f2d[65536], b2d[65536];
        int32_t sh;
        r16_parse_tables_o1((uint8_t *)d, n, sfb, f2d, b2d, &sh);
        break;
    }
    case 4: {
        uint8_t alpha[96];
        static int32_t packed[96 * 96];
        int32_t na, sh;
        r16_parse_tables_o1_dense((uint8_t *)d, n, alpha, packed, 96,
                                  &na, &sh);
        break;
    }
    case 5: {
        /* tok3 replay: first bytes carve the arena into descriptors */
        if (n < 8) return;
        int nblk = 1 + (d[0] & 63);
        int max_tok = 1 + (d[1] & 127);
        int64_t nreads = 1 + (d[2] | (d[3] << 4));
        static int64_t doffs[TK_MAX_TBLOCKS], dls[TK_MAX_TBLOCKS];
        for (int i = 0; i < TK_MAX_TBLOCKS; i++) { doffs[i] = 0; dls[i] = -1; }
        size_t body = n - 4;
        const uint8_t *arena = d + 4;
        size_t per = body / (size_t)nblk;
        for (int i = 0; i < nblk && i < TK_MAX_TBLOCKS; i++) {
            int tid = (d[4 + (i % 4)] + i * 17) % TK_MAX_TBLOCKS;
            doffs[tid] = (int64_t)(i * per);
            dls[tid] = (int64_t)per;
        }
        tok3_detokenize((uint8_t *)arena, doffs, dls, max_tok, nreads,
                        obuf, sizeof obuf);
        break;
    }
    case 6:
        arith_dec_o0((uint8_t *)d, n, obuf, sizeof obuf);
        break;
    case 7:
        arith_dec_o1((uint8_t *)d, n, obuf, sizeof obuf);
        break;
    case 8:
        arith_dec_o0_rle((uint8_t *)d, n, obuf, sizeof obuf);
        break;
    case 9:
        arith_dec_o1_rle((uint8_t *)d, n, obuf, sizeof obuf);
        break;
    case 10: {
        /* fqz decode with pseudo-random but in-range parameters */
        if (n < 16) return;
        uint32_t pm[FQZ_PM_WORDS];
        static uint32_t qmap[256], qtab[256], ptab[1024], dtab[256];
        uint8_t stab[256];
        memset(pm, 0, sizeof pm);
        pm[2] = d[0] & 15;          /* qbits  */
        pm[3] = d[1] & 7;           /* qshift */
        pm[4] = d[2] & 15;          /* qloc   */
        pm[5] = d[3] & 15;          /* sloc   */
        pm[9] = d[4] & 1;           /* fixed_len */
        pm[10] = 0;                 /* do_sel */
        pm[11] = d[5] & 1;          /* do_dedup */
        int max_sym = 1 + (d[6] & 63);
        pm[8] = (uint32_t)max_sym;
        for (int i = 0; i < 256; i++) {
            qmap[i] = (uint32_t)(i % (max_sym + 1));
            qtab[i] = (uint32_t)(d[7 + (i & 7)] & 15);
            dtab[i] = (uint32_t)(i & 255);
            stab[i] = 0;
        }
        for (int i = 0; i < 1024; i++) ptab[i] = (uint32_t)(i & 1023);
        int64_t total = 1 + (d[8] | (d[9] << 8));
        if (total > (int64_t)sizeof obuf) total = sizeof obuf;
        fqz_dec((uint8_t *)d + 16, n - 16, total, 0, 1, 0, max_sym,
                stab, pm, qmap, qtab, ptab, dtab, obuf, lens_buf,
                revs_buf, 4096);
        break;
    }
    case 11:
        /* tight output caps exercise the bounded-output contract */
        r16_dec_o0((uint8_t *)d, n, obuf, 1 + (d[0] & 63));
        break;
    case 12:
        r16_dec_o1((uint8_t *)d, n, obuf, 1 + (d[0] & 63));
        break;
    case 13:
        run_fqz_serialised(d, n);
        break;
    case 14:
        run_sparse12(d, n);
        break;
    case 15: {
        if (n < 3) return;
        size_t cap = 1 + (d[0] & 63);
        switch (d[1] & 3) {
        case 0: arith_dec_o0(d + 2, n - 2, obuf, cap); break;
        case 1: arith_dec_o1(d + 2, n - 2, obuf, cap); break;
        case 2: arith_dec_o0_rle(d + 2, n - 2, obuf, cap); break;
        default: arith_dec_o1_rle(d + 2, n - 2, obuf, cap);
        }
        break;
    }
    default:
        run_tok3_framed(d, n);
    }
}

/* ---------- corpus + mutation loop ---------- */
typedef struct { uint8_t *d; size_t n; } entry;
static entry corpus[4096];
static int ncorpus;

static uint64_t rngs = 0x9E3779B97F4A7C15ull;
static uint64_t rnd(void) {
    rngs ^= rngs << 13; rngs ^= rngs >> 7; rngs ^= rngs << 17;
    return rngs;
}

static void add_corpus(const uint8_t *d, size_t n) {
    if (ncorpus >= 4096 || n == 0) return;
    entry *e = &corpus[ncorpus++];
    e->d = malloc(n);
    memcpy(e->d, d, n);
    e->n = n;
}

int main(int argc, char **argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: %s <seed_dir> <seconds> [max_len]\n",
                argv[0]);
        return 2;
    }
    int seconds = atoi(argv[2]);
    size_t max_len = argc > 3 ? (size_t)atol(argv[3]) : (size_t)65536;
    if (max_len < 64) max_len = 64;
    if (max_len > 65536) max_len = 65536;

    static uint8_t tmp[65536];
    DIR *dir = opendir(argv[1]);
    if (dir) {
        struct dirent *de;
        while ((de = readdir(dir))) {
            char path[4096];
            snprintf(path, sizeof path, "%s/%s", argv[1], de->d_name);
            FILE *f = fopen(path, "rb");
            if (!f) continue;
            size_t n = fread(tmp, 1, sizeof tmp, f);
            fclose(f);
            if (n > max_len) n = max_len;
            if (n < 2) continue;
            /* as written, then behind every other selector, so that
             * each target sees real structure */
            uint8_t own = tmp[0];
            for (int s = 0; s < NSEL; s++) {
                tmp[0] = (uint8_t)((own + s) % NSEL);
                add_corpus(tmp, n);
            }
        }
        closedir(dir);
    }
    if (!ncorpus) {
        uint8_t z[64];
        memset(z, 0, sizeof z);
        add_corpus(z, sizeof z);
    }

    /* run the seeds to set the baseline coverage */
    for (int i = 0; i < ncorpus; i++) {
        memset(cov_run, 0, sizeof cov_run);
        run_one(corpus[i].d, corpus[i].n);
    }

    static uint8_t work[1 << 17];
    time_t t0 = time(NULL);
    long iters = 0, adds = 0;
    while (time(NULL) - t0 < seconds) {
        entry *e = &corpus[rnd() % (uint64_t)ncorpus];
        size_t n = e->n < max_len ? e->n : max_len;
        memcpy(work, e->d, n);
        int nmut = 1 + (int)(rnd() & 7);
        for (int m = 0; m < nmut; m++) {
            switch (rnd() % 6) {
            case 0:            /* bit flip */
                work[rnd() % n] ^= (uint8_t)(1u << (rnd() & 7));
                break;
            case 1:            /* random byte */
                work[rnd() % n] = (uint8_t)rnd();
                break;
            case 2:            /* truncate */
                if (n > 2) n = 1 + rnd() % (n - 1);
                break;
            case 3: {          /* splice from another corpus entry */
                entry *o = &corpus[rnd() % (uint64_t)ncorpus];
                size_t at = rnd() % n;
                size_t len = rnd() % (n - at);
                size_t oa = o->n ? rnd() % o->n : 0;
                size_t avail = o->n - oa;
                if (len > avail) len = avail;
                memcpy(work + at, o->d + oa, len);
                break;
            }
            case 4:            /* widen with repeated tail */
                if (n < max_len - 16 && n > 0) {
                    size_t add = 1 + rnd() % 16;
                    for (size_t k = 0; k < add; k++)
                        work[n + k] = work[k % n];
                    n += add;
                }
                break;
            case 5:            /* retarget selector */
                work[0] = (uint8_t)rnd();
                break;
            }
        }
        memset(cov_run, 0, sizeof cov_run);
        size_t before = cov_new;
        run_one(work, n);
        iters++;
        if (cov_new > before) {
            add_corpus(work, n);
            adds++;
        }
    }
    printf("fuzz_native: %ld iters, %d corpus (%ld added), "
           "%zu edges\n", iters, ncorpus, adds, cov_new);
    return 0;
}
