// rc_core.cuh: the carry-counting byte range coder and the adaptive
// SIMPLE_MODEL, shared by arith_enc.cu, arith_dec.cu and rc_enc.cu.
//
// The coder is htscodecs' c_range_coder.h (RC_Encode, RC_ShiftLow, the
// five finishing shifts), the model its c_simple_model.h, in uint32_t.
// One CUDA thread owns one block's coder.  The coder's state (RcEnc) is
// separate from where its bytes go: RC_ShiftLow hands each byte to a
// sink, `cache + carry` once the carry is settled and then the `ffnum`
// deferred bytes `carry - 1` whole, so a byte handed over is final.
// RowOut stores bytes straight into the block's output row (arith_enc);
// rc_enc.cu gathers them in a shared-memory ring that it flushes in
// 16-byte stores.  The Pallas kernels of the JAX package could not store
// a variable number of bytes per step and emitted packed events that
// were sorted and expanded afterwards; nothing of that is needed.
//
// RC_Encode divides the range by the total.  rc_encode (arith_enc) does
// it with the card's 32-bit divide; rc_enc.cu splits RC_Encode into the
// range chain, which divides through a reciprocal staged ahead of it
// (rc_udiv64), and the low chain; arith_dec.cu divides through a
// reciprocal kept beside each model's total (rc_udiv).
//
// A coded symbol shifts at most twice (total <= 65535, so the range
// loses at most 16 bits), a deferred byte is a shift already counted,
// and the finish adds five: a row of 2 * n + 8 bytes cannot overflow.
//
// The model rows may live in shared or in global memory: model_init and
// model_update take a pointer, or an indexable row type (arith_dec.cu
// addresses its shared rows by index into the shared array, so that the
// compiler needs no generic address for them).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RC_TOP (1u << 24)
#define RC_THRES 0xFF000000u
#define MODEL_STEP 16u
#define MODEL_MAX_FREQ ((1u << 16) - 17u)

struct RcEnc {
    uint32_t low, range, ffnum, cache, carry;
};

__device__ __forceinline__ void rc_enc_init(RcEnc& rc)
{
    rc.low = 0u;
    rc.range = 0xFFFFFFFFu;
    rc.ffnum = 0u;
    rc.cache = 0u;
    rc.carry = 0u;
}

// a sink that stores each byte into the block's output row
struct RowOut {
    uint8_t* out;
    int n;          // bytes written so far
    __device__ __forceinline__ void put(uint32_t byte) { out[n++] = (uint8_t)byte; }
};

// RC_ShiftLow: `carry` is a counter, and the deferred bytes take
// (carry - 1) & 0xFF: 0xFF without a carry, 0x00 after one.
template <class Sink>
__device__ __forceinline__ void rc_shift_low(RcEnc& rc, Sink& out)
{
    if (rc.low < RC_THRES || rc.carry) {
        out.put(rc.cache + rc.carry);
        const uint32_t run = rc.carry - 1u;
        for (; rc.ffnum; --rc.ffnum) out.put(run);
        rc.cache = rc.low >> 24;
        rc.carry = 0u;
    } else {
        ++rc.ffnum;
    }
    rc.low <<= 8;
}

// RC_Encode.  The carry is the 32-bit wrap of low + acc * r.  A total
// or a frequency of 0 (no valid model gives one) is taken as 1, and the
// range is shifted at most twice: with valid input two shifts always
// reach RC_TOP, with invalid input the coder still ends.
template <class Sink>
__device__ __forceinline__ void rc_encode(RcEnc& rc, Sink& out, uint32_t acc,
                                          uint32_t f, uint32_t tot)
{
    const uint32_t r = rc.range / max(tot, 1u);
    const uint32_t low = rc.low + acc * r;
    rc.carry += low < rc.low;
    rc.low = low;
    rc.range = r * max(f, 1u);
    if (rc.range < RC_TOP) {
        rc.range <<= 8;
        rc_shift_low(rc, out);
        if (rc.range < RC_TOP) {
            rc.range <<= 8;
            rc_shift_low(rc, out);
        }
    }
}

// RC_FinishEncode: five shifts.
template <class Sink>
__device__ __forceinline__ void rc_finish(RcEnc& rc, Sink& out)
{
#pragma unroll 1
    for (int k = 0; k < 5; ++k) rc_shift_low(rc, out);
}

// ---- exact division by a 16-bit total through a reciprocal ----------
//
// rc_enc.cu: m = ceil(2^64 / d) for 2 <= d < 2^16 (d = max(tot, 1)).
// For n < 2^32, floor(n * m / 2^64) = floor(n / d): with e = m d - 2^64
// < d, n * m / 2^64 = n / d + n e / (d 2^64) and n e / 2^64 < 1 / d.
// d = 1 takes m = 0 and one = 1: q = n * one + floor(n * m / 2^64).  Two
// dependent 32-bit wide multiplies give floor(n * m / 2^64), the third
// adds n * one (rc_udiv64).  ops/rc_vmem.py holds the same arithmetic
// (_udiv_recip_plain).
//
// arith_dec.cu: m = floor((2^32 - 1) / d), q0 = floor(n * m / 2^32) is
// floor(n / d) or one less, since m >= 2^32 / d - 1 gives n * m / 2^32 >
// n / d - 1; one correction makes it exact (d = 1: m = 2^32 - 1, q0 =
// n - 1 or 0, corrected to n) (rc_udiv).
__device__ __forceinline__ uint32_t rc_udiv_recip(uint32_t d)
{
    return 0xFFFFFFFFu / d;
}

__device__ __forceinline__ uint32_t rc_udiv(uint32_t n, uint32_t d, uint32_t m)
{
    const uint32_t q = __umulhi(n, m);
    return q + (n - q * d >= d);
}

// (m_lo, m_hi, one) for rc_udiv64
__device__ __forceinline__ uint3 rc_udiv64_recip(uint32_t d)
{
    if (d <= 1u) return make_uint3(0u, 0u, 1u);
    const unsigned long long m = 0xFFFFFFFFFFFFFFFFull / d + 1ull;
    return make_uint3((uint32_t)m, (uint32_t)(m >> 32), 0u);
}

__device__ __forceinline__ uint32_t rc_udiv64(uint32_t n, uint32_t m_lo,
                                              uint32_t m_hi, uint32_t one)
{
    const unsigned long long t = (unsigned long long)n * m_lo;
    const unsigned long long u = (unsigned long long)n * m_hi + (t >> 32);
    return (uint32_t)(u >> 32) + n * one;
}

// ---- SIMPLE_MODEL ---------------------------------------------------
//
// A model is a row of M + 1 uint32_t: entry j holds
// `symbol << 16 | frequency` (frequencies stay <= 65535), entry M the
// total.  Initial state (convert.model_bank): entry j is
// `j << 16 | (j < max_syms)`, the total max_syms.
//
// After position p was coded (`e` = the entry at p, `prev` the entry at
// p - 1, `total` the row's total before the update; p == M: the symbol
// was not in the model, only the total moves): freq[p] += 16; if the
// total passes 65519, every entry is halved as f -= f >> 1 and the total
// recomputed; THEN one swap with p - 1 if freq[p] > freq[p - 1].  That
// order is visible in the bitstream.  model_update returns the new
// total.  The frequencies of a row never sum past its total (both grow
// by 16 at a hit, the halving sets the total to the sum), and the total
// stays <= 65535 once a symbol was coded.
// `row` is a pointer or any type whose row[j] is a uint32_t lvalue
// (arith_dec.cu addresses shared rows by index).
template <class Row>
__device__ __forceinline__ void model_init(Row row, int M, int max_syms)
{
    for (int j = 0; j < M; ++j) row[j] = ((uint32_t)j << 16) | (uint32_t)(j < max_syms);
    row[M] = (uint32_t)max_syms;
}

template <class Row>
__device__ __forceinline__ uint32_t model_update(Row row, int M, int p,
                                                 uint32_t e, uint32_t prev,
                                                 uint32_t total)
{
    total += MODEL_STEP;
    const bool hit = p < M;
    if (hit) e += MODEL_STEP;
    if (total > MODEL_MAX_FREQ) {
        if (hit) row[p] = e;
        total = 0u;
        for (int j = 0; j < M; ++j) {
            const uint32_t v = row[j];
            uint32_t f = v & 0xFFFFu;
            f -= f >> 1;
            row[j] = (v & 0xFFFF0000u) | f;
            total += f;
        }
        if (hit) {
            e = row[p];
            if (p > 0) prev = row[p - 1];
        }
    }
    row[M] = total;
    if (hit) {
        if (p > 0 && (e & 0xFFFFu) > (prev & 0xFFFFu)) {
            row[p - 1] = e;
            row[p] = prev;
        } else {
            row[p] = e;
        }
    }
    return total;
}

// the same, reading prev and the total from the row
__device__ __forceinline__ void model_update(uint32_t* row, int M, int p,
                                             uint32_t e)
{
    model_update(row, M, p, e, p > 0 && p < M ? row[p - 1] : 0u, row[M]);
}

// one block per thread, `tpb` threads per CTA
__host__ inline unsigned rc_grid(int B, int tpb)
{
    return (unsigned)((B + tpb - 1) / tpb);
}
