// rc_core.cuh: the carry-counting byte range coder and the adaptive
// SIMPLE_MODEL, shared by arith_enc.cu, arith_dec.cu and rc_enc.cu.
//
// The coder is htscodecs' c_range_coder.h (RC_Encode, RC_ShiftLow, the
// five finishing shifts), the model its c_simple_model.h, in uint32_t.
// One CUDA thread owns one block's coder, so RC_ShiftLow does here what
// it does in C: it writes `cache + carry`, then the `ffnum` deferred
// bytes `carry - 1`, straight into the block's output row.  The Pallas
// kernels of the JAX package could not store a variable number of bytes
// per step and emitted packed events that were sorted and expanded
// afterwards; nothing of that is needed.
//
// A coded symbol shifts at most twice (total <= 65535, so the range
// loses at most 16 bits), a deferred byte is a shift already counted,
// and the finish adds five: a row of 2 * n + 8 bytes cannot overflow.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RC_TOP (1u << 24)
#define RC_THRES 0xFF000000u
#define MODEL_STEP 16u
#define MODEL_MAX_FREQ ((1u << 16) - 17u)

struct RcEnc {
    uint32_t low, range, ffnum, cache, carry;
    uint8_t* out;   // the block's output row
    int n;          // bytes written so far
};

__device__ __forceinline__ void rc_enc_init(RcEnc& rc, uint8_t* out)
{
    rc.low = 0u;
    rc.range = 0xFFFFFFFFu;
    rc.ffnum = 0u;
    rc.cache = 0u;
    rc.carry = 0u;
    rc.out = out;
    rc.n = 0;
}

// RC_ShiftLow: `carry` is a counter, and the deferred bytes take
// (carry - 1) & 0xFF: 0xFF without a carry, 0x00 after one.
__device__ __forceinline__ void rc_shift_low(RcEnc& rc)
{
    if (rc.low < RC_THRES || rc.carry) {
        rc.out[rc.n++] = (uint8_t)(rc.cache + rc.carry);
        const uint8_t run = (uint8_t)(rc.carry - 1u);
        for (; rc.ffnum; --rc.ffnum) rc.out[rc.n++] = run;
        rc.cache = rc.low >> 24;
        rc.carry = 0u;
    } else {
        ++rc.ffnum;
    }
    rc.low <<= 8;
}

// RC_Encode.  The carry is the 32-bit wrap of low + acc * r.  A total or
// a frequency of 0 (no valid model gives one) is taken as 1, and the
// range is shifted at most twice: with valid input two shifts always
// reach RC_TOP, with invalid input the loop still ends.
__device__ __forceinline__ void rc_encode(RcEnc& rc, uint32_t acc, uint32_t f,
                                          uint32_t tot)
{
    const uint32_t r = rc.range / max(tot, 1u);
    const uint32_t low = rc.low + acc * r;
    rc.carry += low < rc.low;
    rc.low = low;
    rc.range = r * max(f, 1u);
#pragma unroll
    for (int k = 0; k < 2; ++k)
        if (rc.range < RC_TOP) {
            rc.range <<= 8;
            rc_shift_low(rc);
        }
}

// RC_FinishEncode: five shifts.  Returns the block's byte count.
__device__ __forceinline__ int rc_finish(RcEnc& rc)
{
#pragma unroll 1
    for (int k = 0; k < 5; ++k) rc_shift_low(rc);
    return rc.n;
}

// ---- SIMPLE_MODEL ---------------------------------------------------
//
// A model is a row of M + 1 uint32_t in device memory: entry j holds
// `symbol << 16 | frequency` (frequencies stay <= 65535), entry M the
// total.  At order 1 a block has M such rows, one per context; the live
// rows stay in L1/L2.
//
// After position p was coded (`e` = the entry at p; p == M: the symbol
// was not in the model, only the total moves): freq[p] += 16; if the
// total passes 65519, every entry is halved as f -= f >> 1 and the total
// recomputed; THEN one swap with p - 1 if freq[p] > freq[p - 1].  That
// order is visible in the bitstream.
__device__ __forceinline__ void model_update(uint32_t* __restrict__ row,
                                             int M, int p, uint32_t e)
{
    uint32_t total = row[M] + MODEL_STEP;
    const bool hit = p < M;
    if (hit) {
        e += MODEL_STEP;
        row[p] = e;
    }
    if (total > MODEL_MAX_FREQ) {
        total = 0u;
        for (int j = 0; j < M; ++j) {
            const uint32_t v = row[j];
            uint32_t f = v & 0xFFFFu;
            f -= f >> 1;
            row[j] = (v & 0xFFFF0000u) | f;
            total += f;
        }
        if (hit) e = row[p];
    }
    row[M] = total;
    if (hit && p > 0) {
        const uint32_t prev = row[p - 1];
        if ((e & 0xFFFFu) > (prev & 0xFFFFu)) {
            row[p - 1] = e;
            row[p] = prev;
        }
    }
}

// one block per thread, `tpb` threads per CTA
__host__ inline unsigned rc_grid(int B, int tpb)
{
    return (unsigned)((B + tpb - 1) / tpb);
}
