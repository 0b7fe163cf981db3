// What the two rANS encoders (rans16_enc_packed.cu, rans8_enc.cu)
// share: the thread layout (one 4-thread group per rANS block,
// thread j = processing lane j = rANS state 3 - j, 32-thread CTAs of 8
// blocks), which lanes code a symbol at a step, the CTA's shared memory
// (byte rings, byte -> dense index tables, table entries beside the
// reciprocals of their freqs) with the prologue that fills it, and the
// stage that copies a lane's bytes into its ring in reverse.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "rc_core.cuh"

#define ENC_THREADS 32      // 8 blocks per CTA
#define PACK_SHIFT 13       // packed entry: base << 13 | freq
#define PACK_MASK ((1 << PACK_SHIFT) - 1)
#define RB 128              // staged bytes per lane (order 1)
// Ring and byte-table strides, padded so that the lanes of a warp, which
// read at the same offsets of their own rings and tables, hit different
// banks of shared memory (unpadded, all 32 lanes of an order-1 warp read
// one bank): an order-1 lane's ring RB + 16 bytes (4-way at worst; a
// ring must start on 16 bytes), an order-0 group's 4 RB + 16, a byte
// table 256 + 4.  A block's ring space is RING_BLK bytes.
#define RING_STRIDE1 (RB + 16)
#define RING_STRIDE0 (4 * RB + 16)
#define RING_BLK (4 * RING_STRIDE1)
#define LUT_STRIDE 260
#define SE 16               // steps between two staging rounds (even)

// Processing lane j of a group codes rANS state 3 - j (the encoder walks
// the symbols in reverse, state 3 first).  Order 1: the first geom steps
// are the state-3 tail (lane 0 alone); order 0: the first step skips the
// geom padded lanes.
template <int ORDER>
__device__ __forceinline__ bool enc_active(int s, int j, int geom)
{
    return ORDER ? (s >= geom || j == 0) : (s > 0 || j >= geom);
}

// Shared memory of one encoder CTA of `bpc` blocks: the byte rings
// (RING_BLK per block), the byte tables (LUT_STRIDE per block), then with
// tables in shared memory the entries (A2 + 1 of 8 bytes per block).
// ops/rans_vmem.py (_enc_smem) holds the same rule.
static inline size_t enc_smem(int bpc, int A2, bool tables)
{
    size_t s = (size_t)bpc * (RING_BLK + LUT_STRIDE);
    if (tables) s += (size_t)bpc * (A2 + 1) * 8;
    return s;
}

// The prologue of an encoder CTA whose first block is b0 (nblk blocks):
// each block's byte -> dense index table (the count of alphabet entries
// below the byte, rans_v2._densify's rule) at luts + LUT_STRIDE * block,
// and, with SMEM, its A2 packed entries beside the reciprocals of their
// freqs (a freq of 0 divides by 1) at tabs + (A2 + 1) * block, with one
// zero entry past them for a key past the table.  The caller
// synchronises.
template <bool SMEM>
__device__ __forceinline__ void enc_prologue(uint8_t* luts, uint2* tabs,
                                             const uint8_t* __restrict__ alpha,
                                             const int32_t* __restrict__ packed,
                                             int b0, int nblk, int A, int A2,
                                             int tid)
{
    for (int t = tid; t < nblk * 256; t += ENC_THREADS) {
        const uint8_t* al = alpha + (size_t)(b0 + (t >> 8)) * A;
        const int v = t & 255;
        int c = 0;
        for (int k = 0; k < A; ++k) c += al[k] < v;
        luts[(t >> 8) * LUT_STRIDE + v] = (uint8_t)c;
    }
    if (SMEM) {
        for (int t = tid; t < nblk * (A2 + 1); t += ENC_THREADS) {
            const int gi = t / (A2 + 1);
            const int k = t - gi * (A2 + 1);
            const uint32_t e = k < A2 ? (uint32_t)packed[(size_t)(b0 + gi) * A2 + k] : 0u;
            const uint32_t f = e & PACK_MASK;
            tabs[t] = make_uint2(e, rc_udiv_recip(f ? f : 1u));
        }
    }
}

// A range of bytes [lo, hi] read from hi down, staged in the ring `buf`
// (a power of two, `mask` + 1 bytes): relative byte r = address - base
// (base = the range's first byte aligned down to 16) sits at
// buf[r & mask]; segment k is the 16 bytes at base + 16 k.  Bytes past
// hi are not copied (zero-filled).
struct BackStage {
    uint8_t* buf;
    const uint8_t* base;
    int end;        // relative end of the range (exclusive)
    int next;       // the next segment to ask for (descending)
    int mask;

    __device__ __forceinline__ void init(uint8_t* ring, int bytes,
                                         const uint8_t* lo, int len)
    {
        buf = ring;
        mask = bytes - 1;
        base = reinterpret_cast<const uint8_t*>((uintptr_t)lo & ~(uintptr_t)15);
        end = (int)(lo - base) + len;
        next = (end - 1) >> 4;
    }

    // ask for the segments from `next` down to `down_to`
    __device__ __forceinline__ void fill(int down_to)
    {
        for (down_to = max(down_to, 0); next >= down_to; --next) {
            const int a = next * 16;
            cp_async16(buf + (a & mask), base + a, (uint32_t)min(end - a, 16));
        }
    }

    // ask for what the ring can hold below relative byte `r`, the
    // highest still to be read: a segment's slot is free once the
    // segment a ring's length above it lies wholly above r
    __device__ __forceinline__ void fill_below(int r)
    {
        fill((r >> 4) - (mask + 1) / 16 + 1);
    }

    __device__ __forceinline__ uint32_t at(int r) const { return buf[r & mask]; }
};
