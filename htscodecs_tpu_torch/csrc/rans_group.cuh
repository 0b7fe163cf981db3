// What the rANS kernels of this directory share: the thread layout
// (one 4-thread group per rANS block, 128 threads = 32 blocks per CUDA
// block), the in-kernel table lookup, the rANS 4x16 encode step and the
// final reversal of a block's emitted elements.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128

// Processing lane j of a group codes rANS state 3 - j (the encoder walks
// the symbols in reverse, state 3 first).  Order 1: the first geom steps
// are the state-3 tail (lane 0 alone); order 0: the first step skips the
// geom padded lanes.
template <int ORDER>
__device__ __forceinline__ bool enc_active(int s, int j, int geom)
{
    return ORDER ? (s >= geom || j == 0) : (s > 0 || j >= geom);
}

// Base of entry (ctx, sym) of a block's monotone base rows
// ((Ac, A+1) int16) and of its successor; freq = next - start.  The
// flat index ctx * A + sym is clamped into the table, as sf_fetch
// clamps its index, so a byte outside the block's alphabet cannot read
// outside the block's rows.
__device__ __forceinline__ void table_entry(const int16_t* __restrict__ tb,
                                            int A, int Ac, int sym, int ctx,
                                            int& start, int& next)
{
    int c = ctx, s = sym;
    if (sym >= A || ctx >= Ac) {
        const int idx = min(ctx * A + sym, Ac * A - 1);
        c = idx / A;
        s = idx - c * A;
    }
    const int16_t* e = tb + c * (A + 1) + s;
    start = e[0];
    next = e[1];
}

// One rANS 4x16 encode step of a group (rANS_word.h, L = 1 << 15):
//   emit = X >= ((L >> shift) << 16) * f;  word = X & 0xFFFF;
//   X >>= 16 if emit;  X = (X / f << shift) + X % f + start
// in uint32 arithmetic (a freq of 0 divides by 1).  The word's rank in
// the block's emission sequence is the running count n plus the
// popcount of the lower lanes' ballot bits; gsh is the group's first
// bit in the warp's ballot.  Every thread of the warp must call this
// (the ballot is warp-wide).
__device__ __forceinline__ void enc16_put(uint32_t& X, int& n,
                                          uint16_t* __restrict__ w,
                                          uint32_t start, uint32_t f,
                                          bool ok, bool live, int j,
                                          unsigned gsh, uint32_t xmult,
                                          int sh)
{
    const bool emit = ok && X >= xmult * f;
    const unsigned g = (__ballot_sync(0xffffffffu, emit) >> gsh) & 0xFu;
    if (emit) {
        if (live) w[n + __popc(g & ((1u << j) - 1u))] = (uint16_t)X;
        X >>= 16;
    }
    n += __popc(g);
    if (ok) {
        const uint32_t fs = f ? f : 1u;
        const uint32_t qq = X / fs;
        X = (qq << sh) + (X - qq * fs) + start;
    }
}

// The same step from v = start | freq << 12 (what sf_fetch gathers).
__device__ __forceinline__ void enc16_step(uint32_t& X, int& n,
                                           uint16_t* __restrict__ w,
                                           uint32_t v, bool ok, bool live,
                                           int j, unsigned gsh,
                                           uint32_t xmult, int sh)
{
    enc16_put(X, n, w, v & 0xFFFu, (v >> 12) & 0x1FFFu, ok, live, j, gsh,
              xmult, sh);
}

// Forward order = reverse of emission order: the warp reverses, in
// place, the first n elements of each of its 8 blocks' rows of `out`
// (B, cap) with coalesced swaps.  n is the calling thread's block's
// count; every thread of the warp must call this.
template <typename T>
__device__ __forceinline__ void reverse_rows(T* __restrict__ out, int cap,
                                             int n, int B)
{
    __syncwarp();
    const int wl = threadIdx.x & 31;
    const int b0 = (blockIdx.x * THREADS + (threadIdx.x & ~31u)) >> 2;
    for (int gi = 0; gi < 8; ++gi) {
        const int nb = __shfl_sync(0xffffffffu, n, gi * 4);
        if (b0 + gi >= B) break;
        T* row = out + (size_t)(b0 + gi) * cap;
        for (int i = wl; i < (nb >> 1); i += 32) {
            const T lo = row[i];
            const T hi = row[nb - 1 - i];
            row[i] = hi;
            row[nb - 1 - i] = lo;
        }
    }
}
