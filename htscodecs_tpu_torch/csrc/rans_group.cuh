// What the rANS encoders of this directory share: the thread layout
// (one 4-thread group per rANS block; rans8_enc runs 128 threads = 32
// blocks per CUDA block), which lanes code a symbol at a step, the 4x8
// encoder's table lookup and the final reversal of its emitted bytes.

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
// flat index ctx * A + sym is clamped into the table, so a byte outside
// the block's alphabet cannot read outside the block's rows.
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
