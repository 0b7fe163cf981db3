// rans16_enc_fused: batched rANS 4x16 encode with the table lookup
// inside the kernel, order 0 and order 1, for sm_90a.
//
// Replaces the Pallas encode scan that fetches its table row itself
// (htscodecs_tpu/ops/rans_vmem.py, _build_enc_kernel: row chosen by
// context through a select chain, the (sym, sym+1) pair picked from
// pair-packed bases) together with the stitch sort of _enc_vmem.  On
// this card a lookup is an indexed load: the kernel reads one symbol
// byte and one context byte per symbol and takes start = row[sym],
// freq = row[sym+1] - start from the block's own monotone base rows
// ((A, A+1) int16 at order 1, one row at order 0), which stay in L1/L2.
// Against the sf_fetch + rans16_enc pair this drops the 4-byte query
// index and the 4-byte (start | freq << 12) value per symbol that the
// pair writes to and reads back from device memory.
//
// Thread layout, encode step, ballot ranking and in-place reversal are
// rans16_enc's (rans_group.cuh); the table entry is folded into the
// same (start | freq << 12) value first, so the outputs equal
// sf_fetch + rans16_enc bit for bit, freq-0 holes and clamped
// out-of-alphabet symbols included.
//
// Bound on this card: memory traffic (2 bytes per symbol in, the tables,
// the emitted words out); one state per thread makes it latency-bound.

#include "rans_group.cuh"

#define RANS_L (1u << 15)

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
rans16_enc_fused_kernel(const uint8_t* __restrict__ sym,
                        const uint8_t* __restrict__ ctx,
                        const int16_t* __restrict__ bases,
                        const int32_t* __restrict__ shift,
                        uint32_t* __restrict__ states,
                        uint16_t* __restrict__ words,
                        int32_t* __restrict__ counts,
                        int B, int K, int A, int geom, int cap)
{
    const int tid = blockIdx.x * THREADS + threadIdx.x;
    const int b = tid >> 2;
    const int j = tid & 3;
    const bool live = b < B;
    // threads past the ragged edge shadow the last block and never write
    const size_t bb = live ? b : B - 1;

    const int sh = shift[bb];
    const uint32_t xmult = (RANS_L >> sh) << 16;
    const int Ac = ORDER ? A : 1;
    const uint8_t* sy = sym + bb * (size_t)K * 4;
    const uint8_t* cx = ctx + bb * (size_t)K * 4;
    const int16_t* tb = bases + bb * (size_t)(Ac * (A + 1));
    uint16_t* w = words + bb * (size_t)cap;
    const unsigned gsh = (threadIdx.x & 31u) & ~3u;

    uint32_t X = RANS_L;
    int n = 0;
    for (int s = 0; s < K; ++s) {
        int start, next;
        table_entry(tb, A, Ac, sy[4 * s + j], ORDER ? cx[4 * s + j] : 0,
                    start, next);
        // the value sf_table holds for this entry (int32 arithmetic)
        const uint32_t v = (uint32_t)start | ((uint32_t)(next - start) << 12);
        enc16_step(X, n, w, v, enc_active<ORDER>(s, j, geom), live, j, gsh,
                   xmult, sh);
    }
    if (live) {
        states[bb * 4 + (3 - j)] = X;
        if (j == 0) counts[bb] = n;
    }
    reverse_rows(words, cap, n, B);
}

// sym, ctx (B, 4K) u8 in processing order (step-major, lane-minor),
// bases (B, order ? A : 1, A+1) i16, shift (B,) i32; out: states (B,4)
// u32 in state order, words (B,cap) u16 forward order (cap >= 4K),
// counts (B,) i32.  Returns cudaGetLastError().
extern "C" int rans16_enc_fused_launch(const void* sym, const void* ctx,
                                       const void* bases, const void* shift,
                                       void* states, void* words,
                                       void* counts, int B, int K, int A,
                                       int geom, int cap, int order,
                                       void* stream)
{
    if (B <= 0) return 0;
    if (cap < 4 * K || A < 1) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((size_t)B * 4 + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (order)
        rans16_enc_fused_kernel<1><<<grid, THREADS, 0, st>>>(
            (const uint8_t*)sym, (const uint8_t*)ctx, (const int16_t*)bases,
            (const int32_t*)shift, (uint32_t*)states, (uint16_t*)words,
            (int32_t*)counts, B, K, A, geom, cap);
    else
        rans16_enc_fused_kernel<0><<<grid, THREADS, 0, st>>>(
            (const uint8_t*)sym, (const uint8_t*)ctx, (const int16_t*)bases,
            (const int32_t*)shift, (uint32_t*)states, (uint16_t*)words,
            (int32_t*)counts, B, K, A, geom, cap);
    return (int)cudaGetLastError();
}
