// rans8_dec: batched rANS 4x8 (CRAM 3.0) decode, order 0 and order 1,
// for sm_90a.
//
// Replaces the Pallas 4x8 decode kernel of the JAX package
// (htscodecs_tpu/ops/rans8_vmem.py, _build_dec_kernel / _dec_vmem8),
// which keeps 128 blocks' tables and a 512-byte window of each stream
// in on-chip memory, resolves every lookup with select chains, and
// leaves the order-0 tail to tensor code after the kernel.  Here, as in
// rans16_dec:
//
//   - one 4-thread group per rANS block, thread l = rANS state l;
//   - slot -> symbol is a binary search for the last base <= slot over
//     the context's monotone int16 row, freq = row[s+1] - row[s]; the
//     row's last column is the row's own total (4x8 rows normalise to
//     4095 slots);
//   - a state consumes 0, 1 or 2 bytes per step (rANS_byte.h
//     RansDecRenorm).  Whether the second is needed does not depend on
//     the first byte's value ((X << 8 | b) < L  <=>  X < L >> 8), so
//     every offset is known before any byte is read: claims go in state
//     order 0..3, a state's two bytes adjacent, ranked by two ballots
//     and popcounts of the lower states' bits;
//   - decoded bytes go straight to the (B, N) output; at order 0 the
//     last N & 3 symbols are read from the final states without
//     advancing them (rANS_static.c), inside the kernel.
//
// Bound on this card: memory traffic (stream bytes + tables + states
// in, B*N bytes out); the serial dependence of one state per thread
// makes it latency-bound.
//
// Arithmetic is rANS_byte.h's (L = 1 << 23, 12-bit slots) in uint32_t.
// Reads of the stream are bounded by each block's own byte count: a
// truncated stream decodes zeros past its end.  A slot with no base
// <= it decodes symbol 0 with base 0, and a slot at or above a row's
// total lands on the row's last entry; the plain version does the same.

#include <cuda_runtime.h>
#include <stdint.h>

#define RANS8_L (1u << 23)
#define SHIFT 12
#define MASK ((1u << SHIFT) - 1u)
#define THREADS 128

// last entry k < A of the monotone row with row[k] <= m (0 if none)
__device__ __forceinline__ int slot_lookup(const int16_t* __restrict__ row,
                                           int A, int m, int& bs, int& f)
{
    int lo = 0, hi = A;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] <= m) lo = mid + 1; else hi = mid;
    }
    const int sym = lo > 0 ? lo - 1 : 0;
    bs = lo > 0 ? row[sym] : 0;
    f = row[sym + 1] - bs;
    return sym;
}

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
rans8_dec_kernel(const uint32_t* __restrict__ states,
                 const uint8_t* __restrict__ stream,
                 const int32_t* __restrict__ counts,
                 const int16_t* __restrict__ bases,
                 const uint8_t* __restrict__ alpha,
                 uint8_t* __restrict__ out,
                 int B, int W, int A, int N, int q, int K)
{
    const int tid = blockIdx.x * THREADS + threadIdx.x;
    const int b = tid >> 2;
    const int lane = tid & 3;
    const bool live = b < B;
    // threads past the ragged edge shadow the last block (valid
    // memory, same control flow for the warp ballot) and never write
    const size_t bb = live ? b : B - 1;

    uint32_t X = states[bb * 4 + lane];
    const uint8_t* by = stream + bb * (size_t)W;
    const int nb = min(counts[bb], W);
    const int A1 = A + 1;
    const int16_t* tb = bases + bb * (size_t)((ORDER ? A : 1) * A1);
    const uint8_t* al = alpha + bb * (size_t)A;
    uint8_t* o = out + bb * (size_t)N;
    const unsigned gsh = (threadIdx.x & 31u) & ~3u;  // group's first bit
    const unsigned lower = (1u << lane) - 1u;

    int p = 0;
    int ctx = 0;
    for (int s = 0; s < K; ++s) {
        const bool act = ORDER ? (s < q || lane == 3) : true;
        const int m = (int)(X & MASK);
        int bs, f;
        const int sym = slot_lookup(tb + (ORDER ? ctx * A1 : 0), A, m, bs, f);
        uint32_t Xn = (uint32_t)f * (X >> SHIFT) + (uint32_t)m - (uint32_t)bs;
        const bool need1 = act && Xn < RANS8_L;
        const bool need2 = need1 && Xn < (RANS8_L >> 8);
        const unsigned g1 = (__ballot_sync(0xffffffffu, need1) >> gsh) & 0xFu;
        const unsigned g2 = (__ballot_sync(0xffffffffu, need2) >> gsh) & 0xFu;
        if (need1) {
            const int pos = p + __popc(g1 & lower) + __popc(g2 & lower);
            Xn = (Xn << 8) | (pos < nb ? (uint32_t)by[pos] : 0u);
            if (need2)
                Xn = (Xn << 8) | (pos + 1 < nb ? (uint32_t)by[pos + 1] : 0u);
        }
        p += __popc(g1) + __popc(g2);
        if (act) {
            X = Xn;
            ctx = sym;
            if (live) {
                if (ORDER)
                    o[s < q ? lane * q + s : 4 * q + (s - q)] = al[sym];
                else
                    o[4 * s + lane] = al[sym];
            }
        }
    }
    // order 0: the last N & 3 symbols come from the final states, which
    // do not advance
    if (!ORDER && lane < (N & 3)) {
        int bs, f;
        const int sym = slot_lookup(tb, A, (int)(X & MASK), bs, f);
        if (live) o[4 * K + lane] = al[sym];
    }
}

// states (B,4) u32, stream (B,W) u8, counts (B,) i32 bytes per block,
// bases (B, order ? A : 1, A+1) i16 with per-row totals in the last
// column, alpha (B,A) u8, out (B,N) u8; order 0 needs N >= 4.
// Returns cudaGetLastError().
extern "C" int rans8_dec_launch(const void* states, const void* stream,
                                const void* counts, const void* bases,
                                const void* alpha, void* out,
                                int B, int W, int A, int N, int order,
                                void* cuda_stream)
{
    if (B <= 0 || N <= 0) return 0;
    if (A < 1 || W < 1 || (!order && N < 4)) return (int)cudaErrorInvalidValue;
    const int q = N >> 2;
    const int K = order ? q + (N - 4 * q) : q;
    const unsigned grid = (unsigned)(((size_t)B * 4 + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)cuda_stream;
    if (order)
        rans8_dec_kernel<1><<<grid, THREADS, 0, st>>>(
            (const uint32_t*)states, (const uint8_t*)stream,
            (const int32_t*)counts, (const int16_t*)bases,
            (const uint8_t*)alpha, (uint8_t*)out, B, W, A, N, q, K);
    else
        rans8_dec_kernel<0><<<grid, THREADS, 0, st>>>(
            (const uint32_t*)states, (const uint8_t*)stream,
            (const int32_t*)counts, (const int16_t*)bases,
            (const uint8_t*)alpha, (uint8_t*)out, B, W, A, N, q, K);
    return (int)cudaGetLastError();
}
