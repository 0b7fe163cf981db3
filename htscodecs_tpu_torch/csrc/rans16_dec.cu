// rans16_dec: batched rANS 4x16 decode, order 0 and order 1, for sm_90a.
//
// Replaces the Pallas decode kernel of the JAX package
// (htscodecs_tpu/ops/rans_vmem.py, _build_kernel / _dec_vmem).  That
// kernel keeps 128 blocks' tables and word streams in on-chip memory
// and resolves every lookup with select chains, because its hardware
// has no gather.  Here a lookup is an indexed load, so the design is
// the direct one:
//
//   - one 4-thread group per rANS block, thread l = rANS state l; a
//     warp carries 8 blocks.  The only cross-state operation, the
//     renormalisation word claim in state order 0..3, is one warp
//     ballot plus a popcount of the lower states' bits.
//   - the block's monotone cumulative-base rows ((A, A+1) u16 for
//     order 1, one row for order 0; see rans_v2._b16_fill) stay in
//     global memory and are read through L1/L2; slot -> symbol is a
//     binary search over the context's row, freq = row[s+1] - row[s].
//   - decoded bytes go straight to the (B, N) output: order 1 writes
//     state l's quarter at l*q + step and the state-3 tail after the
//     four quarters, order 0 writes 4*step + l.
//
// Bound on this card: memory traffic (words + tables + states in,
// B*N bytes out); the serial dependence of one state per thread makes
// the kernel latency-bound long before it is bandwidth-bound, so the
// measured time sits well above that bound.
//
// State-transition arithmetic is rANS_word.h's (L = 1<<15, 16-bit
// renormalisation), in uint32_t.  Reads of the word stream are bounded
// by each block's own word count: a malformed stream decodes zeros
// past its end instead of reading a neighbour's words.

#include <cuda_runtime.h>
#include <stdint.h>

#define RANS_L (1u << 15)
#define THREADS 128

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
rans16_dec_kernel(const uint32_t* __restrict__ states,
                  const uint16_t* __restrict__ words,
                  const int32_t* __restrict__ counts,
                  const uint16_t* __restrict__ bases,
                  const uint8_t* __restrict__ alpha,
                  const int32_t* __restrict__ shift,
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

    const int sh = shift[bb];
    const uint32_t mask = (1u << sh) - 1u;
    uint32_t X = states[bb * 4 + lane];
    const uint16_t* wrd = words + bb * (size_t)W;
    const int nw = min(counts[bb], W);
    const int A1 = A + 1;
    const uint16_t* tb = bases + bb * (size_t)((ORDER ? A : 1) * A1);
    const uint8_t* al = alpha + bb * (size_t)A;
    uint8_t* o = out + bb * (size_t)N;
    const unsigned gsh = (threadIdx.x & 31u) & ~3u;  // group's first bit

    int p = 0;
    int ctx = 0;
    for (int s = 0; s < K; ++s) {
        const bool act = ORDER ? (s < q || lane == 3) : true;
        const uint16_t* row = tb + (ORDER ? ctx * A1 : 0);
        const uint32_t m = X & mask;
        // c = number of entries k < A with row[k] <= m (a prefix: the
        // row is monotone); the symbol is the last of them
        int lo = 0, hi = A;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (row[mid] <= m) lo = mid + 1; else hi = mid;
        }
        const int sym = lo > 0 ? lo - 1 : 0;
        const uint32_t bs = lo > 0 ? row[sym] : 0u;
        const uint32_t f = (uint32_t)row[sym + 1] - bs;
        uint32_t Xn = f * (X >> sh) + m - bs;
        const bool need = act && Xn < RANS_L;
        const unsigned g = (__ballot_sync(0xffffffffu, need) >> gsh) & 0xFu;
        if (need) {
            const int pos = p + __popc(g & ((1u << lane) - 1u));
            const uint32_t w = pos < nw ? wrd[pos] : 0u;
            Xn = (Xn << 16) | w;
        }
        p += __popc(g);
        if (act) {
            X = Xn;
            ctx = sym;
            if (live) {
                if (ORDER) {
                    const int at = s < q ? lane * q + s : 4 * q + (s - q);
                    o[at] = al[sym];
                } else {
                    const int at = 4 * s + lane;
                    if (at < N) o[at] = al[sym];
                }
            }
        }
    }
}

// states (B,4) u32, words (B,W) u16, counts (B,) i32, bases
// (B, order ? A : 1, A+1) u16, alpha (B,A) u8, shift (B,) i32,
// out (B,N) u8.  Returns cudaGetLastError().
extern "C" int rans16_dec_launch(const void* states, const void* words,
                                 const void* counts, const void* bases,
                                 const void* alpha, const void* shift,
                                 void* out, int B, int W, int A, int N,
                                 int order, void* stream)
{
    if (B <= 0 || N <= 0) return 0;
    const int q = order ? (N >> 2) : ((N + 3) >> 2);
    const int K = order ? q + (N - 4 * q) : q;
    const unsigned grid = (unsigned)(((size_t)B * 4 + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (order)
        rans16_dec_kernel<1><<<grid, THREADS, 0, st>>>(
            (const uint32_t*)states, (const uint16_t*)words,
            (const int32_t*)counts, (const uint16_t*)bases,
            (const uint8_t*)alpha, (const int32_t*)shift, (uint8_t*)out,
            B, W, A, N, q, K);
    else
        rans16_dec_kernel<0><<<grid, THREADS, 0, st>>>(
            (const uint32_t*)states, (const uint16_t*)words,
            (const int32_t*)counts, (const uint16_t*)bases,
            (const uint8_t*)alpha, (const int32_t*)shift, (uint8_t*)out,
            B, W, A, N, q, K);
    return (int)cudaGetLastError();
}
