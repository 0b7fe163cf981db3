// rans16_enc: batched rANS 4x16 encode over a prefetched
// (start | freq << 12) stream, order 0 and order 1, for sm_90a.
//
// Replaces the Pallas prefetched-table encode scan of the JAX package
// (htscodecs_tpu/ops/rans_vmem.py, _build_enc_kernel_pf) together with
// the global stitch sort that follows it in _enc_vmem.  That kernel
// compacts each grid step's emitted words with a one-hot placement and
// leaves the cross-step placement to a sort, and divides with a float
// reciprocal plus fix-ups, because its hardware runs the grid in order
// on one core and has neither scatter nor integer divide.  Here:
//
//   - one 4-thread group per rANS block, thread j = processing lane j
//     (rANS state 3 - j: the encoder walks the symbols in reverse,
//     state 3 first).  A group owns its block's whole emission
//     sequence, so a word's rank is the running count plus a popcount
//     over the group's ballot bits: words are stored in emission order
//     as they appear, no per-segment capacity, no overflow retry.
//   - the stream format wants the words in forward order, which is
//     the reverse of emission order: after the scan the warp reverses
//     each of its 8 blocks' words in place (coalesced swaps) — this is
//     the whole "stitch".
//   - x / freq is the card's exact unsigned divide.
//
// Bound on this card: memory traffic (4 bytes per symbol in, the
// emitted words out); one state per thread makes it latency-bound.
//
// The step itself (rANS_word.h, L = 1<<15) and the reversal are in
// rans_group.cuh, shared with rans16_enc_fused.

#include "rans_group.cuh"

#define RANS_L (1u << 15)

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
rans16_enc_kernel(const int32_t* __restrict__ sf,
                  const int32_t* __restrict__ shift,
                  uint32_t* __restrict__ states,
                  uint16_t* __restrict__ words,
                  int32_t* __restrict__ counts,
                  int B, int K, int geom, int cap)
{
    const int tid = blockIdx.x * THREADS + threadIdx.x;
    const int b = tid >> 2;
    const int j = tid & 3;
    const bool live = b < B;
    // threads past the ragged edge shadow the last block and never write
    const size_t bb = live ? b : B - 1;

    const int sh = shift[bb];
    const uint32_t xmult = (RANS_L >> sh) << 16;
    const int32_t* in = sf + bb * (size_t)K * 4;
    uint16_t* w = words + bb * (size_t)cap;
    const unsigned gsh = (threadIdx.x & 31u) & ~3u;

    uint32_t X = RANS_L;
    int n = 0;
    for (int s = 0; s < K; ++s)
        enc16_step(X, n, w, (uint32_t)in[4 * s + j],
                   enc_active<ORDER>(s, j, geom), live, j, gsh, xmult, sh);
    if (live) {
        states[bb * 4 + (3 - j)] = X;
        if (j == 0) counts[bb] = n;
    }
    reverse_rows(words, cap, n, B);
}

// sf (B, 4K) i32 in processing order (step-major, lane-minor), shift
// (B,) i32; out: states (B,4) u32 in state order, words (B,cap) u16
// forward order (cap >= 4K), counts (B,) i32.
// Returns cudaGetLastError().
extern "C" int rans16_enc_launch(const void* sf, const void* shift,
                                 void* states, void* words, void* counts,
                                 int B, int K, int geom, int cap, int order,
                                 void* stream)
{
    if (B <= 0) return 0;
    if (cap < 4 * K) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((size_t)B * 4 + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (order)
        rans16_enc_kernel<1><<<grid, THREADS, 0, st>>>(
            (const int32_t*)sf, (const int32_t*)shift, (uint32_t*)states,
            (uint16_t*)words, (int32_t*)counts, B, K, geom, cap);
    else
        rans16_enc_kernel<0><<<grid, THREADS, 0, st>>>(
            (const int32_t*)sf, (const int32_t*)shift, (uint32_t*)states,
            (uint16_t*)words, (int32_t*)counts, B, K, geom, cap);
    return (int)cudaGetLastError();
}
