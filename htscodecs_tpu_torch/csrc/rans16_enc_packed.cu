// rans16_enc_packed: batched rANS 4x16 encode, order 0 and order 1,
// from the raw block bytes and the packed (base << 13 | freq) rows, for
// sm_90a.
//
// Replaces the first-generation Pallas encode of the JAX package
// (htscodecs_tpu/ops/rans_pallas.py, _enc_kernel_body / _enc_tile)
// together with what surrounds it there: the prologue of _enc_pallas
// (byte -> dense index, processing-order symbol and context grids laid
// out 128 blocks to the lanes) and the emit-plane compaction _compact
// with its segment capacity and overflow retry (_enc_batch).  Here:
//
//   - one 4-thread group per rANS block, thread j = processing lane j
//     (rANS state 3 - j: the encoder walks the symbols in reverse,
//     state 3 first), as in rans16_enc.
//   - the kernel reads the block's bytes (B, N) as they are.  Each
//     group first builds a 256-entry byte -> dense index table in
//     shared memory (the number of alphabet entries below the byte,
//     rans_v2._densify's rule), then takes each symbol's context from
//     the previous byte of the same quarter (a quarter's first symbol,
//     and so the quarter leader, is in context 0; the state-3 tail
//     continues the last quarter).  Neither the dense block nor the
//     processing-order grids exist in device memory.
//   - (start, freq) is entry ctx * A + sym of the block's packed rows
//     (an index past the table reads 0, as the TPU kernel's masked max
//     of nothing does); the step, the ballot ranking of emitted words
//     and the in-place reversal into forward order are rans_group.cuh's
//     (exact integer divide, no capacity, no retry, no sort).
//   - kept from the JAX kernel: the order-1 tail steps that move state
//     3 alone, the order-0 first-step pad (4K - N lanes idle), the emit
//     test against ((L >> shift) << 16) * freq, one shift per launch.
//
// Bound on this card: operations (the step with its divide, ~38 per
// symbol, against 1 byte per symbol in and the emitted words out); one
// state per thread makes it latency-bound.

#include "rans_group.cuh"

#define RANS_L (1u << 15)
#define PACK_SHIFT 13
#define PACK_MASK ((1 << PACK_SHIFT) - 1)

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
rans16_enc_packed_kernel(const uint8_t* __restrict__ blocks,
                         const uint8_t* __restrict__ alpha,
                         const int32_t* __restrict__ packed,
                         uint32_t* __restrict__ states,
                         uint16_t* __restrict__ words,
                         int32_t* __restrict__ counts,
                         int B, int N, int A, int q, int K, int geom,
                         int cap, int sh)
{
    __shared__ uint8_t lut_all[THREADS / 4][256];
    const int tid = blockIdx.x * THREADS + threadIdx.x;
    const int b = tid >> 2;
    const int j = tid & 3;
    const int l = 3 - j;                  // the rANS state of this lane
    const bool live = b < B;
    // threads past the ragged edge shadow the last block and never write
    const size_t bb = live ? b : B - 1;

    // byte -> dense index: the count of alphabet entries below the byte
    uint8_t* lut = lut_all[threadIdx.x >> 2];
    const uint8_t* al = alpha + bb * (size_t)A;
    for (int v = j; v < 256; v += 4) {
        int c = 0;
        for (int k = 0; k < A; ++k) c += al[k] < v;
        lut[v] = (uint8_t)c;
    }
    __syncwarp();

    const int A2 = ORDER ? A * A : A;
    const uint8_t* in = blocks + bb * (size_t)N;
    const int32_t* tb = packed + bb * (size_t)A2;
    const uint32_t xmult = (RANS_L >> sh) << 16;
    uint16_t* w = words + bb * (size_t)cap;
    const unsigned gsh = (threadIdx.x & 31u) & ~3u;

    uint32_t X = RANS_L;
    int n = 0;
    for (int s = 0; s < K; ++s) {
        const bool ok = enc_active<ORDER>(s, j, geom);
        uint32_t start = 0, f = 0;
        if (ok) {
            int key;
            if (ORDER) {
                // state l codes its quarter [l*q, (l+1)*q) backwards;
                // state 3's runs on through the tail to N - 1
                const int p = (l + 1) * q - 1 - s + geom;
                const int c = p == l * q ? 0 : lut[in[p - 1]];
                key = c * A + lut[in[p]];
            } else {
                key = lut[in[4 * (K - 1 - s) + l]];
            }
            const int32_t e = key < A2 ? tb[key] : 0;
            start = (uint32_t)(e >> PACK_SHIFT);
            f = (uint32_t)(e & PACK_MASK);
        }
        enc16_put(X, n, w, start, f, ok, live, j, gsh, xmult, sh);
    }
    if (live) {
        states[bb * 4 + l] = X;
        if (j == 0) counts[bb] = n;
    }
    reverse_rows(words, cap, n, B);
}

// blocks (B,N) u8, alpha (B,A) u8 (A <= 255), packed (B, order ? A*A :
// A) i32, one shift for the batch; out: states (B,4) u32 in state
// order, words (B,cap) u16 forward order (cap >= 4K), counts (B,) i32.
// Returns cudaGetLastError().
extern "C" int rans16_enc_packed_launch(const void* blocks, const void* alpha,
                                        const void* packed, void* states,
                                        void* words, void* counts, int B,
                                        int N, int A, int order, int shift,
                                        int cap, void* stream)
{
    if (B <= 0) return 0;
    int q, K, geom;
    if (order) {
        q = N >> 2;
        geom = N - 4 * q;          // state-3 tail length
        K = q + geom;
    } else {
        K = (N + 3) >> 2;
        geom = 4 * K - N;          // idle lanes of the first step
        q = K;
    }
    if (q < 1 || cap < 4 * K || A < 1 || A > 255 || shift < 1 || shift > 15)
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((size_t)B * 4 + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (order)
        rans16_enc_packed_kernel<1><<<grid, THREADS, 0, st>>>(
            (const uint8_t*)blocks, (const uint8_t*)alpha,
            (const int32_t*)packed, (uint32_t*)states, (uint16_t*)words,
            (int32_t*)counts, B, N, A, q, K, geom, cap, shift);
    else
        rans16_enc_packed_kernel<0><<<grid, THREADS, 0, st>>>(
            (const uint8_t*)blocks, (const uint8_t*)alpha,
            (const int32_t*)packed, (uint32_t*)states, (uint16_t*)words,
            (int32_t*)counts, B, N, A, q, K, geom, cap, shift);
    return (int)cudaGetLastError();
}
