// rans16_dec_packed: batched rANS 4x16 decode, order 0 and order 1,
// straight from the packed (base << 13 | freq) rows, for sm_90a.
//
// Replaces the first-generation Pallas decode of the JAX package
// (htscodecs_tpu/ops/rans_pallas.py, _dec_kernel_body / _dec_tile, with
// the prologue of _dec_pallas_to_bytes and its byte reassembly).  That
// kernel transposes 128 blocks into lanes, bucketed word windows in
// on-chip memory (W up to 12288 words, wider streams fall back) and
// resolves a slot with masked max-reductions over the whole table.
// Here, as in rans16_dec:
//
//   - one 4-thread group per rANS block, thread l = rANS state l; a
//     warp carries 8 blocks.  Words are claimed in state order 0..3 by
//     one warp ballot plus a popcount of the lower states' bits.
//   - the kernel reads what the device table build makes, with no
//     conversion pass first: the block's packed rows (A*A int32 at
//     order 1, A at order 0) and its alphabet, through L1/L2, and the
//     words (B, W) as given (any W; reads past W give 0).
//   - slot m of row ctx resolves to the LAST entry of the row's A
//     entries with freq > 0 and base <= m (a zero-frequency hole has
//     the running base of its successor, so a search that ignores freq
//     finds the hole; pad entries are 0).  Among the first asz entries
//     the bases never decrease (a hole carries its successor's base, so
//     the last entry with base <= m there is never a hole) and only the
//     zero pad entries past asz break the order; the kernel is not told
//     asz, so it scans all A entries linearly where a bisection over the
//     first asz would do.  No entry found gives sym 0, base 0, freq 0,
//     as the TPU kernel's masked max of nothing does.
//   - decoded bytes go straight to the (B, N) output in final order
//     (order 1: state l's quarter at l*q + step, the state-3 tail after
//     the four quarters; order 0: 4*step + l): the reassembly of
//     _dec_pallas_to_bytes happens here.
//
// Bound on this card: operations (the state step and a bisection of
// the row, as for rans16_dec); the linear scan does ~4 per entry, A
// entries per symbol, and one state per thread makes it latency-bound.

#include "rans_group.cuh"

#define RANS_L (1u << 15)
#define PACK_SHIFT 13
#define PACK_MASK ((1 << PACK_SHIFT) - 1)

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
rans16_dec_packed_kernel(const uint32_t* __restrict__ states,
                         const uint16_t* __restrict__ words,
                         const int32_t* __restrict__ packed,
                         const uint8_t* __restrict__ alpha,
                         uint8_t* __restrict__ out,
                         int B, int W, int A, int N, int q, int K, int sh)
{
    const int tid = blockIdx.x * THREADS + threadIdx.x;
    const int b = tid >> 2;
    const int lane = tid & 3;
    const bool live = b < B;
    // threads past the ragged edge shadow the last block (valid
    // memory, same control flow for the warp ballot) and never write
    const size_t bb = live ? b : B - 1;

    const uint32_t mask = (1u << sh) - 1u;
    uint32_t X = states[bb * 4 + lane];
    const uint16_t* wrd = words + bb * (size_t)W;
    const int32_t* tb = packed + bb * (size_t)(ORDER ? A * A : A);
    const uint8_t* al = alpha + bb * (size_t)A;
    uint8_t* o = out + bb * (size_t)N;
    const unsigned gsh = (threadIdx.x & 31u) & ~3u;  // group's first bit

    int p = 0;
    int ctx = 0;
    for (int s = 0; s < K; ++s) {
        const bool act = ORDER ? (s < q || lane == 3) : true;
        const int32_t* row = tb + (ORDER ? ctx * A : 0);
        const uint32_t m = X & mask;
        int32_t hit = 0;
        int sym = 0;
        for (int k = 0; k < A; ++k) {
            const int32_t e = row[k];
            if ((e & PACK_MASK) != 0 && (e >> PACK_SHIFT) <= (int32_t)m) {
                hit = e;
                sym = k;
            }
        }
        const uint32_t bs = (uint32_t)(hit >> PACK_SHIFT);
        const uint32_t f = (uint32_t)(hit & PACK_MASK);
        uint32_t Xn = f * (X >> sh) + m - bs;
        const bool need = act && Xn < RANS_L;
        const unsigned g = (__ballot_sync(0xffffffffu, need) >> gsh) & 0xFu;
        if (need) {
            const int pos = p + __popc(g & ((1u << lane) - 1u));
            const uint32_t w = pos < W ? wrd[pos] : 0u;
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

// states (B,4) u32, words (B,W) u16, packed (B, order ? A*A : A) i32,
// alpha (B,A) u8, out (B,N) u8; one shift for the batch.  Returns
// cudaGetLastError().
extern "C" int rans16_dec_packed_launch(const void* states, const void* words,
                                        const void* packed, const void* alpha,
                                        void* out, int B, int W, int A, int N,
                                        int order, int shift, void* stream)
{
    if (B <= 0 || N <= 0) return 0;
    if (A < 1 || W < 0 || shift < 1 || shift > 15)
        return (int)cudaErrorInvalidValue;
    const int q = order ? (N >> 2) : ((N + 3) >> 2);
    const int K = order ? q + (N - 4 * q) : q;
    const unsigned grid = (unsigned)(((size_t)B * 4 + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (order)
        rans16_dec_packed_kernel<1><<<grid, THREADS, 0, st>>>(
            (const uint32_t*)states, (const uint16_t*)words,
            (const int32_t*)packed, (const uint8_t*)alpha, (uint8_t*)out,
            B, W, A, N, q, K, shift);
    else
        rans16_dec_packed_kernel<0><<<grid, THREADS, 0, st>>>(
            (const uint32_t*)states, (const uint16_t*)words,
            (const int32_t*)packed, (const uint8_t*)alpha, (uint8_t*)out,
            B, W, A, N, q, K, shift);
    return (int)cudaGetLastError();
}
