// rans8_enc: batched rANS 4x8 (CRAM 3.0) encode, order 0 and order 1,
// for sm_90a.
//
// Replaces the Pallas 4x8 encode scan of the JAX package
// (htscodecs_tpu/ops/rans8_vmem.py, _build_enc_kernel / _enc_vmem8)
// together with the stitch sort that follows it.  That kernel picks its
// table row and entry with select chains, places each 32-step
// segment's bytes with one-hot adds into a fixed capacity (with an
// overflow retry) and leaves the cross-segment placement to a sort.
// Here:
//
//   - one 4-thread group per rANS block, thread j = processing lane j
//     (rANS state 3 - j); the (start, freq) pair is an indexed load
//     from the block's own monotone int16 base rows, whose successor
//     column holds the row's own total (4x8 rows normalise to 4095
//     slots), so freq = row[sym+1] - row[sym] holds for the last symbol;
//   - a lane emits 0, 1 or 2 bytes per step (rANS_byte.h
//     RansEncRenorm: the second only if the state is still >= x_max
//     after the first, low byte first).  Emission order inside a step is
//     lane 0..3, a lane's two bytes adjacent, so a lane's first byte
//     ranks at the running count plus the lower lanes' bytes: two
//     ballots (first-byte mask, second-byte mask) and two popcounts;
//   - the warp reverses each block's bytes in place at the end
//     (forward order = reverse of emission order).
//
// Bound on this card: memory traffic (2 bytes per symbol in, the
// tables, the emitted bytes out); latency-bound in practice.
//
// Per step (L = 1 << 23, 12-bit precision): x_max = ((L >> 12) << 8) * f
// (reaches 2^31 at f = 4096: uint32_t);
// X = (X / f << 12) + X % f + start after the renormalisation.

#include "rans_group.cuh"

#define RANS8_L (1u << 23)
#define SHIFT 12
#define XMULT ((RANS8_L >> SHIFT) << 8)

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
rans8_enc_kernel(const uint8_t* __restrict__ sym,
                 const uint8_t* __restrict__ ctx,
                 const int16_t* __restrict__ bases,
                 uint32_t* __restrict__ states,
                 uint8_t* __restrict__ out,
                 int32_t* __restrict__ counts,
                 int B, int K, int A, int geom, int cap)
{
    const int tid = blockIdx.x * THREADS + threadIdx.x;
    const int b = tid >> 2;
    const int j = tid & 3;
    const bool live = b < B;
    // threads past the ragged edge shadow the last block and never write
    const size_t bb = live ? b : B - 1;

    const int Ac = ORDER ? A : 1;
    const uint8_t* sy = sym + bb * (size_t)K * 4;
    const uint8_t* cx = ctx + bb * (size_t)K * 4;
    const int16_t* tb = bases + bb * (size_t)(Ac * (A + 1));
    uint8_t* w = out + bb * (size_t)cap;
    const unsigned gsh = (threadIdx.x & 31u) & ~3u;
    const unsigned lower = (1u << j) - 1u;

    uint32_t X = RANS8_L;
    int n = 0;
    for (int s = 0; s < K; ++s) {
        const bool ok = enc_active<ORDER>(s, j, geom);
        int st, nx;
        table_entry(tb, A, Ac, sy[4 * s + j], ORDER ? cx[4 * s + j] : 0,
                    st, nx);
        const uint32_t start = (uint32_t)st;
        const uint32_t f = (uint32_t)(nx - st);
        const uint32_t x_max = XMULT * f;
        const bool e1 = ok && X >= x_max;
        const uint32_t x1 = e1 ? X >> 8 : X;
        const bool e2 = e1 && x1 >= x_max;
        const uint32_t x2 = e2 ? x1 >> 8 : x1;
        const unsigned g1 = (__ballot_sync(0xffffffffu, e1) >> gsh) & 0xFu;
        const unsigned g2 = (__ballot_sync(0xffffffffu, e2) >> gsh) & 0xFu;
        if (e1 && live) {
            const int r = n + __popc(g1 & lower) + __popc(g2 & lower);
            w[r] = (uint8_t)X;
            if (e2) w[r + 1] = (uint8_t)x1;
        }
        n += __popc(g1) + __popc(g2);
        if (ok) {
            const uint32_t fs = f ? f : 1u;
            const uint32_t qq = x2 / fs;
            X = (qq << SHIFT) + (x2 - qq * fs) + start;
        }
    }
    if (live) {
        states[bb * 4 + (3 - j)] = X;
        if (j == 0) counts[bb] = n;
    }
    reverse_rows(out, cap, n, B);
}

// sym, ctx (B, 4K) u8 in processing order (step-major, lane-minor),
// bases (B, order ? A : 1, A+1) i16 with per-row totals in the last
// column; out: states (B,4) u32 in state order, bytes (B,cap) u8
// forward order (cap >= 8K), counts (B,) i32.
// Returns cudaGetLastError().
extern "C" int rans8_enc_launch(const void* sym, const void* ctx,
                                const void* bases, void* states, void* out,
                                void* counts, int B, int K, int A, int geom,
                                int cap, int order, void* stream)
{
    if (B <= 0) return 0;
    if (cap < 8 * K || A < 1) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((size_t)B * 4 + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (order)
        rans8_enc_kernel<1><<<grid, THREADS, 0, st>>>(
            (const uint8_t*)sym, (const uint8_t*)ctx, (const int16_t*)bases,
            (uint32_t*)states, (uint8_t*)out, (int32_t*)counts,
            B, K, A, geom, cap);
    else
        rans8_enc_kernel<0><<<grid, THREADS, 0, st>>>(
            (const uint8_t*)sym, (const uint8_t*)ctx, (const int16_t*)bases,
            (uint32_t*)states, (uint8_t*)out, (int32_t*)counts,
            B, K, A, geom, cap);
    return (int)cudaGetLastError();
}
