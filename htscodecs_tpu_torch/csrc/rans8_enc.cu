// rans8_enc: batched rANS 4x8 (CRAM 3.0) encode, order 0 and order 1,
// from the raw block bytes and the packed (base << 13 | freq) rows, for
// sm_90a.
//
// Replaces the Pallas 4x8 encode of the JAX package
// (htscodecs_tpu/ops/rans8_vmem.py, _build_enc_kernel / _enc_vmem8)
// with the stitch sort that follows it.  That kernel lays 128 blocks
// out in lanes, picks each entry with select chains, places each
// segment's bytes into a fixed capacity (with an overflow retry) and
// leaves the cross-segment placement to a sort.  Here, on the layout
// the 4x16 encoder uses (rans_group.cuh):
//
//   - one 4-thread group per rANS block, thread j = processing lane j
//     (rANS state l = 3 - j), 32-thread CTAs of 8 blocks, so that a
//     batch of 4096 blocks spreads over every SM.  Kept from the JAX
//     kernel: the order-1 tail steps that move state 3 alone and the
//     order-0 first-step pad (enc_active);
//   - the packed entry gives start and freq directly, so a row's total
//     (4x8 rows normalise to 4095 slots, or 4096) never enters the
//     encoder, and no base-row conversion runs before it.  The CTA moves
//     its blocks' entries into shared memory beside the reciprocals of
//     their freqs where they fit (ops/rans_vmem.py, enc_tables_in_smem:
//     order 1 up to A = 48); wider tables are read from global memory
//     and the reciprocal is computed per symbol.  A byte above the
//     block's alphabet, as symbol or as context, reads the zero entry
//     past the table (freq 0, start 0), as the JAX engine's one-hot
//     select of nothing does; a freq of 0 divides by 1 (where the XLA
//     engine's divide by zero gives a quotient of all ones).  A byte
//     between alphabet entries takes the entry above it.  A one-symbol
//     row's freq of 4096 gives x_max = 2^31, which fits in 32 bits;
//   - each lane's bytes are staged in reverse ahead of the chain by
//     cp.async (BackStage): at order 1 a ring per lane over its quarter
//     (state 3's runs on through the tail), at order 0 one ring per
//     block, filled by lane 0; byte -> dense index through a 256-entry
//     table per block; rings and tables padded against bank conflicts;
//   - the lookup of a step (two ring bytes, two byte-table entries, one
//     table entry) does not depend on the state, so it is pipelined:
//     the iteration of step s loads the ring bytes of step s + 3, the
//     byte-table entries of step s + 2 and the entry of step s + 1, and
//     no step branches on its data;
//   - renormalisation emits up to two bytes per state and step
//     (rANS_byte.h RansEncRenorm: x_max = ((L >> 12) << 8) * freq; the
//     low byte first, the second only if the state is still >= x_max).
//     Emission order inside a step is lane 0..3 with a lane's two bytes
//     adjacent, so a lane's first byte ranks at the running count plus
//     the lower lanes' bytes (two ballots, two popcounts);
//   - the divide is rc_core.cuh's divide-free quotient (rc_udiv);
//   - bytes are written in forward order at once: the byte of emission
//     rank r goes to cap - 1 - r (a step's second byte to the next rank
//     down), so that a block's stream is the last counts[b] bytes of its
//     row (convert.streams8_to_reference reads the suffix).  No pass
//     reverses them afterwards.
//
// Bound on this card: operations (the step with its divide, the second
// emission test and the lookup, ahead of one byte per symbol in and the
// bytes out); in fact the serial chain of one state per thread sets the
// time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_group.cuh"

#define RANS8_L (1u << 23)
#define SHIFT 12
#define XMULT ((RANS8_L >> SHIFT) << 8)

template <int ORDER, bool SMEM>
__global__ void __launch_bounds__(ENC_THREADS)
rans8_enc_kernel(const uint8_t* __restrict__ blocks,
                 const uint8_t* __restrict__ alpha,
                 const int32_t* __restrict__ packed,
                 uint32_t* __restrict__ states,
                 uint8_t* __restrict__ out,
                 int32_t* __restrict__ counts,
                 int B, int N, int A, int q, int K, int geom, int cap)
{
    const int bpc = ENC_THREADS / 4;
    const int tid = opaque(threadIdx.x);
    const int g = tid >> 2;
    const int j = tid & 3;
    const int l = 3 - j;
    const int b0 = opaque(blockIdx.x * bpc);
    const bool live = b0 + g < B;
    // threads past the ragged edge shadow the last block and never write
    const int gl = live ? g : B - 1 - b0;
    const size_t bb = b0 + gl;
    const int A2 = ORDER ? A * A : A;

    uint8_t* const rings = reinterpret_cast<uint8_t*>(dsmem);
    uint8_t* const luts = rings + bpc * RING_BLK;
    uint2* const tabs = reinterpret_cast<uint2*>(rings + bpc * (RING_BLK + LUT_STRIDE));
    enc_prologue<SMEM>(luts, tabs, alpha, packed, b0, min(bpc, B - b0), A,
                       A2, tid);

    // order 1: the lane's quarter (state 3's through the tail), staged
    // by each lane; order 0: the whole block, staged by lane 0
    const uint8_t* in = blocks + bb * (size_t)N;
    const int lo = ORDER ? l * q : 0;
    const int hi = ORDER ? (l == 3 ? N - 1 : (l + 1) * q - 1) : N - 1;
    const int first = ORDER ? (l == 3 ? 0 : geom) : 0;
    BackStage sg;
    if (ORDER)
        sg.init(rings + (g * 4 + j) * RING_STRIDE1, RB, in + lo, hi - lo + 1);
    else
        sg.init(rings + g * RING_STRIDE0, 4 * RB, in, N);
    const int skew = (int)(in + lo - sg.base);
    const bool stager = ORDER || j == 0;
    if (stager) {
        sg.fill_below(sg.end - 1);
        cp_async_commit();
        cp_async_wait<0>();
    }
    __syncthreads();

    const uint8_t* lut = luts + gl * LUT_STRIDE;
    const uint2* te = tabs + gl * (A2 + 1);
    const int32_t* tg = packed + bb * (size_t)A2;

    // the block byte that step t codes (order 0: past K it is negative,
    // before the lane's first order-1 step past hi; neither is coded)
    auto pos = [&](int t) {
        return ORDER ? hi - (t - first) : 4 * (K - 1 - t) + l;
    };
    auto coded = [&](int t) { return t < K && enc_active<ORDER>(t, j, geom); };
    // step t's symbol byte and (order 1) context byte from the ring
    auto ring_bytes = [&](int t, uint32_t& c0, uint32_t& c1) {
        const int r = skew + pos(t) - lo;
        c0 = sg.at(r);
        c1 = ORDER ? sg.at(r - 1) : 0u;
    };
    // step t's entry from its dense symbol and context: a quarter's
    // first symbol is coded in context 0; a dense index past the
    // alphabet, and a step that codes nothing, read the zero entry A2.
    // At order 1 a context past the alphabet puts the key past A2 and
    // the tests take no short cut: written with && there, the select
    // cost ~50 cycles per step (order 0 is faster as it stands)
    auto entry = [&](int t, uint32_t d0, uint32_t d1) {
        int key;
        if (ORDER) {
            const uint32_t ctx = pos(t) != lo ? d1 : 0u;
            const int k = min((int)(d0 + ctx * A), A2);
            key = coded(t) & (d0 < (uint32_t)A) ? k : A2;
        } else {
            key = coded(t) && d0 < (uint32_t)A ? (int)d0 : A2;
        }
        if (SMEM) return te[key];
        const uint32_t e = key < A2 ? (uint32_t)__ldg(tg + key) : 0u;
        return make_uint2(e, 0u);
    };

    uint8_t* w = out + bb * (size_t)cap + (cap - 1);   // rank r at w[-r]
    const unsigned gsh = (unsigned)tid & 28u;
    const unsigned lower = (1u << j) - 1u;
    uint32_t X = RANS8_L;
    int n = 0;
    // Step s codes with its entry E; it is handed the dense pair (d0, d1)
    // of step s + 1 and the ring bytes (c0, c1) of step s + 2, and loads
    // the entry E1 of step s + 1, the dense pair (e0, e1) of step s + 2
    // and the ring bytes (r0, r1) of step s + 3.  The loop runs two steps
    // with the register sets swapped, so that nothing is copied out of a
    // register that a load has just been issued to.
    auto step = [&](int s, uint2 E, uint32_t d0, uint32_t d1, uint32_t c0,
                    uint32_t c1, uint2& E1, uint32_t& e0, uint32_t& e1,
                    uint32_t& r0, uint32_t& r1) {
        ring_bytes(s + 3, r0, r1);
        e0 = lut[c0];
        e1 = lut[c1];
        E1 = entry(s + 1, d0, d1);

        const bool ok = coded(s);
        const uint32_t f = E.x & PACK_MASK;
        const uint32_t fs = max(f, 1u);
        const uint32_t rcp = SMEM ? E.y : rc_udiv_recip(fs);
        const uint32_t start = E.x >> PACK_SHIFT;
        const uint32_t xm = XMULT * f;
        const uint32_t x1 = X >> 8;
        const bool emit1 = ok && X >= xm;
        const bool emit2 = emit1 && x1 >= xm;
        const unsigned g1 = (__ballot_sync(0xffffffffu, emit1) >> gsh) & 0xFu;
        const unsigned g2 = (__ballot_sync(0xffffffffu, emit2) >> gsh) & 0xFu;
        const int r = n + __popc(g1 & lower) + __popc(g2 & lower);
        st_if(emit1 && live, w - r, X);
        st_if(emit2 && live, w - r - 1, x1);
        n += __popc(g1) + __popc(g2);
        const uint32_t x2 = emit2 ? X >> 16 : (emit1 ? x1 : X);
        const uint32_t qq = rc_udiv(x2, fs, rcp);
        const uint32_t xn = (qq << SHIFT) + (x2 - qq * fs) + start;
        X = ok ? xn : X;
    };
    uint32_t a0, a1, ca0, ca1, cb0, cb1, da0, da1, db0, db1;
    uint2 Ea, Eb;
    ring_bytes(0, a0, a1);
    ring_bytes(1, ca0, ca1);
    Ea = entry(0, lut[a0], lut[a1]);
    da0 = lut[ca0];
    da1 = lut[ca1];
    ring_bytes(2, ca0, ca1);
    for (int s = 0; s < K; s += 2) {      // a step past K codes nothing
        if (s % SE == 0) {
            if (stager) {
                // the highest byte still to be read: step s's symbol
                // (order 0: lane 0 is state 3, the step's last byte)
                const int p = s < first ? hi : min(pos(s), hi);
                sg.fill_below(skew + p - lo);
                cp_async_commit();
                cp_async_wait<1>();
            }
            __syncwarp();
        }
        step(s, Ea, da0, da1, ca0, ca1, Eb, db0, db1, cb0, cb1);
        step(s + 1, Eb, db0, db1, cb0, cb1, Ea, da0, da1, ca0, ca1);
    }
    cp_async_wait<0>();
    if (live) {
        states[bb * 4 + l] = X;
        if (j == 0) counts[bb] = n;
    }
}

// blocks (B,N) u8 (16-byte aligned), alpha (B,A) u8 (A <= 255), packed
// (B, order ? A*A : A) i32; `smem_tables`: the entries in shared memory
// (always at order 0).  Out: states (B,4) u32 in state order, bytes
// (B,cap) u8 (cap >= 8K; block b's stream in forward order is the last
// counts[b] bytes of its row), counts (B,) i32.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for bad arguments).
extern "C" int rans8_enc_launch(const void* blocks, const void* alpha,
                                const void* packed, void* states, void* out,
                                void* counts, int B, int N, int A, int order,
                                int cap, int smem_tables, void* stream)
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
    if (q < 1 || cap < 8 * K || A < 1 || A > 255 || (!order && !smem_tables))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)blocks & 15) return (int)cudaErrorMisalignedAddress;
    const int bpc = ENC_THREADS / 4;
    const size_t smem = enc_smem(bpc, order ? A * A : A, smem_tables != 0);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((size_t)B + bpc - 1) / bpc);
    auto kernel = order ? (smem_tables ? rans8_enc_kernel<1, true>
                                       : rans8_enc_kernel<1, false>)
                        : rans8_enc_kernel<0, true>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, ENC_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const uint8_t*)alpha,
        (const int32_t*)packed, (uint32_t*)states, (uint8_t*)out,
        (int32_t*)counts, B, N, A, q, K, geom, cap);
    return (int)cudaGetLastError();
}
