// rans16_enc_packed: batched rANS 4x16 encode, order 0 and order 1,
// from the raw block bytes and the packed (base << 13 | freq) rows, with
// one shift per block, for sm_90a.  The port's one 4x16 encoder.
//
// Replaces four Pallas kernels of the JAX package that share one
// contract (B blocks of N bytes and their dense tables in; states,
// words and counts out):
//   - htscodecs_tpu/ops/rans_pallas.py, _enc_kernel_body / _enc_tile
//     with the _enc_pallas prologue (byte -> dense index, processing-
//     order grids) and the _compact compaction;
//   - htscodecs_tpu/ops/rans_vmem.py, _build_fetch_kernel (the
//     per-symbol (start, freq) fetch), _build_enc_kernel_pf (the
//     encode from the fetched values) and _build_enc_kernel (the encode
//     with the fetch inside), with their stitch sort.
// Those kernels lay 128 blocks out in lanes, gather with select chains
// and compact the emitted words with a segmented sort that can
// overflow and retry.  Here:
//
//   - one 4-thread group per rANS block, thread j = processing lane j
//     (rANS state l = 3 - j: the encoder walks the symbols in reverse,
//     state 3 first); 32-thread CTAs of 8 blocks.  Kept from the JAX
//     kernels: the order-1 tail steps that move state 3 alone, the
//     order-0 first-step pad (4K - N lanes idle) and the emit test
//     X >= ((L >> shift) << 16) * freq (rans_group.cuh, enc_active);
//   - the table is read in the packed form, as every caller holds it:
//     the device table build (ops/tables_v2.py) and the host densify
//     (rans_v2.densify_*) both make packed rows, and the base-row form
//     would cost a conversion pass (_b16_fill) before every encode.
//     convert.Tables (base rows) stays the decoder's form.  The CTA
//     moves its blocks' entries into shared memory in the form the step
//     reads: the packed entry beside the reciprocal of its freq (a freq
//     of 0 divides by 1), with one zero entry past the table for a key
//     past it (a byte above the block's alphabet), as the TPU kernel's
//     masked max of nothing reads 0.  Tables too wide for that (order 1
//     past A = 48) are read from global memory and the reciprocal is
//     computed per symbol;
//   - each lane's bytes are staged in reverse ahead of the chain by
//     cp.async (cp_async.cuh): at order 1 a ring of RB bytes per lane
//     over its quarter (state 3's runs on through the tail), at order 0
//     one ring of 4 RB per block, filled by lane 0; the rings and byte
//     tables are padded against bank conflicts.  Every SE steps a
//     lane asks for the segments of the next RB - 16 bytes and waits
//     for those asked for a round before.  Byte -> dense index is a
//     256-entry table per block in shared memory (the number of
//     alphabet entries below the byte, rans_v2._densify's rule); a
//     symbol's context is the previous byte of its quarter (a quarter's
//     first symbol is coded in context 0);
//   - the lookup of a step (two ring bytes, two byte-table entries, one
//     table entry) does not depend on the state, so it is
//     software-pipelined: the iteration of step s loads the ring bytes
//     of step s + 3, the byte-table entries of step s + 2 and the table
//     entry of step s + 1, and no step branches on its data;
//   - the divide is rc_core.cuh's divide-free quotient (rc_udiv): q =
//     umulhi(X, floor((2^32 - 1) / f)) and one correction, exact for
//     every 32-bit X and f >= 1 (tests/test_torch_rans_vmem.py holds it
//     against X // f for every f up to 4096);
//   - words are written in forward order at once: the word of emission
//     rank r goes to cap - 1 - r, so that a block's stream is the last
//     counts[b] words of its row.  No pass reverses them afterwards
//     (convert.streams_to_host and batch._join_bodies read the suffix).
//
// Bound on this card: operations (the step with its divide and the
// lookup, ahead of one byte per symbol in and the words out); in fact
// the serial chain of one state per thread sets the time.  The
// state's own chain per step is the compare, a select, a wide multiply,
// a multiply-add, the correction and a shift-add; the rest of a step is
// issued beside it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rans_group.cuh"

#define RANS_L (1u << 15)

template <int ORDER, bool SMEM>
__global__ void __launch_bounds__(ENC_THREADS)
rans16_enc_packed_kernel(const uint8_t* __restrict__ blocks,
                         const uint8_t* __restrict__ alpha,
                         const int32_t* __restrict__ packed,
                         const int32_t* __restrict__ shift,
                         uint32_t* __restrict__ states,
                         uint16_t* __restrict__ words,
                         int32_t* __restrict__ counts,
                         int B, int N, int A, int q, int K, int geom, int cap)
{
    const int bpc = ENC_THREADS / 4;
    const int tid = opaque(threadIdx.x);
    const int g = tid >> 2;
    const int j = tid & 3;
    const int l = 3 - j;                  // the rANS state of this lane
    const int b0 = opaque(blockIdx.x * bpc);
    const bool live = b0 + g < B;
    // threads past the ragged edge shadow the last block and never write
    const int gl = live ? g : B - 1 - b0;
    const size_t bb = b0 + gl;
    const int nblk = min(bpc, B - b0);
    const int A2 = ORDER ? A * A : A;

    uint8_t* const rings = reinterpret_cast<uint8_t*>(dsmem);
    uint8_t* const luts = rings + bpc * RING_BLK;
    uint2* const tabs = reinterpret_cast<uint2*>(rings + bpc * (RING_BLK + LUT_STRIDE));

    enc_prologue<SMEM>(luts, tabs, alpha, packed, b0, nblk, A, A2, tid);

    // the lane's bytes: order 1 its quarter (state 3: through the tail),
    // order 0 the whole block, staged by lane 0
    const uint8_t* in = blocks + bb * (size_t)N;
    const int lo = ORDER ? l * q : 0;
    const int hi = ORDER ? (l == 3 ? N - 1 : (l + 1) * q - 1) : N - 1;
    const int first = ORDER ? (l == 3 ? 0 : geom) : 0;   // its first step
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
    const int sh = shift[bb];
    const uint32_t xmult = (RANS_L >> sh) << 16;

    // Steps are software-pipelined, with no branch on the data: in the
    // iteration of step s the ring bytes of step s + 3, the byte-table
    // entries of step s + 2 and the table entry of step s + 1 are
    // loaded, so that no load waits on another inside one step and
    // none of them on the chain.  A step that codes nothing (the order-1
    // tail's idle lanes, the order-0 pad, past K) reads entry A2 and
    // leaves X alone.
    auto pos = [&](int t) {
        return ORDER ? hi - (t - first) : 4 * (K - 1 - t) + l;
    };
    auto ok_at = [&](int t) { return t < K && enc_active<ORDER>(t, j, geom); };
    // the step's symbol byte and (order 1) context byte from the ring
    auto bytes_at = [&](int t, uint32_t& b0, uint32_t& b1) {
        const int r = skew + pos(t) - lo;
        b0 = sg.at(r);
        b1 = ORDER ? sg.at(r - 1) : 0u;
    };
    // the step's key from its dense symbol and context
    auto key_at = [&](int t, uint32_t d0, uint32_t d1) {
        const int ctx = ORDER && pos(t) != lo ? (int)d1 : 0;
        return ok_at(t) ? min((int)d0 + ctx * A, A2) : A2;
    };
    auto entry_at = [&](int key) {
        if (SMEM) return te[key];
        const uint32_t e = key < A2 ? (uint32_t)__ldg(tg + key) : 0u;
        return make_uint2(e, 0u);
    };

    uint16_t* w = words + bb * (size_t)cap + (cap - 1);   // rank r at w[-r]
    const unsigned gsh = (unsigned)tid & 28u;
    const unsigned lower = (1u << j) - 1u;
    uint32_t X = RANS_L;
    int n = 0;
    // step s with its entry E, the dense symbol and context (d0, d1) of
    // step s + 1 and the bytes (c0, c1) of step s + 2; it loads the
    // entry E1 of step s + 1, the dense pair (e0, e1) of step s + 2 and
    // the bytes (b0, b1) of step s + 3.  The loop runs two steps with
    // the two register sets swapped, so that nothing is copied from a
    // register a load has just been issued to (the compiler's copies
    // at the end of a one-step body waited for those loads).
    auto step = [&](int s, uint2 E, uint32_t d0, uint32_t d1, uint32_t c0,
                    uint32_t c1, uint2& E1, uint32_t& e0, uint32_t& e1,
                    uint32_t& b0, uint32_t& b1) {
        bytes_at(s + 3, b0, b1);
        e0 = lut[c0];
        e1 = lut[c1];
        E1 = entry_at(key_at(s + 1, d0, d1));

        const bool ok = ok_at(s);
        const uint32_t f = E.x & PACK_MASK;
        const uint32_t fs = max(f, 1u);
        const uint32_t rcp = SMEM ? E.y : rc_udiv_recip(fs);
        const uint32_t start = (uint32_t)((int32_t)E.x >> PACK_SHIFT);
        const bool emit = ok && X >= xmult * f;
        const unsigned gb = (__ballot_sync(0xffffffffu, emit) >> gsh) & 0xFu;
        st_if(emit && live, w - (n + __popc(gb & lower)), (uint16_t)X);
        n += __popc(gb);
        const uint32_t x2 = emit ? X >> 16 : X;
        const uint32_t qq = rc_udiv(x2, fs, rcp);
        const uint32_t xn = (qq << sh) + (x2 - qq * fs) + start;
        X = ok ? xn : X;
    };
    uint32_t a0, a1, ca0, ca1, cb0, cb1, da0, da1, db0, db1;
    uint2 Ea, Eb;
    bytes_at(0, a0, a1);
    bytes_at(1, ca0, ca1);
    Ea = entry_at(key_at(0, lut[a0], lut[a1]));
    da0 = lut[ca0];
    da1 = lut[ca1];
    bytes_at(2, ca0, ca1);
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
// (B, order ? A*A : A) i32, shift (B,) i32 (each in [1, 15]);
// `smem_tables`: the entries in shared memory (always at order 0).  Out:
// states (B,4) u32 in state order, words (B,cap) u16 (cap >= 4K; block
// b's stream in forward order is the last counts[b] words of its row),
// counts (B,) i32.  Returns cudaGetLastError() (or cudaErrorInvalidValue
// / cudaErrorMisalignedAddress for bad arguments).
extern "C" int rans16_enc_packed_launch(const void* blocks, const void* alpha,
                                        const void* packed, const void* shift,
                                        void* states, void* words,
                                        void* counts, int B, int N, int A,
                                        int order, int cap, int smem_tables,
                                        void* stream)
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
    if (q < 1 || cap < 4 * K || A < 1 || A > 255 || (!order && !smem_tables))
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
    auto kernel = order ? (smem_tables ? rans16_enc_packed_kernel<1, true>
                                       : rans16_enc_packed_kernel<1, false>)
                        : rans16_enc_packed_kernel<0, true>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, ENC_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const uint8_t*)alpha,
        (const int32_t*)packed, (const int32_t*)shift, (uint32_t*)states,
        (uint16_t*)words, (int32_t*)counts, B, N, A, q, K, geom, cap);
    return (int)cudaGetLastError();
}
