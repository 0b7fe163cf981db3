// arith_dec: batched arith_dynamic decode (CRAM 3.1 adaptive range
// coder), order 0 and order 1, for sm_90a.
//
// Replaces the Pallas decode kernel of the JAX package
// (htscodecs_tpu/ops/arith_vmem.py, _build_dec_kernel / _dec_vmem),
// which is order-0 only, caps the model at 64 entries and the stream at
// 49152 bytes, reads stream bytes through a one-hot window and divides
// through float reciprocals with fix-up rounds; and the order-1 case of
// the XLA scan (ops/arith_jax.py, _dec_scan).
//
// Bound on this card: memory traffic (stream bytes in, B*K bytes out).
// In fact each block is one serial chain per symbol: range / total and
// code / range, a walk of the cumulative frequencies as c_simple_model.h
// walks them, the model update (rc_core.cuh), at most two stream bytes.
// One thread runs one block's chain, `blockDim.x` blocks per CTA, and
// the design keeps memory latency and divides off the chain:
//
//   - the models live in shared memory, initialised by the kernel
//     (entry j = j << 16 | (j < max_syms), total max_syms): no bank is
//     built or read.  A row holds the model and the reciprocals of its
//     total and of the total + 16, the three in one 16-byte load.
//     Order 0: one row per block.
//     Order 1: a 256-byte context -> slot map and a pool of `pool` rows
//     per block; a row is claimed the first time its context occurs
//     (context 0 is always first and owns slot 0, so a map entry of 0
//     means "not yet" for every other context).  Contexts past the pool
//     get rows of a global bank (`gbank`, B x (M - pool) rows),
//     initialised the same way on first use; the step runs on shared or
//     global rows through the same inlined code;
//   - neither divide stays (dec_symbol): range / total through the
//     row's reciprocal and one correction, code / range not at all (the
//     walk compares products); the reciprocals come from a table in
//     global memory one symbol ahead of their use;
//   - the next two stream bytes are loaded through the read-only path
//     one symbol ahead of their use;
//   - decoded bytes are stored as the chain produces them: gathering
//     them in shared memory into 16-byte stores put more on the chain
//     than it saved (28.8 against 26.4 ms at B = 4096 x 64 KiB, order 1,
//     on an H100: PERF.md);
//   - each thread's region of shared memory is an odd number of 16-byte
//     units, so the 16-byte loads of the threads of a warp do not meet
//     in one bank.
//
// Invalid input is defined as the JAX device functions define it, and
// the plain version does the same: a read at or past the block's byte
// count gives 0 (and still advances); a payload under 6 bytes decodes
// nothing (zeros); if range < total the range is not divided and the
// target is 0; the target is capped at 65535; a walk past the last entry
// gives position M: symbol 0, frequency 1, only the total is updated.
// Output bytes past a block's length are 0.

#include "rc_core.cuh"

namespace {

struct Dec {
    uint32_t code, range, b0, b1;   // b0, b1: the next two stream bytes
    int pos;
};

__device__ __forceinline__ uint32_t byte_at(const uint8_t* __restrict__ by,
                                            int pos, int nb)
{
    return pos < nb ? (uint32_t)__ldg(by + pos) : 0u;
}

// One symbol from the model row `row`; the row is updated.  At order 1
// the map entry of the decoded symbol, the next context, is loaded
// before the update: `next` gets it.
//
// No divide is left on the chain: r = range / total takes the row's
// reciprocal (rc_udiv); the reference's target = min(code / r, 65535)
// is only compared with cumulative frequencies x, and x <= target is
// x * r <= code: x is at most the sum of the row's frequencies, which
// never passes the total or 65535 (rc_core.cuh), so x <= 65535 and
// x * r <= range fits in 32 bits.  Past the first symbol the range is
// at least 2^16 > total, so the undivided case (range < total, target
// 0) is a branch that valid and invalid streams alike never take after
// the first symbol.  The update moves the row's second reciprocal into
// the first (the total grows by 16 unless the row is halved, which
// divides afresh), and the reciprocal of total + 32 comes from `rtab`
// (rtab[t] = rc_udiv_recip(max(t, 1))) through `pend`, which the caller
// stores before the next symbol.
template <int ORDER, class Row>
__device__ __forceinline__ uint32_t dec_symbol(Row row, int M, Dec& d,
                                               const uint8_t* __restrict__ by,
                                               int nb, int map, int& next,
                                               Pending& pend,
                                               const uint32_t* __restrict__ rtab)
{
    // the total and both reciprocals in one load, beside the first entry
    const uint4 h = row.head(M);
    uint32_t e = row[0];
    const uint32_t tot = h.x;
    pend.begin(row, M, tot, rtab);
    const uint32_t total = max(tot, 1u);
    int p = 0;
    uint32_t acc = 0u, prev = 0u, r;
    if (d.range >= total) {
        r = rc_udiv(d.range, total, h.y);
        for (;;) {
            const uint32_t x = acc + (e & 0xFFFFu);
            if (x * r > d.code) break;
            acc = x;
            prev = e;
            e = row[++p];       // row[M] is the total: in bounds
            if (p == M) break;
        }
    } else {
        r = d.range;
        while (p < M && (e & 0xFFFFu) == 0u) {
            prev = e;
            e = row[++p];
        }
    }
    const uint32_t sym = p < M ? e >> 16 : 0u;
    if (ORDER) next = reinterpret_cast<const uint8_t*>(dsmem)[map + (int)sym];
    d.code -= acc * r;
    d.range = r * (p < M ? max(e & 0xFFFFu, 1u) : 1u);
    if (d.range < RC_TOP) {
        d.code = (d.code << 8) | d.b0;
        d.range <<= 8;
        ++d.pos;
        if (d.range < RC_TOP) {
            d.code = (d.code << 8) | d.b1;
            d.range <<= 8;
            ++d.pos;
            d.b0 = byte_at(by, d.pos, nb);
        } else {
            d.b0 = d.b1;
        }
        d.b1 = byte_at(by, d.pos + 1, nb);
    }
    pend.end(row, M, h, tot, model_update(row, M, p, e, prev, tot));
    return sym;
}

}  // namespace

template <int ORDER>
__global__ void arith_dec_kernel(const uint8_t* __restrict__ stream,
                                 const int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ lens,
                                 const int32_t* __restrict__ msyms,
                                 uint32_t* __restrict__ gbank,
                                 const uint32_t* __restrict__ rtab,
                                 uint8_t* __restrict__ out,
                                 int B, int W, int K, int M, int pool,
                                 int words)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const uint8_t* by = stream + (size_t)b * W;
    const int nb = min(max(counts[b], 0), W);
    const int ms = msyms[b];
    const int mine = threadIdx.x * words;                   // word index
    Models md{4 * mine, mine + (ORDER ? 64 : 0) + row_pad(M),
              ORDER ? gbank + (size_t)b * (M - pool) * row_stride(M) + row_pad(M)
                    : nullptr,
              pool, row_stride(M), M, ms, 1};
    md.init(ORDER);
    Pending pend{md.rows + M + 2, nullptr, dsmem[md.rows + M + 2]};

    // RC_StartDecode: five bytes prime the code; a stream too short to
    // hold them and one more decodes nothing
    const int n = nb >= 6 ? min(max(lens[b], 0), K) : 0;
    Dec d;
    d.code = 0u;
    if (nb >= 6)
        for (int k = 0; k < 5; ++k) d.code = (d.code << 8) | by[k];
    d.range = 0xFFFFFFFFu;
    d.pos = 5;
    d.b0 = byte_at(by, 5, nb);
    d.b1 = byte_at(by, 6, nb);

    uint8_t* o = out + (size_t)b * K;
    int slot = 0, ctx = 0;
    for (int i = 0; i < n; ++i) {
        int next = 0;
        if (ORDER) slot = md.claim(slot, ctx);
        pend.store();
        uint32_t sym;
        if (!ORDER || slot < pool)
            sym = dec_symbol<ORDER>(md.srow(slot), M, d, by, nb, md.map, next,
                                    pend, rtab);
        else
            sym = dec_symbol<ORDER>(md.grow(slot), M, d, by, nb, md.map, next,
                                    pend, rtab);
        o[i] = (uint8_t)sym;
        slot = next;
        ctx = (int)sym;
    }
    for (int i = n; i < K; ++i) o[i] = 0;
}

// stream (B,W) u8, counts (B,) i32 bytes that belong to each block,
// lens (B,) i32 bytes to decode, msyms (B,) i32 the models' initial
// width, gbank (B, M - pool, row_stride(M)) u32 + 4 words scratch (order 1 with
// pool < M; may be null otherwise), rtab (65536,) u32 the reciprocals
// rc_udiv_recip(max(t, 1)), out (B,K) u8; pool rows of shared memory
// per block at order 1 (1..M).  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for bad arguments).
extern "C" int arith_dec_launch(const void* stream, const void* counts,
                                const void* lens, const void* msyms,
                                void* gbank, const void* rtab, void* out,
                                int B, int W, int K,
                                int M, int order, int tpb, int pool,
                                void* cuda_stream)
{
    if (B <= 0 || K <= 0) return 0;
    if (W < 1 || M < 1 || M > 256 || tpb < 1 || tpb > 1024)
        return (int)cudaErrorInvalidValue;
    if (rtab == nullptr
        || (order && (pool < 1 || pool > M || (pool < M && gbank == nullptr))))
        return (int)cudaErrorInvalidValue;
    if (!order) pool = M;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const int words = model_words(M, order, pool);
    const size_t smem = (size_t)tpb * words * 4;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)cuda_stream;
    const unsigned grid = rc_grid(B, tpb);
    if (order) {
        cudaFuncSetAttribute(arith_dec_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        cudaFuncSetAttribute(arith_dec_kernel<1>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
        arith_dec_kernel<1><<<grid, tpb, smem, st>>>(
            (const uint8_t*)stream, (const int32_t*)counts,
            (const int32_t*)lens, (const int32_t*)msyms, (uint32_t*)gbank,
            (const uint32_t*)rtab, (uint8_t*)out, B, W, K, M, pool, words);
    } else {
        cudaFuncSetAttribute(arith_dec_kernel<0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        cudaFuncSetAttribute(arith_dec_kernel<0>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
        arith_dec_kernel<0><<<grid, tpb, smem, st>>>(
            (const uint8_t*)stream, (const int32_t*)counts,
            (const int32_t*)lens, (const int32_t*)msyms, (uint32_t*)gbank,
            (const uint32_t*)rtab, (uint8_t*)out, B, W, K, M, pool, words);
    }
    return (int)cudaGetLastError();
}
