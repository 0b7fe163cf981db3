// arith_dec: batched arith_dynamic decode (CRAM 3.1 adaptive range
// coder), order 0 and order 1, for sm_90a.
//
// Replaces the Pallas decode kernel of the JAX package
// (htscodecs_tpu/ops/arith_vmem.py, _build_dec_kernel / _dec_vmem),
// which is order-0 only, caps the model at 64 entries and the stream at
// 49152 bytes, reads stream bytes through a one-hot window and divides
// through float reciprocals with fix-up rounds; and the order-1 case of
// the XLA scan (ops/arith_jax.py, _dec_scan).  Here one thread per block
// runs the block's chain: range / total and code / range are the card's
// 32-bit divides, the symbol is found by walking the cumulative
// frequencies as c_simple_model.h does, at most two stream bytes are
// read per symbol straight from the block's row, and the model update is
// the encoder's (rc_core.cuh).  Model width up to 256 at run time; at
// order 1 the context's model is a row of the block's bank.
//
// Bound on this card: memory traffic (stream bytes in, B*K bytes out);
// in fact latency-bound, as arith_enc.
//
// Invalid input is defined as the JAX device functions define it, and
// the plain version does the same: a read at or past the block's byte
// count gives 0 (and still advances); a payload under 6 bytes decodes
// nothing (zeros); if range < total the range is not divided and the
// target is 0; the target is capped at 65535; a walk past the last entry
// gives position M: symbol 0, frequency 1, only the total is updated.
// Output bytes past a block's length are 0.

#include "rc_core.cuh"

template <int ORDER>
__global__ void arith_dec_kernel(const uint8_t* __restrict__ stream,
                                 const int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ lens,
                                 uint32_t* __restrict__ bank,
                                 uint8_t* __restrict__ out,
                                 int B, int W, int K, int M)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const uint8_t* by = stream + (size_t)b * W;
    const int nb = min(max(counts[b], 0), W);
    uint8_t* o = out + (size_t)b * K;
    const int M1 = M + 1;
    uint32_t* mdl = bank + (size_t)b * (ORDER ? M : 1) * M1;

    // RC_StartDecode: five bytes prime the code; a stream too short to
    // hold them and one more decodes nothing
    const int n = nb >= 6 ? min(max(lens[b], 0), K) : 0;
    uint32_t code = 0u;
    if (nb >= 6)
        for (int k = 0; k < 5; ++k) code = (code << 8) | by[k];
    uint32_t range = 0xFFFFFFFFu;
    int pos = 5;

    int ctx = 0;
    for (int i = 0; i < n; ++i) {
        uint32_t* row = mdl + (ORDER ? ctx * M1 : 0);
        const uint32_t total = max(row[M], 1u);
        uint32_t r = range, target = 0u;
        if (range >= total) {
            r = range / total;
            target = min(code / r, 0xFFFFu);
        }
        int p = 0;
        uint32_t acc = 0u;
        uint32_t e = row[0];
        while (p < M && acc + (e & 0xFFFFu) <= target) {
            acc += e & 0xFFFFu;
            e = row[++p];       // row[M] is the total: in bounds
        }
        const uint32_t sym = p < M ? e >> 16 : 0u;
        code -= acc * r;
        range = r * (p < M ? max(e & 0xFFFFu, 1u) : 1u);
#pragma unroll
        for (int k = 0; k < 2; ++k)
            if (range < RC_TOP) {
                code = (code << 8) | (pos < nb ? (uint32_t)by[pos] : 0u);
                ++pos;
                range <<= 8;
            }
        model_update(row, M, p, e);
        o[i] = (uint8_t)sym;
        if (ORDER) ctx = (int)sym;
    }
    for (int i = n; i < K; ++i) o[i] = 0;
}

// stream (B,W) u8, counts (B,) i32 bytes that belong to each block,
// lens (B,) i32 bytes to decode, bank (B, order ? M : 1, M+1) u32 (the
// models' initial state, updated in place), out (B,K) u8.
// Returns cudaGetLastError().
extern "C" int arith_dec_launch(const void* stream, const void* counts,
                                const void* lens, void* bank, void* out,
                                int B, int W, int K, int M, int order,
                                int tpb, void* cuda_stream)
{
    if (B <= 0 || K <= 0) return 0;
    if (W < 1 || M < 1 || M > 256 || tpb < 1 || tpb > 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)cuda_stream;
    const unsigned grid = rc_grid(B, tpb);
    if (order)
        arith_dec_kernel<1><<<grid, tpb, 0, st>>>(
            (const uint8_t*)stream, (const int32_t*)counts,
            (const int32_t*)lens, (uint32_t*)bank, (uint8_t*)out,
            B, W, K, M);
    else
        arith_dec_kernel<0><<<grid, tpb, 0, st>>>(
            (const uint8_t*)stream, (const int32_t*)counts,
            (const int32_t*)lens, (uint32_t*)bank, (uint8_t*)out,
            B, W, K, M);
    return (int)cudaGetLastError();
}
