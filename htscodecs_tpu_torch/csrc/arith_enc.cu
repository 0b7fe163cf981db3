// arith_enc: batched arith_dynamic encode (CRAM 3.1 adaptive range
// coder), order 0 and order 1, for sm_90a.
//
// Replaces the Pallas encode kernel of the JAX package
// (htscodecs_tpu/ops/arith_vmem.py, _build_enc_kernel / _enc_vmem),
// which is order-0 only, caps the model at 64 entries, divides through
// staged float reciprocals, and emits packed byte events that a sort
// stitches and the host expands; and the order-1 case of the XLA scan
// (ops/arith_jax.py, _enc_scan), which serves what that kernel refuses.
// Here:
//
//   - one thread per block runs the block's whole chain: search the
//     model for the symbol as c_simple_model.h walks it (the bubble swap
//     keeps frequent symbols in front), RC_Encode with the card's own
//     32-bit divide, up to two RC_ShiftLow per symbol writing stream
//     bytes directly (rc_core.cuh), the model update;
//   - the model width M is a run-time argument up to 256 (the C model's
//     NSYM), the order a template parameter: at order 1 the context's
//     model is a pointer into the block's (M, M + 1) bank in device
//     memory, the context starts at 0 and becomes the coded symbol;
//   - lengths are ragged: a thread loops to its own length, then runs
//     the five finishing shifts and stores its byte count.
//
// Bound on this card: memory traffic (B*N bytes in, the emitted bytes
// out); in fact latency-bound, one serial chain (search, divide, model
// update) per thread.  The launch spreads the blocks over few threads
// per CTA so that the chains of different blocks do not serialise in one
// warp's divergent loops.
//
// A symbol that the model does not hold (only with a wrong max-symbol
// argument) codes as position M: acc = the sum of all frequencies,
// frequency 1, only the total is updated, and the next context is 0.
// The plain version does the same.

#include "rc_core.cuh"

template <int ORDER>
__global__ void arith_enc_kernel(const uint8_t* __restrict__ blocks,
                                 const int32_t* __restrict__ lens,
                                 uint32_t* __restrict__ bank,
                                 uint8_t* __restrict__ out,
                                 int32_t* __restrict__ counts,
                                 int B, int N, int M, int cap)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const uint8_t* in = blocks + (size_t)b * N;
    const int n = min(max(lens[b], 0), N);
    const int M1 = M + 1;
    uint32_t* mdl = bank + (size_t)b * (ORDER ? M : 1) * M1;
    RcEnc rc;
    rc_enc_init(rc);
    RowOut o{out + (size_t)b * cap, 0};

    int ctx = 0;
    for (int i = 0; i < n; ++i) {
        uint32_t* row = mdl + (ORDER ? ctx * M1 : 0);
        const uint32_t sym = in[i];
        int p = 0;
        uint32_t acc = 0u;
        uint32_t e = row[0];
        while (p < M && (e >> 16) != sym) {
            acc += e & 0xFFFFu;
            e = row[++p];       // row[M] is the total: in bounds
        }
        rc_encode(rc, o, acc, p < M ? (e & 0xFFFFu) : 0u, row[M]);
        model_update(row, M, p, e);
        if (ORDER) ctx = p < M ? (int)sym : 0;
    }
    rc_finish(rc, o);
    counts[b] = o.n;
}

// blocks (B,N) u8, lens (B,) i32, bank (B, order ? M : 1, M+1) u32 (the
// models' initial state, updated in place), out (B,cap) u8 with
// cap >= 2*N + 8, counts (B,) i32.  Returns cudaGetLastError().
extern "C" int arith_enc_launch(const void* blocks, const void* lens,
                                void* bank, void* out, void* counts,
                                int B, int N, int M, int cap, int order,
                                int tpb, void* cuda_stream)
{
    if (B <= 0) return 0;
    if (N < 0 || M < 1 || M > 256 || cap < 2 * N + 8 || tpb < 1 || tpb > 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)cuda_stream;
    const unsigned grid = rc_grid(B, tpb);
    if (order)
        arith_enc_kernel<1><<<grid, tpb, 0, st>>>(
            (const uint8_t*)blocks, (const int32_t*)lens, (uint32_t*)bank,
            (uint8_t*)out, (int32_t*)counts, B, N, M, cap);
    else
        arith_enc_kernel<0><<<grid, tpb, 0, st>>>(
            (const uint8_t*)blocks, (const int32_t*)lens, (uint32_t*)bank,
            (uint8_t*)out, (int32_t*)counts, B, N, M, cap);
    return (int)cudaGetLastError();
}
