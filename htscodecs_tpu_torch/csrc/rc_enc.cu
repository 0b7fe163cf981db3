// rc_enc: the carry-counting range-coder chain over triples replayed on
// the host, for sm_90a.
//
// Replaces the Pallas prefetched-triple kernel of the JAX package
// (htscodecs_tpu/ops/rc_vmem.py, _build_rc_kernel / _rc_vmem) with its
// event compaction, capacity tiers, stitch sorts, packed byte plane and
// exception planes.  The model walk of an adaptive codec whose contexts
// do not fit on chip (fqzcomp_qual: 65536 models per job) runs on the
// host and emits one (acc, f, tot) triple of uint16_t per coded event;
// this kernel runs RC_Encode + RC_ShiftLow over each job's triples, one
// thread per job, and writes the stream bytes and the five finishing
// shifts directly (rc_core.cuh).  Event counts are ragged: a thread
// stops at its own count, so no padding guard is needed beyond the
// coder's own (a total or frequency of 0 is taken as 1).
//
// Bound on this card: memory traffic (6 bytes per event in, the emitted
// bytes out); in fact latency-bound: one divide-and-shift chain per
// thread, and a batch has only as many threads as jobs.  The triple
// loads do not depend on the coder's state and run ahead of it.

#include "rc_core.cuh"

__global__ void rc_enc_kernel(const uint16_t* __restrict__ acc,
                              const uint16_t* __restrict__ frq,
                              const uint16_t* __restrict__ tot,
                              const int32_t* __restrict__ lens,
                              uint8_t* __restrict__ out,
                              int32_t* __restrict__ counts,
                              int B, int Kp, int cap)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t off = (size_t)b * Kp;
    const uint16_t* a = acc + off;
    const uint16_t* f = frq + off;
    const uint16_t* t = tot + off;
    const int n = min(max(lens[b], 0), Kp);
    RcEnc rc;
    rc_enc_init(rc, out + (size_t)b * cap);
    for (int k = 0; k < n; ++k) rc_encode(rc, a[k], f[k], t[k]);
    counts[b] = rc_finish(rc);
}

// acc, frq, tot (B,Kp) u16, lens (B,) i32 events per block, out (B,cap)
// u8 with cap >= 2*Kp + 8, counts (B,) i32.  Returns cudaGetLastError().
extern "C" int rc_enc_launch(const void* acc, const void* frq,
                             const void* tot, const void* lens, void* out,
                             void* counts, int B, int Kp, int cap, int tpb,
                             void* cuda_stream)
{
    if (B <= 0) return 0;
    if (Kp < 0 || cap < 2 * Kp + 8 || tpb < 1 || tpb > 1024)
        return (int)cudaErrorInvalidValue;
    rc_enc_kernel<<<rc_grid(B, tpb), tpb, 0, (cudaStream_t)cuda_stream>>>(
        (const uint16_t*)acc, (const uint16_t*)frq, (const uint16_t*)tot,
        (const int32_t*)lens, (uint8_t*)out, (int32_t*)counts, B, Kp, cap);
    return (int)cudaGetLastError();
}
