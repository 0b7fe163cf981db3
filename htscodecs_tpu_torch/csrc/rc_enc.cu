// rc_enc: the carry-counting range-coder chain over triples replayed on
// the host, for sm_90a.
//
// Replaces the Pallas prefetched-triple kernel of the JAX package
// (htscodecs_tpu/ops/rc_vmem.py, _build_rc_kernel / _rc_vmem) with its
// event compaction, capacity tiers, stitch sorts, packed byte plane and
// exception planes.  The model walk of an adaptive codec whose contexts
// do not fit on chip (fqzcomp_qual: 65536 models per job) runs on the
// host and emits one (acc, f, tot) triple of uint16_t per coded event;
// this kernel runs RC_Encode + RC_ShiftLow over each job's triples and
// the five finishing shifts (rc_core.cuh).
//
// Bound on this card: memory traffic (6 bytes per event in, the emitted
// bytes out).  In fact each job is one serial chain of 1.5 M events, so
// the kernel takes as long as the slowest chain, and the design keeps
// everything but the chain's own arithmetic off it.  One CTA per job,
// three warps in a pipeline, each stage two buffers deep:
//
//   - warp 1 stages the job's triples in chunks of `chunk` events.  Its
//     lane 0 starts a bulk asynchronous copy (cp.async.bulk, completed
//     on an mbarrier) of each plane's 16-byte-aligned body into shared
//     memory; rows start anywhere (a row is Kp events of 2 bytes), so
//     the copy lands each event at its address modulo 16 and the warp
//     loads the unaligned head and tail of a chunk (at most 7 events per
//     plane) plainly.  Then, for every staged event in parallel, it
//     packs one 16-byte record: the exact reciprocal of the total
//     (rc_udiv64_recip), acc and max(f, 1);
//   - lane 0 of warp 0 runs the range chain, which does not depend on
//     low: per event one 16-byte shared load issued an event ahead, two
//     dependent wide multiplies in place of the 32-bit divide
//     (rc_udiv64), the multiply by f, and the renormalisation as a
//     shift by 0, 8 or 16 bits: no branch on the chain's data.  It
//     queues (acc * r, shifts) per event;
//   - lane 0 of warp 2 runs low, the carry and RC_ShiftLow from the
//     queue.  Its bytes go into a shared-memory ring of `ring` bytes,
//     indexed by the output address modulo `ring`; whenever the ring's
//     window ends the bytes since the last flush are stored with
//     16-byte stores (the unaligned head and tail of a row byte by
//     byte).  A byte handed to the ring is final (RC_ShiftLow writes a
//     deferred run only when it resolves), so no flush rewrites one,
//     and a run longer than the ring flushes inside the run.
//
// Buffers change hands on named barriers.  `chunk` (a multiple of 8)
// and `ring` (a power of two, >= 16) are launch arguments: the tests run
// them small so that every boundary is crossed at short lengths.  Event
// counts are ragged: the chains stop at the job's own count.  Bytes past
// a job's count are unspecified.

#include "rc_core.cuh"

namespace {

constexpr int kThreads = 96;    // warps: 0 the range chain, 1 staging, 2 low
// named barriers (+ s for buffer s), 64 threads each: records staged /
// consumed between warps 1 and 0, queue entries between warps 0 and 2
constexpr int kFull = 1;
constexpr int kEmpty = 3;
constexpr int kQFull = 5;
constexpr int kQEmpty = 7;

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done = 0u;
    while (!done) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    }
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// One chunk of one plane: `len` events from p, at global addresses
// a0 .. a0 + 2 len.  Event k sits at slot skew + k of the staging
// buffer, skew = (a0 & 15) / 2; the body [lo, hi) is the 16-byte-aligned
// part, copied in bulk.
struct Span {
    uintptr_t a0, lo, hi;
    __device__ __forceinline__ Span(const uint16_t* p, int len)
    {
        a0 = (uintptr_t)p;
        lo = (a0 + 15) & ~(uintptr_t)15;
        hi = (a0 + 2 * (uintptr_t)len) & ~(uintptr_t)15;
        if (hi < lo) hi = lo;
    }
    __device__ __forceinline__ bool in_body(int k) const
    {
        const uintptr_t a = a0 + 2 * (uintptr_t)k;
        return a >= lo && a < hi;
    }
};

}  // namespace

__global__ void __launch_bounds__(kThreads)
rc_enc_kernel(const uint16_t* __restrict__ acc,
              const uint16_t* __restrict__ frq,
              const uint16_t* __restrict__ tot,
              const int32_t* __restrict__ lens,
              uint8_t* __restrict__ out,
              int32_t* __restrict__ counts,
              int Kp, int cap, int chunk, int ring)
{
    uint8_t* const smem = reinterpret_cast<uint8_t*>(dsmem);
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int slots = chunk + 8;                 // per plane and buffer
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    // raw[(s * 3 + plane) * slots + skew + k]: the bulk copies' targets
    uint16_t* raw = reinterpret_cast<uint16_t*>(smem + 16);
    // rec[s * chunk + k]: (m_lo, m_hi, acc | max(f, 1) << 16, one)
    uint4* rec = reinterpret_cast<uint4*>(smem + 16 + 12 * slots);
    // queue[s * chunk + k]: (acc * r, shifts) from the range chain
    uint2* queue = reinterpret_cast<uint2*>(smem + 16 + 12 * slots
                                            + 32 * chunk);
    uint8_t* rbuf = smem + 16 + 12 * slots + 48 * chunk;

    const size_t off = (size_t)b * Kp;
    const uint16_t* src[3] = {acc + off, frq + off, tot + off};
    const int n = min(max(lens[b], 0), Kp);
    const int nch = (n + chunk - 1) / chunk;

    if (threadIdx.x == 0) {
        mbar_init(&bar[0], 1);
        mbar_init(&bar[1], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == 1) {
        // ---- staging ----
        auto issue = [&](int c) {
            const int s = c & 1, len = min(chunk, n - c * chunk);
            uint32_t bytes = 0u;
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                const Span sp(src[p] + (size_t)c * chunk, len);
                bytes += (uint32_t)(sp.hi - sp.lo);
            }
            // generic accesses of earlier chunks come before these async ones
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_arrive_expect_tx(&bar[s], bytes);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                const Span sp(src[p] + (size_t)c * chunk, len);
                if (sp.hi > sp.lo)
                    bulk_copy_g2s(raw + (s * 3 + p) * slots
                                      + (sp.lo - (sp.a0 & ~(uintptr_t)15)) / 2,
                                  (const void*)sp.lo, (uint32_t)(sp.hi - sp.lo),
                                  &bar[s]);
            }
        };
        if (lane == 0 && nch > 0) issue(0);
        __syncwarp();
        for (int c = 0; c < nch; ++c) {
            const int s = c & 1, len = min(chunk, n - c * chunk);
            mbar_wait(&bar[s], (uint32_t)(c >> 1) & 1u);
            Span sp[3] = {Span(src[0] + (size_t)c * chunk, len),
                          Span(src[1] + (size_t)c * chunk, len),
                          Span(src[2] + (size_t)c * chunk, len)};
            for (int k = lane; k < len; k += 32) {
                uint32_t v[3];
#pragma unroll
                for (int p = 0; p < 3; ++p)
                    v[p] = sp[p].in_body(k)
                        ? raw[(s * 3 + p) * slots + ((sp[p].a0 & 15) >> 1) + k]
                        : src[p][(size_t)c * chunk + k];
                const uint3 m = rc_udiv64_recip(max(v[2], 1u));
                rec[s * chunk + k] =
                    make_uint4(m.x, m.y, v[0] | max(v[1], 1u) << 16, m.z);
            }
            __syncwarp();
            named_arrive(kFull + s);
            if (c + 1 < nch) {
                if (c >= 1) named_sync(kEmpty + (s ^ 1));
                if (lane == 0) issue(c + 1);
                __syncwarp();
            }
        }
        return;
    }

    if (warp == 0) {
        // ---- the range chain (lane 0): no branch depends on its data ----
        uint32_t range = 0xFFFFFFFFu;
        for (int c = 0; c < nch; ++c) {
            const int s = c & 1, len = min(chunk, n - c * chunk);
            named_sync(kFull + s);
            if (c >= 2) named_sync(kQEmpty + s);
            if (lane == 0) {
                const uint4* R = rec + s * chunk;
                uint2* Q = queue + s * chunk;
                // record k + 1 is loaded a step ahead of the chain (record
                // len lies within shared memory and is not used)
                uint4 e = R[0];
#pragma unroll 4
                for (int k = 0; k < len; ++k) {
                    const uint4 e1 = R[k + 1];
                    Q[k] = rc_range_step(range, rc_udiv64(range, e.x, e.y, e.w),
                                         e.z & 0xFFFFu, e.z >> 16);
                    e = e1;
                }
            }
            __syncwarp();
            if (c + 2 < nch) named_arrive(kEmpty + s);
            named_arrive(kQFull + s);
        }
        return;
    }

    // ---- low, the carry and the bytes (warp 2, lane 0) ----
    RcEnc rc;
    rc_enc_init(rc);
    uint8_t* row = out + (size_t)b * cap;
    Ring o(rbuf, row, ring);
    for (int c = 0; c < nch; ++c) {
        const int s = c & 1, len = min(chunk, n - c * chunk);
        named_sync(kQFull + s);
        if (lane == 0) {
            const uint2* Q = queue + s * chunk;
            uint2 e = Q[0];
#pragma unroll 2
            for (int k = 0; k < len; ++k) {
                const uint2 e1 = Q[k + 1];
                rc_low_step(rc, o, e);
                e = e1;
            }
        }
        __syncwarp();
        if (c + 2 < nch) named_arrive(kQEmpty + s);
    }
    if (lane == 0) {
        rc_finish(rc, o);
        o.flush();
        counts[b] = o.n;
    }
}

// Shared memory of one CTA.
static size_t rc_enc_smem(int chunk, int ring)
{
    return 16 + 12 * (size_t)(chunk + 8) + 48 * (size_t)chunk + (size_t)ring;
}

// acc, frq, tot (B,Kp) u16, lens (B,) i32 events per job, out (B,cap)
// u8 with cap >= 2*Kp + 8, counts (B,) i32; chunk a multiple of 8, ring
// a power of two >= 16.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for bad arguments).
extern "C" int rc_enc_launch(const void* acc, const void* frq,
                             const void* tot, const void* lens, void* out,
                             void* counts, int B, int Kp, int cap, int chunk,
                             int ring, void* cuda_stream)
{
    if (B <= 0) return 0;
    if (Kp < 0 || cap < 2 * Kp + 8 || chunk < 8 || chunk % 8
        || ring < 16 || (ring & (ring - 1)))
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)acc | (uintptr_t)frq | (uintptr_t)tot) & 1)
        return (int)cudaErrorMisalignedAddress;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const size_t smem = rc_enc_smem(chunk, ring);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(rc_enc_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    rc_enc_kernel<<<B, kThreads, smem, (cudaStream_t)cuda_stream>>>(
        (const uint16_t*)acc, (const uint16_t*)frq, (const uint16_t*)tot,
        (const int32_t*)lens, (uint8_t*)out, (int32_t*)counts, Kp, cap,
        chunk, ring);
    return (int)cudaGetLastError();
}
