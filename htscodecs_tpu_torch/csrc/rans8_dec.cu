// rans8_dec: batched rANS 4x8 (CRAM 3.0) decode, order 0 and order 1,
// for sm_90a.
//
// Replaces the Pallas 4x8 decode kernel of the JAX package
// (htscodecs_tpu/ops/rans8_vmem.py, _build_dec_kernel / _dec_vmem8),
// which keeps 128 blocks' tables and a 512-byte window of each stream
// in on-chip memory, resolves every lookup with select chains, and
// leaves the order-0 tail to tensor code after the kernel.  Here, as in
// rans16_dec:
//
//   - one 4-thread group per rANS block, thread l = rANS state l;
//   - slot -> symbol is a binary search for the last base <= slot over
//     the context's monotone int16 row, freq = row[s+1] - row[s]; the
//     row's last column is the row's own total (4x8 rows normalise to
//     4095 slots);
//   - a state consumes 0, 1 or 2 bytes per step (rANS_byte.h
//     RansDecRenorm).  Whether the second is needed does not depend on
//     the first byte's value ((X << 8 | b) < L  <=>  X < L >> 8), so
//     every offset is known before any byte is read: claims go in state
//     order 0..3, a state's two bytes adjacent, ranked by two ballots
//     and popcounts of the lower states' bits;
//   - decoded bytes go straight to the (B, N) output; at order 0 the
//     last N & 3 symbols are read from the final states without
//     advancing them (rANS_static.c), inside the kernel.
//
// Bound on this card: memory traffic (stream bytes + tables + states
// in, B*N bytes out).  In fact each group runs a serial chain per step
// (lookup, state update, ballots, stream bytes), and the design keeps
// global memory off it:
//
//   - the CTA's blocks' base rows and alphabets are copied into shared
//     memory when they fit (`smem_tables`; the wrapper's rule), with a
//     slot index per row built there by the kernel: entry j holds the
//     number of bases <= 64 j, so the bisection starts between entries
//     m / 64 and m / 64 + 1 and mostly has nothing left to do (one
//     shared load, then the base and the next one).  Wider tables (an
//     order-1 alphabet of up to 256 symbols is 131 KB per block) stay in
//     global memory, read through the read-only path, and are bisected
//     whole;
//   - each block's stream is staged ahead of the chain in a shared ring
//     of SB bytes: every 8th step, lane 0 of the group asks for the
//     16-byte segments of the next SB - 16 bytes with cp.async and waits
//     for those asked for two rounds before (a step reads at most 8
//     bytes, so a segment is asked for at least 19 steps before it is
//     read).  At the start of a step the group's lanes load the 12
//     aligned bytes around the next 8 stream bytes, so the bytes are
//     there when the ballots have ranked the claims;
//   - a decoded byte is stored one step late, so that the load of its
//     alphabet entry is not waited for on the chain.  Gathering a
//     lane's order-1 bytes into 16-byte stores cost the chain more than
//     it saved, and 4-byte stores saved nothing beyond the noise
//     (PERF.md);
//   - the CTA is `threads` threads (32, 64 or 128: 8 to 32 blocks), so
//     that small CTAs spread a batch over all SMs.
//
// Arithmetic is rANS_byte.h's (L = 1 << 23, 12-bit slots) in uint32_t.
// Reads of the stream are bounded by each block's own byte count: a
// truncated stream decodes zeros past its end.  A slot with no base
// <= it decodes symbol 0 with base 0, and a slot at or above a row's
// total lands on the row's last entry; the plain version does the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#define RANS8_L (1u << 23)
#define SHIFT 12
#define MASK ((1u << SHIFT) - 1u)
#define MAX_THREADS 128
#define SB 256              // staged stream bytes per block (a ring)
#define SEGS (SB / 16)
#define STAGE_EVERY 8       // steps between two rounds of copies
#define IDX_N 65            // slot index entries per row: slots 0, 64, .., 4096

extern __shared__ __align__(16) uint8_t s8mem[];

namespace {

// v, hidden from the compiler, so that it keeps v in a register: left to
// itself it rereads the thread and CTA indices (special-register reads,
// tens of cycles) inside the step loop
__device__ __forceinline__ int opaque(int v)
{
    asm volatile("" : "+r"(v));
    return v;
}

// A block's base rows in shared memory (by int16 index) or in global
// memory.
struct STab {
    int at;
    __device__ __forceinline__ int operator[](int j) const
    {
        return reinterpret_cast<const int16_t*>(s8mem)[at + j];
    }
};

struct GTab {
    const int16_t* at;
    __device__ __forceinline__ int operator[](int j) const { return __ldg(at + j); }
};

// The number of entries k < A of the monotone row with row[k] <= m,
// bisecting [lo, hi): the entries below lo are known to be <= m and
// those from hi on > m.
template <class Row>
__device__ __forceinline__ int count_le(Row row, int lo, int hi, int m)
{
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] <= m) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// The symbol of a slot from count_le's c: the last entry with a base <=
// the slot (0 with base 0 if there is none), its base and frequency.
template <class Row>
__device__ __forceinline__ int slot_symbol(Row row, int c, int& bs, int& f)
{
    const int sym = c > 0 ? c - 1 : 0;
    bs = c > 0 ? row[sym] : 0;
    f = row[sym + 1] - bs;
    return sym;
}

}  // namespace

// Shared memory of one CTA of `bpc` blocks: the stream rings, then (with
// tables in shared memory) the base rows of rows_per int16 each, the
// alphabets and the slot index (IDX_N bytes per row), each part rounded
// up to 16 bytes.  ops/rans8_vmem.py (_dec_smem) holds the same rule.
__host__ __device__ inline int rans8_dec_part(int bytes)
{
    return (bytes + 15) & ~15;
}

static size_t rans8_dec_smem(int bpc, int nrows, int A, bool tables)
{
    size_t s = (size_t)bpc * SB;
    if (tables)
        s += rans8_dec_part(bpc * nrows * (A + 1) * 2)
             + rans8_dec_part(bpc * A) + rans8_dec_part(bpc * nrows * IDX_N);
    return s;
}

template <int ORDER, bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
rans8_dec_kernel(const uint32_t* __restrict__ states,
                 const uint8_t* __restrict__ stream,
                 const int32_t* __restrict__ counts,
                 const int16_t* __restrict__ bases,
                 const uint8_t* __restrict__ alpha,
                 uint8_t* __restrict__ out,
                 int B, int W, int A, int N, int q, int K)
{
    const int bpc = opaque(blockDim.x >> 2);
    const int tid = opaque(threadIdx.x);
    const int g = tid >> 2;
    const int lane = tid & 3;
    const int b0 = opaque(blockIdx.x * bpc);
    const int b = b0 + g;
    const bool live = b < B;
    // threads past the ragged edge shadow the last block (valid
    // memory, same control flow for the warp ballot) and never write
    const int gl = live ? g : B - 1 - b0;
    const size_t bb = b0 + gl;
    const int A1 = A + 1;
    const int nrows = ORDER ? A : 1;
    const int rows_per = nrows * A1;

    // the CTA's tables, one contiguous range of each array, and their
    // slot index
    const int tab_at = bpc * SB / 2;                            // int16 index
    const int al_at = bpc * SB + rans8_dec_part(bpc * rows_per * 2);
    const int idx_at = al_at + rans8_dec_part(bpc * A);
    if (SMEM) {
        const int nblk = min(bpc, B - b0);
        int16_t* st = reinterpret_cast<int16_t*>(s8mem) + tab_at;
        const int16_t* gt = bases + (size_t)b0 * rows_per;
        for (int j = threadIdx.x; j < nblk * rows_per; j += blockDim.x)
            st[j] = gt[j];
        const uint8_t* ga = alpha + (size_t)b0 * A;
        for (int j = threadIdx.x; j < nblk * A; j += blockDim.x)
            s8mem[al_at + j] = ga[j];
        __syncthreads();
        for (int j = threadIdx.x; j < nblk * nrows * IDX_N; j += blockDim.x) {
            const int r = j / IDX_N;
            s8mem[idx_at + j] = (uint8_t)count_le(STab{tab_at + r * A1}, 0, A,
                                                  (j - r * IDX_N) << 6);
        }
    }
    const int16_t* tb = bases + bb * rows_per;
    const uint8_t* al = alpha + bb * (size_t)A;
    const int tab = tab_at + gl * rows_per;
    const int idx = idx_at + gl * nrows * IDX_N;

    const uint8_t* by = stream + bb * (size_t)W;
    Stage<SB> sg;
    sg.buf = s8mem + g * SB;
    sg.base = reinterpret_cast<const uint8_t*>((uintptr_t)by & ~(uintptr_t)15);
    sg.skew = (int)((uintptr_t)by & 15u);
    sg.nb = min(counts[bb], W);
    sg.nseg = sg.nb > 0 ? (sg.skew + sg.nb + 15) >> 4 : 0;
    sg.next = 0;
    if (lane == 0) {
        sg.fill(SEGS);
        cp_async_commit();
        cp_async_wait<0>();
    }
    __syncthreads();

    uint32_t X = states[bb * 4 + lane];
    uint8_t* o = out + bb * (size_t)N;
    const unsigned gsh = (unsigned)tid & 28u;       // group's first bit
    const unsigned lower = (1u << lane) - 1u;

    int p = 0;
    int ctx = 0;
    int oi = -1;            // the previous step's output byte and index
    uint32_t oc = 0u;
    for (int s = 0; s < K; ++s) {
        if (s % STAGE_EVERY == 0) {
            if (lane == 0) {
                sg.fill(((sg.skew + p) >> 4) + SEGS - 1);
                cp_async_commit();
                cp_async_wait<2>();
            }
            __syncwarp();
        }
        uint32_t w[3];
        int w0;
        sg.window(p, w, w0);
        const bool act = ORDER ? (s < q || lane == 3) : true;
        const int m = (int)(X & MASK);
        const int r = ORDER ? ctx * A1 : 0;
        int bs, f, sym;
        if (SMEM) {
            const int ix = idx + (ORDER ? ctx * IDX_N : 0) + (m >> 6);
            const STab row{tab + r};
            sym = slot_symbol(row, count_le(row, s8mem[ix], s8mem[ix + 1], m),
                              bs, f);
        } else {
            const GTab row{tb + r};
            sym = slot_symbol(row, count_le(row, 0, A, m), bs, f);
        }
        uint32_t Xn = (uint32_t)f * (X >> SHIFT) + (uint32_t)m - (uint32_t)bs;
        const bool need1 = act && Xn < RANS8_L;
        const bool need2 = need1 && Xn < (RANS8_L >> 8);
        const unsigned g1 = (__ballot_sync(0xffffffffu, need1) >> gsh) & 0xFu;
        const unsigned g2 = (__ballot_sync(0xffffffffu, need2) >> gsh) & 0xFu;
        if (need1) {
            const int pos = p + __popc(g1 & lower) + __popc(g2 & lower);
            Xn = (Xn << 8) | sg.at(pos, w, w0);
            if (need2) Xn = (Xn << 8) | sg.at(pos + 1, w, w0);
        }
        p += __popc(g1) + __popc(g2);
        if (oi >= 0) o[oi] = (uint8_t)oc;
        oi = -1;
        if (act) {
            X = Xn;
            ctx = sym;
            if (live) {
                oc = SMEM ? s8mem[al_at + gl * A + sym] : __ldg(al + sym);
                oi = ORDER ? (s < q ? lane * q + s : 4 * q + (s - q))
                           : 4 * s + lane;
            }
        }
    }
    if (oi >= 0) o[oi] = (uint8_t)oc;
    cp_async_wait<0>();
    // order 0: the last N & 3 symbols come from the final states, which
    // do not advance
    if (!ORDER && lane < (N & 3)) {
        const int m = (int)(X & MASK);
        int bs, f, sym;
        if (SMEM) {
            const STab row{tab};
            sym = slot_symbol(row, count_le(row, s8mem[idx + (m >> 6)],
                                            s8mem[idx + (m >> 6) + 1], m),
                              bs, f);
        } else {
            const GTab row{tb};
            sym = slot_symbol(row, count_le(row, 0, A, m), bs, f);
        }
        if (live) o[4 * K + lane] = SMEM ? s8mem[al_at + gl * A + sym] : __ldg(al + sym);
    }
}

// states (B,4) u32, stream (B,W) u8 (16-byte aligned), counts (B,) i32
// bytes per block, bases (B, order ? A : 1, A+1) i16 with per-row
// totals in the last column, alpha (B,A) u8, out (B,N) u8; order 0
// needs N >= 4.  `threads` per CTA: 32, 64 or 128; `smem_tables`: copy
// the tables into shared memory.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for bad arguments).
extern "C" int rans8_dec_launch(const void* states, const void* stream,
                                const void* counts, const void* bases,
                                const void* alpha, void* out,
                                int B, int W, int A, int N, int order,
                                int threads, int smem_tables,
                                void* cuda_stream)
{
    if (B <= 0 || N <= 0) return 0;
    if (A < 1 || W < 1 || (!order && N < 4) || (smem_tables && A > 255)
        || (threads != 32 && threads != 64 && threads != 128))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)stream & 15) return (int)cudaErrorMisalignedAddress;
    const int q = N >> 2;
    const int K = order ? q + (N - 4 * q) : q;
    const int bpc = threads / 4;
    const size_t smem = rans8_dec_smem(bpc, order ? A : 1, A, smem_tables != 0);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((size_t)B + bpc - 1) / bpc);
    cudaStream_t st = (cudaStream_t)cuda_stream;
    auto kernel = order ? (smem_tables ? rans8_dec_kernel<1, true>
                                       : rans8_dec_kernel<1, false>)
                        : (smem_tables ? rans8_dec_kernel<0, true>
                                       : rans8_dec_kernel<0, false>);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, threads, smem, st>>>(
        (const uint32_t*)states, (const uint8_t*)stream,
        (const int32_t*)counts, (const int16_t*)bases,
        (const uint8_t*)alpha, (uint8_t*)out, B, W, A, N, q, K);
    return (int)cudaGetLastError();
}
