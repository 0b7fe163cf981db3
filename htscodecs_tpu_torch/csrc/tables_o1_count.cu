// tables_o1_count: the counting stage of the order-1 device table build
// (ops/tables_v2.py, build_o1_device_async) for sm_90a.  Two kernels over
// a (B, N) uint8 batch: each block's byte presence, then its bigram
// histogram H[ctx][sym] over its dense alphabet, exact integer counts.
//
// Replaces no Pallas kernel.  The JAX package counts the bigrams in XLA
// (htscodecs_tpu/ops/tables_v2.py); the port first counted them with
// torch.bincount over an int32 flat index b*A*A + ctx*A + sym built per
// tile of blocks (tables_v2._tables_o1_count_plain, kept as the plain
// version): four int32 passes over every byte, then global atomics that
// pile onto a few addresses, because quality data is a few symbols in
// runs.  Here each kernel reads the raw bytes once, 16 bytes a load, and
// counts in shared memory.
//
// Bound: bytes, B*N read once by each kernel; the operations per byte (a
// table lookup, the bin, one shared increment) lie far below the integer
// rate.  The design:
//   - a grid of (block, chunk) CTAs.  A chunk is a run of the block of
//     SEGS 16-byte segments per thread, warp-interleaved so that a warp
//     reads 512 contiguous bytes a load; the warps of a CTA grow with N
//     (1 to 8), so that short blocks start no idle warps.  The bytes
//     before the first 16-byte boundary of a chunk and after its last
//     are taken one per thread by the first warp;
//   - tables_o1_presence sets flags in a 256-entry shared array and ORs
//     them into the (B, 256) presence in global memory, byte 0 forced
//     (tables_v2._presence, rANS_static4x16pr.c:731);
//   - tables_o1_count maps bytes to dense indices through a 256-entry
//     shared table built from alpha (the number of alphabet entries
//     below the byte, rans_v2._densify's rule).  Each thread's 16 bytes
//     take their first context from the byte before them, context 0 at
//     position 0, as the flat index's idx[:, 1:] += dense[:, :-1] * A
//     does.  The counts go to private sub-histograms in shared memory:
//     per lane (bin * 32 + lane: plain loads and stores, each lane on its
//     own bank) where A <= LANE_A, the quality-series case, A*A*128
//     bytes a warp; per warp with shared atomics above that, A*A*4 bytes
//     a copy, as many copies as COPY_BYTES holds and at least one (36 KB
//     at A = 96);
//   - the quarter-start fixups (rANS_static4x16pr.c:736-739: one more
//     count in context 0 for the symbols at q, 2q and 3q, q = N / 4) are
//     added by the CTA whose chunk holds each;
//   - each CTA merges its copies and adds its A*A sums to H (B, A, A)
//     int32 with one global atomic per nonzero bin.  Counts are integers,
//     so H equals the plain version's whatever order the atomics land in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SEGS = 16;                 // 16-byte segments a thread, a chunk
constexpr int MAX_WARPS = 8;
constexpr int LANE_A = 8;                // per-lane sub-histograms up to here
constexpr int MAX_A = 96;                // tables_v2.MAX_DENSE_A
constexpr int COPY_BYTES = 64 * 1024;    // shared memory of per-warp copies

struct Chunk {
    const uint8_t* lo;      // the chunk's first byte
    const uint8_t* a0;      // its first 16-byte boundary (at most hi)
    const uint8_t* a1;      // its last 16-byte boundary (at least a0)
    const uint8_t* hi;      // one past its last byte
};

__device__ __forceinline__ Chunk chunk_of(const uint8_t* row, int N,
                                          int chunk)
{
    const long long c0 = (long long)blockIdx.y * chunk;
    const long long c1 = c0 + chunk < N ? c0 + chunk : (long long)N;
    Chunk c;
    c.lo = row + c0;
    c.hi = row + c1;
    uintptr_t a0 = ((uintptr_t)c.lo + 15) & ~(uintptr_t)15;
    uintptr_t a1 = (uintptr_t)c.hi & ~(uintptr_t)15;
    if (a0 > (uintptr_t)c.hi) a0 = (uintptr_t)c.hi;
    if (a1 < a0) a1 = a0;
    c.a0 = (const uint8_t*)a0;
    c.a1 = (const uint8_t*)a1;
    return c;
}

// This thread's byte of the chunk's unaligned edges, or nullptr: threads
// 0-15 take the head [lo, a0), threads 16-31 the tail [a1, hi), each at
// most 15 bytes.
__device__ __forceinline__ const uint8_t* edge_byte(const Chunk& c)
{
    const int t = threadIdx.x;
    const uint8_t* p = t < 16 ? c.lo + t : c.a1 + (t - 16);
    const uint8_t* end = t < 16 ? c.a0 : c.hi;
    return t < 32 && p < end ? p : nullptr;
}

__device__ __forceinline__ int byte_of(const uint4& v, int k)
{
    const unsigned w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
    return (w >> (8 * (k & 3))) & 0xFF;
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
tables_o1_presence_kernel(const uint8_t* __restrict__ blocks,
                          uint8_t* __restrict__ pres, int N, int chunk)
{
    __shared__ unsigned flag[256];
    const int tid = threadIdx.x, nthr = blockDim.x;
    for (int v = tid; v < 256; v += nthr) flag[v] = v == 0;
    __syncthreads();
    const uint8_t* row = blocks + (size_t)blockIdx.x * N;
    const Chunk c = chunk_of(row, N, chunk);
    if (const uint8_t* p = edge_byte(c)) flag[*p] = 1;
    const int nseg = (int)((c.a1 - c.a0) >> 4);
    const uint4* seg = reinterpret_cast<const uint4*>(c.a0);
    for (int s = tid; s < nseg; s += nthr) {
        const uint4 v = seg[s];
#pragma unroll
        for (int k = 0; k < 16; ++k) flag[byte_of(v, k)] = 1;
    }
    __syncthreads();
    uint8_t* out = pres + (size_t)blockIdx.x * 256;
    for (int v = tid; v < 256; v += nthr)
        if (flag[v]) out[v] = 1;
}

template <bool PER_LANE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
tables_o1_count_kernel(const uint8_t* __restrict__ blocks,
                       const uint8_t* __restrict__ alpha,
                       unsigned* __restrict__ H, int N, int A, int chunk,
                       int ncopy)
{
    extern __shared__ unsigned hist[];
    __shared__ uint8_t lut[256];
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int AA = A * A;
    const int cells = PER_LANE ? AA * 32 : AA;      // words of one copy
    const int copies = PER_LANE ? nthr >> 5 : ncopy;
    for (int i = tid; i < copies * cells; i += nthr) hist[i] = 0;
    const uint8_t* al = alpha + (size_t)blockIdx.x * A;
    for (int v = tid; v < 256; v += nthr) {
        int n = 0;
        for (int k = 0; k < A; ++k) n += al[k] < v;
        lut[v] = (uint8_t)n;
    }
    __syncthreads();

    unsigned* h = PER_LANE ? hist + warp * cells + lane
                           : hist + (warp % ncopy) * cells;
    auto count = [&](int bin) {
        if constexpr (PER_LANE) h[bin * 32] += 1;
        else atomicAdd(&h[bin], 1u);
    };
    const uint8_t* row = blocks + (size_t)blockIdx.x * N;
    const Chunk c = chunk_of(row, N, chunk);
    if (const uint8_t* p = edge_byte(c))
        count((p > row ? lut[p[-1]] : 0) * A + lut[*p]);
    const int nseg = (int)((c.a1 - c.a0) >> 4);
    const uint4* seg = reinterpret_cast<const uint4*>(c.a0);
    for (int s = tid; s < nseg; s += nthr) {
        const uint8_t* p = c.a0 + 16 * (size_t)s;
        const uint4 v = seg[s];
        int prev = p > row ? lut[p[-1]] : 0;
        int d[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) d[k] = lut[byte_of(v, k)];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            count(prev * A + d[k]);
            prev = d[k];
        }
    }
    __syncthreads();
    if (tid == 0) {
        // the quarter starts, in context 0 of the first copy (lane 0)
        const size_t q = (size_t)(N >> 2);
        for (int k = 1; k <= 3; ++k) {
            const uint8_t* p = row + k * q;
            if (p >= c.lo && p < c.hi) hist[lut[*p] * (PER_LANE ? 32 : 1)] += 1;
        }
    }
    __syncthreads();

    unsigned* out = H + (size_t)blockIdx.x * AA;
    // a warp's 32 cells of one pass share one bin in the per-lane layout
    // (cells is a multiple of 32, so the loop's bound is warp-uniform)
    for (int i = tid; i < cells; i += nthr) {
        unsigned v = 0;
        for (int k = 0; k < copies; ++k) v += hist[k * cells + i];
        if constexpr (PER_LANE) {
            v = __reduce_add_sync(0xFFFFFFFFu, v);
            if (lane == 0 && v) atomicAdd(&out[i >> 5], v);
        } else {
            if (v) atomicAdd(&out[i], v);
        }
    }
}

// Warps per CTA and bytes per chunk for blocks of N bytes.
void geometry(int N, int* warps, int* chunk)
{
    const int per_warp = 32 * 16 * SEGS;
    int w = (N + per_warp - 1) / per_warp;
    *warps = w < 1 ? 1 : w > MAX_WARPS ? MAX_WARPS : w;
    *chunk = *warps * per_warp;
}

}  // namespace

extern "C" int tables_o1_presence_launch(const void* blocks, void* pres,
                                         int B, int N, void* stream)
{
    if (B <= 0) return 0;
    if (N < 0) return (int)cudaErrorInvalidValue;
    int warps, chunk;
    geometry(N, &warps, &chunk);
    const unsigned nchunk = N ? (unsigned)((N + chunk - 1) / chunk) : 1u;
    tables_o1_presence_kernel<<<dim3((unsigned)B, nchunk), warps * 32, 0,
                                (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (uint8_t*)pres, N, chunk);
    return (int)cudaGetLastError();
}

// H must hold zeros: the CTAs add to it.
extern "C" int tables_o1_count_launch(const void* blocks, const void* alpha,
                                      void* H, int B, int N, int A,
                                      void* stream)
{
    if (B <= 0) return 0;
    if (N < 1 || A < 1 || A > MAX_A) return (int)cudaErrorInvalidValue;
    int warps, chunk;
    geometry(N, &warps, &chunk);
    const unsigned nchunk = (unsigned)((N + chunk - 1) / chunk);
    const int AA = A * A;
    const bool per_lane = A <= LANE_A;
    int ncopy = COPY_BYTES / (AA * 4);
    ncopy = ncopy < 1 ? 1 : ncopy > warps ? warps : ncopy;
    const size_t smem = per_lane ? (size_t)warps * AA * 32 * 4
                                 : (size_t)ncopy * AA * 4;
    auto kernel = per_lane ? tables_o1_count_kernel<true>
                           : tables_o1_count_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)B, nchunk), warps * 32, smem,
             (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const uint8_t*)alpha, (unsigned*)H, N, A,
        chunk, ncopy);
    return (int)cudaGetLastError();
}
