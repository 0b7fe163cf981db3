// sf_fetch: out[b, k] = tbl[b, idx[b, k]] on int32, for sm_90a.
//
// Replaces the Pallas lane-gather fetch kernel of the JAX package
// (htscodecs_tpu/ops/rans_vmem.py, _build_fetch_kernel / _sf_fetch),
// which serves the encoder's per-symbol (start | freq << 12) queries
// with 128-lane gathers and a select chain over table chunks.  On this
// card the same function is one indexed load per query: a grid-stride
// loop, neighbouring threads on neighbouring queries, so the index
// read and the result write are coalesced and the table rows (at most
// 96*96 entries per block) are served from L1/L2.
//
// Bound on this card: memory traffic, 4 bytes in and 4 bytes out per
// query plus the tables once.  Indices are clamped into the row, so a
// byte outside the block's alphabet cannot read out of the table.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
sf_fetch_kernel(const int32_t* __restrict__ tbl,
                const int32_t* __restrict__ idx,
                int32_t* __restrict__ out,
                int T, long long KQ, long long total)
{
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
         i < total; i += stride) {
        const long long b = i / KQ;
        int k = idx[i];
        k = k < 0 ? 0 : (k >= T ? T - 1 : k);
        out[i] = tbl[b * T + k];
    }
}

// tbl (B,T) i32, idx (B,KQ) i32, out (B,KQ) i32.
// Returns cudaGetLastError().
extern "C" int sf_fetch_launch(const void* tbl, const void* idx, void* out,
                               int B, int T, long long KQ, void* stream)
{
    const long long total = (long long)B * KQ;
    if (total <= 0 || T <= 0) return 0;
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    sf_fetch_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tbl, (const int32_t*)idx, (int32_t*)out,
        T, KQ, total);
    return (int)cudaGetLastError();
}
