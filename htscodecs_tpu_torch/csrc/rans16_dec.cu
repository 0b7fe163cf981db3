// rans16_dec: batched rANS 4x16 decode, order 0 and order 1, for sm_90a:
// one kernel body, templated on its table reader, with two entry points.
//
// Replaces two Pallas decode kernels of the JAX package, which share one
// contract (B blocks of N bytes from their states, word streams and
// dense tables):
//
//   rans16_dec_launch         htscodecs_tpu/ops/rans_vmem.py,
//                             _build_kernel / _dec_vmem: reads monotone
//                             base rows ((B, Ac, A+1) int16,
//                             rans_v2._b16_fill) and per-block word
//                             counts;
//   rans16_dec_packed_launch  htscodecs_tpu/ops/rans_pallas.py,
//                             _dec_kernel_body / _dec_tile (with the
//                             prologue and byte reassembly of
//                             _dec_pallas_to_bytes): reads the packed
//                             rows ((B, Ac*A) int32, base << 13 | freq)
//                             as the table builders make them.
//
// Both TPU kernels keep 128 blocks' tables and word windows in on-chip
// memory and resolve a slot with select chains or masked reductions,
// since that hardware has no gather.  Here:
//
//   - one 4-thread group per rANS block, thread l = rANS state l; the
//     CTA is `threads` threads (32, 64 or 128: 8 to 32 blocks), so that
//     small CTAs spread a batch over all SMs.  Words are claimed in
//     state order 0..3 by one warp ballot plus a popcount of the lower
//     states' bits;
//   - the two readers fill ONE form: monotone int16 base rows (A+1
//     entries, freq = row[s+1] - row[s]).  The base-row reader copies
//     them.  The packed reader converts each row as _b16_fill does: a
//     hole (freq 0) takes the next valid entry's base, trailing holes
//     and the successor column 1 << shift.  A slot then resolves to the
//     last of the first A entries <= it; on every table the builders
//     make (cumulative bases, rows summing to 1 << shift) that is the
//     packed route's "last entry with freq > 0 and base <= slot", with
//     the entry's own freq.  The readers differ where no entry is <=
//     the slot (a context row with no valid entry): the packed route
//     gives symbol 0, base 0 and freq 0, as the TPU kernel's masked max
//     of nothing does; the base-row route gives freq = row[1] (1 <<
//     shift), as rans_vmem._slot_lookup does;
//   - the CTA's rows, alphabets and a slot index per row sit in shared
//     memory when they fit (`smem_tables`, the wrapper's rule): index
//     entry j holds the number of bases <= j << ss, ss = max(shift - 6,
//     0) (64 slots a step at shift 12, 16 at shift 10: 65 entries
//     either way), so the count lies between entries m >> ss and
//     (m >> ss) + 1; most cells hold at most one base, and then the
//     three row entries around the first are read at once.  Wider tables
//     stay in global memory (the packed reader writes its converted
//     rows to a scratch buffer there first) and are bisected whole;
//   - each block's words are staged ahead of the chain by cp.async in a
//     shared ring of SB bytes (cp_async.cuh, Stage: every 8th step,
//     lane 0 asks for the next SB - 16 bytes and waits for those asked
//     for two rounds before; a step consumes at most 4 words, 8 bytes).
//     At the start of a step the lanes load the 12 aligned bytes around
//     the next 8, so the words are there when the ballot has ranked the
//     claims;
//   - a decoded byte is stored one step late, under a predicate, so that
//     the load of its alphabet entry is not waited for on the chain, and
//     the step branches only where a slot index cell holds more than one
//     base;
//   - the thread and CTA indices are held in registers (`opaque`): left
//     to itself the compiler rereads them inside the step loop.
//
// Bound on this card: operations (per symbol the step and a bisection
// of the context's row, ahead of the words, tables and B*N bytes of
// traffic); in fact the serial chain of one state per thread (lookup,
// step, ballot, word) sets the time, and the design keeps global memory
// and branches off it.
//
// State-transition arithmetic is rANS_word.h's (L = 1 << 15, 16-bit
// renormalisation) in uint32_t.  Reads of the word stream are bounded by
// each block's own word count (the packed entry: the row width W): a
// truncated stream decodes zeros past its end.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#define RANS_L (1u << 15)
#define PACK_SHIFT 13
#define PACK_MASK ((1 << PACK_SHIFT) - 1)
#define MAX_THREADS 128
#define SB 256              // staged word-stream bytes per block (a ring)
// a block's ring space: padded by 16 bytes, so that the eight groups of a
// warp, which load their windows at the same ring offsets, hit different
// banks of shared memory (unpadded, all eight load from one bank)
#define RING_STRIDE (SB + 16)
#define SEGS (SB / 16)
#define STAGE_EVERY 8       // steps between two rounds of copies
#define IDX_N 65            // slot index entries per row

extern __shared__ __align__(16) uint8_t s16d[];

namespace {

__device__ __forceinline__ int opaque(int v)
{
    asm volatile("" : "+r"(v));
    return v;
}

// Loads from shared memory by 32-bit shared address: the compiler
// otherwise rebuilt the shared window's base from the CTA's cluster
// index every step
__device__ __forceinline__ int lds_s16(uint32_t a)
{
    int v;
    asm volatile("ld.shared.s16 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ int lds_u8(uint32_t a)
{
    int v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

// A block's base rows in shared memory (by shared address) or in global
// memory (the caller's rows, or the packed reader's converted rows).
struct STab {
    uint32_t at;
    __device__ __forceinline__ int operator[](int j) const
    {
        return lds_s16(at + 2 * j);
    }
};

struct GTab {
    const int16_t* at;
    __device__ __forceinline__ int operator[](int j) const { return at[j]; }
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

// The symbol of a slot from count_le's c: the last entry <= the slot,
// its base and frequency.  No such entry (c = 0): symbol 0, base 0 and
// freq 0 on the packed route, row[1] on the base-row route.
template <bool PACKED, class Row>
__device__ __forceinline__ int slot_symbol(Row row, int c, int& bs, int& f)
{
    const int sym = c > 0 ? c - 1 : 0;
    bs = c > 0 ? row[sym] : 0;
    f = (PACKED && c == 0) ? 0 : row[sym + 1] - bs;
    return sym;
}

// slot_symbol through the slot index: the count lies in [lo, hi], the
// index entries of the slot's cell.  Most cells hold at most one base,
// so the count is lo or lo + 1, and the three entries around lo are
// loaded at once; a wider cell is bisected.
template <bool PACKED>
__device__ __forceinline__ int slot_symbol_indexed(STab row, int lo, int hi,
                                                   int m, int& bs, int& f)
{
    int c, below, at;       // the count, row[c - 1] and row[c]
    const int one = PACKED ? 0 : row[1];    // freq where no entry is <= m
    if (hi - lo <= 1) {
        const int r0 = row[lo - 1], r1 = row[lo], r2 = row[lo + 1];
        const bool up = lo < hi && r1 <= m;
        // by mask, not by select: the compiler turned the select into a
        // load of r2 that waited on the compare
        const int mk = -(int)up;
        c = lo + up;
        below = r0 + ((r1 - r0) & mk);
        at = r1 + ((r2 - r1) & mk);
    } else {
        c = count_le(row, lo, hi, m);
        below = row[c - 1];
        at = row[c];
    }
    bs = c > 0 ? below : 0;             // see slot_symbol
    f = c > 0 ? at - below : one;
    return max(c - 1, 0);
}

}  // namespace

__host__ __device__ inline int rans16_dec_part(int bytes)
{
    return (bytes + 15) & ~15;
}

// Shared memory of one CTA of `bpc` blocks: the word rings (RING_STRIDE
// each), then (with
// tables in shared memory) the base rows of rows_per int16 each, the
// alphabets and the slot index (IDX_N bytes per row), each part rounded
// up to 16 bytes.  ops/rans_vmem.py (_dec_smem) holds the same rule.
static size_t rans16_dec_smem(int bpc, int nrows, int A, bool tables)
{
    size_t s = (size_t)bpc * RING_STRIDE;
    if (tables)
        s += rans16_dec_part(bpc * nrows * (A + 1) * 2)
             + rans16_dec_part(bpc * A) + rans16_dec_part(bpc * nrows * IDX_N);
    return s;
}

// tab: int16 base rows (B, nrows, A+1), or, PACKED, int32 packed rows
// (B, nrows * A); conv: PACKED and not SMEM, the (B, nrows, A+1) int16
// scratch the converted rows go to.  counts null: every block owns its
// whole row of W words.
template <int ORDER, bool SMEM, bool PACKED>
__global__ void __launch_bounds__(MAX_THREADS)
rans16_dec_kernel(const uint32_t* __restrict__ states,
                  const uint16_t* __restrict__ words,
                  const int32_t* __restrict__ counts,
                  const void* __restrict__ tab,
                  const uint8_t* __restrict__ alpha,
                  const int32_t* __restrict__ shift,
                  int16_t* conv,
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
    const int nblk = min(bpc, B - b0);
    const int A1 = A + 1;
    const int nrows = ORDER ? A : 1;
    const int rows_per = nrows * A1;

    const uint32_t sb = (uint32_t)opaque((int)__cvta_generic_to_shared(s16d));
    const int tab_at = bpc * RING_STRIDE / 2;                   // int16 index
    const int al_at = bpc * RING_STRIDE + rans16_dec_part(bpc * rows_per * 2);
    const int idx_at = al_at + rans16_dec_part(bpc * A);
    // where the CTA's converted or copied rows go, and the global rows
    // a block reads when they stay there
    int16_t* const srows = reinterpret_cast<int16_t*>(s16d) + tab_at;
    int16_t* const crows = SMEM ? srows
                                : (PACKED ? conv + (size_t)b0 * rows_per : nullptr);
    if (PACKED) {
        // one thread per row: the reverse running minimum of _b16_fill
        const int32_t* pk = static_cast<const int32_t*>(tab) + (size_t)b0 * nrows * A;
        for (int t = threadIdx.x; t < nblk * nrows; t += blockDim.x) {
            const int gi = t / nrows;
            const int tote = 1 << shift[b0 + gi];
            const int32_t* src = pk + (size_t)t * A;
            int16_t* dst = crows + t * A1;
            int run = tote;
            dst[A] = (int16_t)tote;
            for (int k = A - 1; k >= 0; --k) {
                const int32_t e = src[k];
                if (e & PACK_MASK) run = min(run, e >> PACK_SHIFT);
                dst[k] = (int16_t)run;
            }
        }
    } else if (SMEM) {
        const int16_t* gt = static_cast<const int16_t*>(tab) + (size_t)b0 * rows_per;
        for (int j = threadIdx.x; j < nblk * rows_per; j += blockDim.x)
            srows[j] = gt[j];
    }
    if (SMEM) {
        const uint8_t* ga = alpha + (size_t)b0 * A;
        for (int j = threadIdx.x; j < nblk * A; j += blockDim.x)
            s16d[al_at + j] = ga[j];
    }
    __syncthreads();
    if (SMEM) {
        for (int j = threadIdx.x; j < nblk * nrows * IDX_N; j += blockDim.x) {
            const int r = j / IDX_N;
            const int ss = max(shift[b0 + r / nrows] - 6, 0);
            s16d[idx_at + j] = (uint8_t)count_le(STab{sb + 2 * (tab_at + r * A1)},
                                                 0, A, (j - r * IDX_N) << ss);
        }
    }
    const int16_t* tb = SMEM ? nullptr
                             : (PACKED ? conv : static_cast<const int16_t*>(tab))
                               + bb * rows_per;
    const uint8_t* al = alpha + bb * (size_t)A;
    const int tab_g = tab_at + gl * rows_per;
    const int idx_g = idx_at + gl * nrows * IDX_N;

    const int nw = counts ? min(counts[bb], W) : W;
    const uint8_t* by = reinterpret_cast<const uint8_t*>(words + bb * (size_t)W);
    Stage<SB> sg;
    sg.buf = s16d + g * RING_STRIDE;
    sg.base = reinterpret_cast<const uint8_t*>((uintptr_t)by & ~(uintptr_t)15);
    sg.skew = (int)((uintptr_t)by & 15u);
    sg.nb = 2 * max(nw, 0);
    sg.nseg = sg.nb > 0 ? (sg.skew + sg.nb + 15) >> 4 : 0;
    sg.next = 0;
    if (lane == 0) {
        sg.fill(SEGS);
        cp_async_commit();
        cp_async_wait<0>();
    }
    __syncthreads();

    const int sh = shift[bb];
    const int ss = max(sh - 6, 0);
    const uint32_t mask = (1u << sh) - 1u;
    uint32_t X = states[bb * 4 + lane];
    uint8_t* o = out + bb * (size_t)N;
    const unsigned gsh = (unsigned)tid & 28u;       // group's first bit
    const unsigned lower = (1u << lane) - 1u;

    int p = 0;              // words consumed by the block
    int ctx = 0;
    int oi = -1;            // the previous step's output byte and index
    uint32_t oc = 0u;
    for (int s = 0; s < K; ++s) {
        if (s % STAGE_EVERY == 0) {
            if (lane == 0) {
                sg.fill(((sg.skew + 2 * p) >> 4) + SEGS - 1);
                cp_async_commit();
                cp_async_wait<2>();
            }
            __syncwarp();
        }
        uint32_t w[3];
        int w0;
        sg.window(2 * p, w, w0);
        const bool act = ORDER ? (s < q || lane == 3) : true;
        const int m = (int)(X & mask);
        const int r = ORDER ? ctx * A1 : 0;
        int bs, f, sym;
        if (SMEM) {
            const uint32_t ix = sb + idx_g + (ORDER ? ctx * IDX_N : 0) + (m >> ss);
            const STab row{sb + 2 * (tab_g + r)};
            sym = slot_symbol_indexed<PACKED>(row, lds_u8(ix), lds_u8(ix + 1), m,
                                              bs, f);
        } else {
            const GTab row{tb + r};
            sym = slot_symbol<PACKED>(row, count_le(row, 0, A, m), bs, f);
        }
        const uint32_t Xs = (uint32_t)f * (X >> sh) + (uint32_t)m - (uint32_t)bs;
        const bool need = act && Xs < RANS_L;
        const unsigned gb = (__ballot_sync(0xffffffffu, need) >> gsh) & 0xFu;
        const uint32_t wv = sg.at16(2 * (p + __popc(gb & lower)), w, w0);
        p += __popc(gb);
        const uint32_t Xn = need ? (Xs << 16) | wv : Xs;
        st_if(oi >= 0, o + oi, oc);
        const int at = ORDER ? (s < q ? lane * q + s : 4 * q + (s - q))
                             : 4 * s + lane;
        oi = act && live && at < N ? at : -1;
        oc = SMEM ? lds_u8(sb + al_at + gl * A + sym) : __ldg(al + sym);
        X = act ? Xn : X;
        ctx = act ? sym : ctx;
    }
    if (oi >= 0) o[oi] = (uint8_t)oc;
    cp_async_wait<0>();
}

namespace {

template <bool PACKED>
int dec_launch(const void* states, const void* words, const void* counts,
               const void* tab, const void* alpha, const void* shift,
               void* conv, void* out, int B, int W, int A, int N, int order,
               int threads, int smem_tables, void* stream)
{
    if (B <= 0 || N <= 0) return 0;
    if (A < 1 || W < 1 || (smem_tables && A > 255)
        || (PACKED && !smem_tables && !conv)
        || (threads != 32 && threads != 64 && threads != 128))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)words & 15) return (int)cudaErrorMisalignedAddress;
    const int q = order ? (N >> 2) : ((N + 3) >> 2);
    const int K = order ? q + (N - 4 * q) : q;
    const int bpc = threads / 4;
    const size_t smem = rans16_dec_smem(bpc, order ? A : 1, A, smem_tables != 0);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((size_t)B + bpc - 1) / bpc);
    auto kernel = order ? (smem_tables ? rans16_dec_kernel<1, true, PACKED>
                                       : rans16_dec_kernel<1, false, PACKED>)
                        : (smem_tables ? rans16_dec_kernel<0, true, PACKED>
                                       : rans16_dec_kernel<0, false, PACKED>);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)states, (const uint16_t*)words,
        (const int32_t*)counts, tab, (const uint8_t*)alpha,
        (const int32_t*)shift, (int16_t*)conv, (uint8_t*)out,
        B, W, A, N, q, K);
    return (int)cudaGetLastError();
}

}  // namespace

// states (B,4) u32, words (B,W) u16 (16-byte aligned), counts (B,) i32,
// bases (B, order ? A : 1, A+1) i16, alpha (B,A) u8, shift (B,) i32,
// out (B,N) u8.  `threads` per CTA: 32, 64 or 128; `smem_tables`: copy
// the tables into shared memory.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for bad arguments).
extern "C" int rans16_dec_launch(const void* states, const void* words,
                                 const void* counts, const void* bases,
                                 const void* alpha, const void* shift,
                                 void* out, int B, int W, int A, int N,
                                 int order, int threads, int smem_tables,
                                 void* stream)
{
    return dec_launch<false>(states, words, counts, bases, alpha, shift,
                             nullptr, out, B, W, A, N, order, threads,
                             smem_tables, stream);
}

// The same from packed rows: packed (B, order ? A*A : A) i32 as
// base << 13 | freq, no counts (reads past W give 0), conv (B, order ?
// A : 1, A+1) i16 scratch for the converted rows when they stay in
// global memory (unused with smem_tables).
extern "C" int rans16_dec_packed_launch(const void* states, const void* words,
                                        const void* packed, const void* alpha,
                                        const void* shift, void* conv,
                                        void* out, int B, int W, int A,
                                        int N, int order, int threads,
                                        int smem_tables, void* stream)
{
    return dec_launch<true>(states, words, nullptr, packed, alpha, shift,
                            conv, out, B, W, A, N, order, threads,
                            smem_tables, stream);
}
