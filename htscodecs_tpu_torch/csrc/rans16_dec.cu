// rans16_dec: batched rANS 4x16 decode, order 0 and order 1, for sm_90a:
// one kernel body, templated on its table reader, with two entry points,
// and a second route for the base-row entry (below).
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
// The base-row entry has a second route (rans16_dec_direct_kernel;
// rans16_dec_direct_launch), for batches that leave the card mostly
// empty, on rans8_dec.cu's direct design:
//
//   - one rANS block a CTA, decoded by the first four lanes of its first
//     warp alone: no other group shares its instructions, its ballot
//     (over those four lanes) or its shared-memory banks, and a reader's
//     16 slices run on 16 SMs where the route above puts them on two;
//   - a fused slot table per context row in shared memory: one 32-bit
//     word per slot of the block's own 1 << shift, freq << 19 | symbol
//     << 12 | (slot - base), so a step is one shared load, a field
//     extraction, one multiply-add and the renormalisation, with no loop
//     and no branch.  The CTA's warps fill the words in the prologue by
//     running count_le and slot_symbol (the base-row answers), the route
//     above's own lookup, on each slot, so a slot decodes as it does
//     there by construction: slots at or past a row's total, rows with
//     no base <= the slot (freq = row[1]) and freq-0 entries included.
//     The words hold every row whose entries are monotone and lie in
//     [0, 4096] (freq up to 4096 takes 13 bits, slot - base 12), shifts
//     up to 12 and alphabets of up to 128 symbols (7 bits); the wrapper
//     sends any other launch the route above.  A CTA sizes its rows by
//     the launch's largest shift and strides them by its own;
//   - a state takes at most one 16-bit word a step, so the step has one
//     ballot and one popcount; the lane's word is picked out of the 8
//     stream bytes from p (loaded and shifted into two registers off the
//     dependent path) by one byte permute, and shifted into the state by
//     another;
//   - the ring holds DSB = 512 bytes; a round every DSTAGE = 16 steps
//     asks for every segment below the one DSB - 32 bytes ahead, and lane
//     0 waits for the copies asked for DWAIT = 2 rounds before (a round
//     reads at most 128 bytes, 9 segments past its first).  Segments
//     past the stream's end are zero-filled copies, so a word read past
//     a block's count is 0 with no test on the chain;
//   - the output byte's address advances by one (order 1) or four
//     (order 0) per step, and the order-1 tail steps (state 3 alone) and
//     the order-0 last step (whose lanes past N store nothing) run after
//     the main loop.
//
//   The rule that picks the route is in ops/rans_vmem.py (direct_route).
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

// ---------------------------------------------------------------------------
// The direct route (base rows)

#define DSB 512             // ring bytes of the direct route's block
#define DSEGS (DSB / 16)
#define DSTAGE 16           // steps between two rounds of copies
#define DWAIT 2             // rounds a ring copy has to land
#define DTHREADS 128        // threads a CTA: all fill, four decode
// CTAs an SM that the registers must allow: 12, 40 registers a thread
// (the order-0 kernel's own; held to 32, for the 16 CTAs that the
// threads allow, it spilled)
#define DMIN_CTAS 12
#define DMAX_SHIFT 12       // the word's slot - base field
#define DS_SHIFT 12         // word: freq << 19 | sym << 12 | (slot - base)
#define DF_SHIFT 19
#define DMAX_A 128          // symbols the word's 7-bit field holds

namespace {

__device__ __forceinline__ uint32_t lds_u32(uint32_t a)
{
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

// prmt.b32 with a selector whose nibbles are all below 8 (__byte_perm
// masks each nibble first, an instruction on the chain)
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t s)
{
    uint32_t r;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(s));
    return r;
}

// cp.async of 16 bytes to a 32-bit shared address, the bytes past n
// zero-filled (n = 0: no byte is read)
__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              uint32_t n)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
}

// A block's stream in the direct route's ring of DSB bytes: stream byte
// pos at buf + (skew + pos) % DSB, as in Stage, but every segment is
// copied, those past the block's nb bytes as zeros.
struct DRing {
    uint32_t buf;
    const uint8_t* base;
    int skew, nb, next;

    __device__ __forceinline__ void fill(int upto)
    {
        for (; next < upto; ++next) {
            const int a = next * 16;
            const int n = min(max(skew + nb - a, 0), 16);
            cp_async16_to(buf + (a & (DSB - 1)), n > 0 ? base + a : base,
                          (uint32_t)n);
        }
    }
};

// One step of the four lanes of a block, p in stream bytes.  ALL: every
// lane moves (the quarter steps, order 0); otherwise lane 3 alone (the
// order-1 tail).  The previous step's byte is stored first, this step's
// byte is left in (pend, oc) and stored only where `wr` holds.
template <int ORDER, bool ALL>
__device__ __forceinline__ void direct_step(
    const DRing& rg, uint32_t tab, uint32_t al, int lane, unsigned lower,
    int sh, uint32_t mask, uint32_t& X, uint32_t& row, int& p, bool& pv,
    uint8_t*& pend, uint32_t& oc, uint8_t* dst, bool wr)
{
    // stream bytes p .. p + 7 (the next four words) in (w0, w1), from the
    // 12 aligned ring bytes around them
    const int r0 = rg.skew + p;
    const int a = r0 & ~3;
    const uint32_t wa = lds_u32(rg.buf + (a & (DSB - 1)));
    const uint32_t wb = lds_u32(rg.buf + ((a + 4) & (DSB - 1)));
    const uint32_t wc = lds_u32(rg.buf + ((a + 8) & (DSB - 1)));
    const uint32_t w0 = __funnelshift_r(wa, wb, 8 * (r0 & 3));
    const uint32_t w1 = __funnelshift_r(wb, wc, 8 * (r0 & 3));
    // the slot, hidden from the compiler, so that its address is one
    // shift-add
    uint32_t m = X & mask;
    asm volatile("" : "+r"(m));
    const uint32_t e = lds_u32(row + (m << 2));
    const uint32_t sym = (e >> DS_SHIFT) & (DMAX_A - 1);
    const uint32_t Xs = (e >> DF_SHIFT) * (X >> sh) + (e & 0xFFFu);
    const bool act = ALL || lane == 3;
    const bool need = act && Xs < RANS_L;
    const unsigned g = __ballot_sync(0xFu, need);
    // the lane's word, k = rank words past p, in the low 16 bits of v:
    // selector 0x22 k + 0x10
    const uint32_t v = prmt(w0, w1, __popc(g & lower) * 0x22u + 0x10u);
    // Xs << 16 | word, or Xs
    const uint32_t Xn = prmt(Xs, v, need ? 0x1054u : 0x3210u);
    p += 2 * __popc(g);
    st_if(pv, pend, oc);
    oc = (uint32_t)lds_u8(al + sym);
    if (ALL) {
        X = Xn;
        if (ORDER) row = tab + (sym << (sh + 2));
        pv = wr;
    } else {
        X = act ? Xn : X;
        row = act ? tab + (sym << (sh + 2)) : row;
        pv = act;
    }
    pend = dst;
}

}  // namespace

// Where the ring starts: the bytes of the fused rows (nrows << shift
// words) rounded up to 16, so that the ring's cp.async copies land on
// 16-byte shared addresses at any shift.
static int rans16_dec_direct_ring_at(int nrows, int shift)
{
    return rans16_dec_part((nrows << shift) * 4);
}

// Shared memory of one direct-route CTA: the fused rows, the ring, the
// base rows (int16) and the alphabet, each part rounded up to 16 bytes.
// ops/rans_vmem.py (_direct_smem) holds the same rule.
static size_t rans16_dec_direct_smem(int nrows, int A, int shift)
{
    return (size_t)rans16_dec_direct_ring_at(nrows, shift) + DSB
           + rans16_dec_part(nrows * (A + 1) * 2) + rans16_dec_part(A);
}

// ring_at: where the ring starts in every CTA, past the fused rows at the
// launch's largest shift (rans16_dec_direct_ring_at).
template <int ORDER>
__global__ void __launch_bounds__(DTHREADS, DMIN_CTAS)
rans16_dec_direct_kernel(const uint32_t* __restrict__ states,
                         const uint16_t* __restrict__ words,
                         const int32_t* __restrict__ counts,
                         const int16_t* __restrict__ bases,
                         const uint8_t* __restrict__ alpha,
                         const int32_t* __restrict__ shift,
                         uint8_t* __restrict__ out,
                         int W, int A, int N, int q, int K, int ring_at)
{
    const int tid = opaque(threadIdx.x);
    const size_t b = (size_t)opaque(blockIdx.x);
    const int A1 = A + 1;
    const int nrows = ORDER ? A : 1;
    const int rows_per = nrows * A1;
    const int sh = shift[b];
    const uint32_t sb = (uint32_t)opaque((int)__cvta_generic_to_shared(s16d));
    const int rows_at = ring_at + DSB;                          // bytes
    const int al_at = rows_at + rans16_dec_part(rows_per * 2);

    DRing rg;
    rg.buf = sb + ring_at;
    const uint8_t* by = reinterpret_cast<const uint8_t*>(words + b * (size_t)W);
    rg.base = reinterpret_cast<const uint8_t*>((uintptr_t)by & ~(uintptr_t)15);
    rg.skew = (int)((uintptr_t)by & 15u);
    rg.nb = 2 * max(min(counts[b], W), 0);
    rg.next = 0;
    if (tid == 0) {             // the ring's first copies beside the fill
        rg.fill(DSEGS);
        cp_async_commit();
    }
    int16_t* srows = reinterpret_cast<int16_t*>(s16d + rows_at);
    const int16_t* gt = bases + b * rows_per;
    for (int j = tid; j < rows_per; j += blockDim.x)
        srows[j] = gt[j];
    for (int j = tid; j < A; j += blockDim.x)
        s16d[al_at + j] = alpha[b * A + j];
    __syncthreads();
    // the fused words, each from the bisection route's own lookup
    uint32_t* fused = reinterpret_cast<uint32_t*>(s16d);
    const int slots = 1 << sh;
    for (int j = tid; j < nrows << sh; j += blockDim.x) {
        const int r = j >> sh;
        const int m = j & (slots - 1);
        const STab row{sb + (uint32_t)(rows_at + 2 * r * A1)};
        int bs, f;
        const int sym = slot_symbol<false>(row, count_le(row, 0, A, m), bs, f);
        fused[j] = (uint32_t)f << DF_SHIFT | (uint32_t)sym << DS_SHIFT
                   | (uint32_t)(m - bs);
    }
    if (tid == 0) cp_async_wait<0>();
    __syncthreads();
    if (tid >= 4) return;

    const int lane = tid;
    const unsigned lower = (1u << lane) - 1u;
    const uint32_t mask = (uint32_t)slots - 1u;
    const uint32_t tab = sb;
    const uint32_t al = sb + al_at;
    uint32_t X = states[b * 4 + lane];
    uint32_t row = tab;
    uint8_t* const o = out + b * (size_t)N;
    // steps in which every lane stores its byte: order 1's quarter steps
    // (lane l's bytes from l q on), order 0's full steps but the last
    // (byte 4 s + l)
    const int nall = ORDER ? q : K - 1;
    uint8_t* dst = ORDER ? o + (size_t)lane * q : o + lane;
    const int dstep = ORDER ? 1 : 4;
    int p = 0;
    bool pv = false;
    uint8_t* pend = o;
    uint32_t oc = 0u;

    auto stage = [&]() {
        if (lane == 0) {
            rg.fill(((rg.skew + p) >> 4) + DSEGS - 1);
            cp_async_commit();
            cp_async_wait<DWAIT>();
        }
        __syncwarp(0xFu);
    };
    int s = 0;
    for (; s + DSTAGE <= nall; s += DSTAGE) {
        stage();
#pragma unroll
        for (int j = 0; j < DSTAGE; ++j) {
            direct_step<ORDER, true>(rg, tab, al, lane, lower, sh, mask, X,
                                     row, p, pv, pend, oc, dst, true);
            dst += dstep;
        }
    }
    if (s < nall) {
        stage();
        for (; s < nall; ++s) {
            direct_step<ORDER, true>(rg, tab, al, lane, lower, sh, mask, X,
                                     row, p, pv, pend, oc, dst, true);
            dst += dstep;
        }
    }
    if (ORDER) {
        if (s < K) {            // the tail: state 3 alone, bytes 4 q on
            stage();
            dst = o + 4 * (size_t)q;
            for (; s < K; ++s) {
                direct_step<ORDER, false>(rg, tab, al, lane, lower, sh, mask,
                                          X, row, p, pv, pend, oc, dst, true);
                ++dst;
            }
        }
    } else {                    // the last step: lanes past N store nothing
        stage();
        direct_step<ORDER, true>(rg, tab, al, lane, lower, sh, mask, X, row,
                                 p, pv, pend, oc, dst, 4 * s + lane < N);
    }
    st_if(pv, pend, oc);
    if (lane == 0) cp_async_wait<0>();
}

// The direct route over rans16_dec_launch's arguments (no `threads`,
// `smem_tables`): one CTA of DTHREADS threads a block.  max_shift is the
// largest of the blocks' shifts (1 to DMAX_SHIFT; the CTA's rows are
// sized by it).  The caller keeps it to launches whose rows are
// packable (every int16 entry in [0, 4096], each row non-decreasing)
// and A <= DMAX_A.  Returns cudaGetLastError() (or cudaErrorInvalidValue
// / cudaErrorMisalignedAddress for bad arguments).
extern "C" int rans16_dec_direct_launch(const void* states, const void* words,
                                        const void* counts, const void* bases,
                                        const void* alpha, const void* shift,
                                        void* out, int B, int W, int A, int N,
                                        int order, int max_shift, void* stream)
{
    if (B <= 0 || N <= 0) return 0;
    if (A < 1 || A > DMAX_A || W < 1 || max_shift < 1
        || max_shift > DMAX_SHIFT)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)words & 15) return (int)cudaErrorMisalignedAddress;
    const int q = order ? (N >> 2) : ((N + 3) >> 2);
    const int K = order ? q + (N - 4 * q) : q;
    const int nrows = order ? A : 1;
    const size_t smem = rans16_dec_direct_smem(nrows, A, max_shift);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    auto kernel = order ? rans16_dec_direct_kernel<1>
                        : rans16_dec_direct_kernel<0>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<(unsigned)B, DTHREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)states, (const uint16_t*)words,
        (const int32_t*)counts, (const int16_t*)bases,
        (const uint8_t*)alpha, (const int32_t*)shift, (uint8_t*)out,
        W, A, N, q, K, rans16_dec_direct_ring_at(nrows, max_shift));
    return (int)cudaGetLastError();
}

// CTAs of the direct route that one SM holds at once at this alphabet,
// order and shift, by the CUDA occupancy calculator (what the wrapper's
// rule computes from the shared memory and the threads alone);
// negative: a CUDA error.
extern "C" int rans16_dec_direct_ctas_per_sm(int A, int order, int shift)
{
    if (A < 1 || A > DMAX_A || shift < 1 || shift > DMAX_SHIFT)
        return -(int)cudaErrorInvalidValue;
    const size_t smem = rans16_dec_direct_smem(order ? A : 1, A, shift);
    int n_ctas = 0;
    auto kernel = order ? rans16_dec_direct_kernel<1>
                        : rans16_dec_direct_kernel<0>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_ctas, kernel,
                                                            DTHREADS, smem);
    // a CTA that does not fit is an answer here, not an error for the
    // next launch's cudaGetLastError() to report
    if (err != cudaSuccess) cudaGetLastError();
    return err != cudaSuccess ? -(int)err : n_ctas;
}
