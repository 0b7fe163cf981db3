// rans8_dec: batched rANS 4x8 (CRAM 3.0) decode, order 0 and order 1,
// for sm_90a: two routes, one contract.
//
// Replaces the Pallas 4x8 decode kernel of the JAX package
// (htscodecs_tpu/ops/rans8_vmem.py, _build_dec_kernel / _dec_vmem8),
// which keeps 128 blocks' tables and a 512-byte window of each stream
// in on-chip memory, resolves every lookup with select chains, and
// leaves the order-0 tail to tensor code after the kernel.  In both
// routes here, as in rans16_dec:
//
//   - one 4-thread group per rANS block, thread l = rANS state l;
//   - a state consumes 0, 1 or 2 bytes per step (rANS_byte.h
//     RansDecRenorm).  Whether the second is needed does not depend on
//     the first byte's value ((X << 8 | b) < L  <=>  X < L >> 8), so
//     every offset is known before any byte is read: claims go in state
//     order 0..3, a state's two bytes adjacent, ranked by two ballots
//     and popcounts of the lower states' bits;
//   - each block's stream is staged ahead of the chain in a shared ring
//     with cp.async, and a decoded byte is stored one step late, so that
//     the load of its alphabet entry is not waited for on the chain;
//   - decoded bytes go straight to the (B, N) output; at order 0 the
//     last N & 3 symbols are read from the final states without
//     advancing them (rANS_static.c), inside the kernel.
//
// Bound on this card: memory traffic (stream bytes + tables + states
// in, B*N bytes out).  In fact each group runs a serial chain per step
// (lookup, state update, ballots, stream bytes), and a batch of a few
// slices has a few dozen chains of hundreds of thousands of steps, so
// the latency of one step sets the time.
//
// The bisection route (rans8_dec_kernel; rans8_dec_launch):
//
//   - slot -> symbol is a binary search for the last base <= slot over
//     the context's monotone int16 row, freq = row[s+1] - row[s]; the
//     row's last column is the row's own total (4x8 rows normalise to
//     4095 slots);
//   - the CTA's blocks' base rows and alphabets are copied into shared
//     memory when they fit (`smem_tables`; the wrapper's rule), with a
//     slot index per row built there by the kernel: entry j holds the
//     number of bases <= 64 j, so the bisection starts between entries
//     m / 64 and m / 64 + 1 and mostly has nothing left to do (one
//     shared load, then the base and the next one).  Wider tables (an
//     order-1 alphabet of up to 256 symbols is 131 KB per block) stay in
//     global memory, read through the read-only path, and are bisected
//     whole;
//   - the ring holds SB bytes a block: every 8th step, lane 0 of the
//     group asks for the 16-byte segments of the next SB - 16 bytes and
//     waits for those asked for two rounds before (a step reads at most
//     8 bytes, so a segment is asked for at least 19 steps before it is
//     read).  At the start of a step the group's lanes load the 12
//     aligned bytes around the next 8 stream bytes, so the bytes are
//     there when the ballots have ranked the claims.  Gathering a lane's
//     order-1 bytes into 16-byte stores cost the chain more than it
//     saved, and 4-byte stores saved nothing beyond the noise (PERF.md);
//   - the CTA is `threads` threads (32, 64 or 128: 8 to 32 blocks), so
//     that a batch of thousands of blocks fills every SM.  Eight groups
//     then share a warp: each step's shared loads serve eight rows and
//     eight rings (the rings, unpadded, sit in one bank), and the
//     bisection's branch diverges between them.  At 16 slices a call
//     (two CTAs, two SMs) that put ~335 ns on a step.
//
// The direct route (rans8_dec_direct_kernel; rans8_dec_direct_launch),
// for batches that leave the card mostly empty:
//
//   - one rANS block a CTA, decoded by the first four lanes of its
//     first warp alone: no other group shares its instructions, its
//     ballots (over those four lanes) or its shared-memory banks, and
//     16 slices run on 16 SMs;
//   - a fused slot table per context row in shared memory: one 32-bit
//     word per 12-bit slot, freq << 19 | symbol << 12 | (slot - base)
//     (htscodecs' s3[ctx][slot] of rANS_static4x16pr.c), so a step is
//     one shared load, a field extraction, one multiply-add and the
//     renormalisation, with no loop and no branch.  The CTA's warps fill
//     the table in the prologue by running count_le and slot_symbol, the
//     bisection route's own lookup, on each of the row's 4096 slots, so
//     a slot decodes as it does there by construction: slots at or past
//     a row's total, rows with no base <= the slot and freq-0 entries
//     included.  The words represent every row whose int16 entries are
//     monotone and lie in [0, 4096] (every row a table parse of a valid
//     stream gives: freq up to 4096 takes 13 bits, slot - base 12) and
//     alphabets of up to 128 symbols (7 bits); the wrapper sends any
//     other launch the bisection route;
//   - the ring holds DSB = 512 bytes; a round every DSTAGE = 16 steps
//     asks for every segment below the one DSB - 32 bytes ahead, and
//     lane 0 waits for the copies asked for DWAIT = 2 rounds (32 steps)
//     before: at 50-100 ns a step that leaves 1.6 us or more for a copy
//     to land, against ~0.6 us from memory (a round's reads reach 9
//     segments past its first, and 32 > 2 * 8 + 9 + 1 keeps them asked
//     for two rounds ahead).  Segments past the stream's end are
//     zero-filled copies, so a byte read past a block's count is 0 with
//     no test on the chain;
//   - the step's dependent path is the word's load, its fields, the
//     multiply-add, the two tests, the ballots and popcounts, one byte
//     permute that picks the claimed bytes out of the 8 stream bytes
//     from p (shifted into two registers off the path) and one that
//     shifts them into the state, and the next word's address: 12
//     instructions and one shared load, of ~43 a step (the bisection
//     route's step: ~136 instructions, four branch regions, two to four
//     dependent shared loads; PERF.md).  The four states decoded in one
//     thread instead took 161 ns a step, not 73: that thread issues all
//     ~100 instructions of the four;
//   - shared memory is addressed by 32-bit shared addresses, the output
//     byte's address advances by one per step, and the order-1 tail
//     steps (state 3 alone) run after the quarter loop.
//
//   A CTA holds (order ? A : 1) rows of 16 KB: at order 1 an alphabet of
//   up to 14 fits the opt-in 227 KB, 8 symbols (the QS series' bucket)
//   take one CTA an SM and 5 take two.  A round of CTAs decodes its
//   chains ~4.3x as fast as the bisection route decodes any number of
//   them, which stays flat in B, so the route pays for a few rounds:
//   the rule that picks it (ops/rans8_vmem.py, direct_route) takes the
//   direct route for a launch with the default CTA and shared-memory
//   tables when its CTA fits, B is at most 4 blocks an SM (or one wave,
//   where more CTAs fit on an SM at once: twelve contend, and take 2.8x
//   a round), and the rows are packable.
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

// ---------------------------------------------------------------------------
// The direct route

#define DSB 512             // ring bytes of the direct route's block
#define DSEGS (DSB / 16)
#define DSTAGE 16           // steps between two rounds of copies
#define DWAIT 2             // rounds a ring copy has to land
#define DTHREADS 64         // threads a CTA: all fill, four decode
#define DROW (1 << SHIFT)   // fused words a context row
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

__device__ __forceinline__ uint32_t lds_u8(uint32_t a)
{
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
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

// One step of the four lanes of a block.  ALL: every lane moves (the
// quarter steps, order 0); otherwise lane 3 alone (the order-1 tail).
// The previous step's byte is stored first, this step's byte is left in
// (pend, oc).
template <int ORDER, bool ALL>
__device__ __forceinline__ void direct_step(
    const DRing& rg, uint32_t tab, uint32_t al, int lane, unsigned lower,
    uint32_t& X, uint32_t& row, int& p, bool& pv, uint8_t*& pend,
    uint32_t& oc, uint8_t* dst)
{
    // stream bytes p .. p + 7 in (w0, w1), from the 12 aligned ring bytes
    // around them
    const int r0 = rg.skew + p;
    const int a = r0 & ~3;
    const uint32_t wa = lds_u32(rg.buf + (a & (DSB - 1)));
    const uint32_t wb = lds_u32(rg.buf + ((a + 4) & (DSB - 1)));
    const uint32_t wc = lds_u32(rg.buf + ((a + 8) & (DSB - 1)));
    const uint32_t w0 = __funnelshift_r(wa, wb, 8 * (r0 & 3));
    const uint32_t w1 = __funnelshift_r(wb, wc, 8 * (r0 & 3));
    // the slot, hidden from the compiler, so that its address is one
    // shift-add (it otherwise shifted X, masked and added)
    uint32_t m = X & MASK;
    asm volatile("" : "+r"(m));
    const uint32_t e = lds_u32(row + (m << 2));
    const uint32_t sym = (e >> DS_SHIFT) & (DMAX_A - 1);
    const uint32_t Xs = (e >> DF_SHIFT) * (X >> SHIFT) + (e & MASK);
    const bool act = ALL || lane == 3;
    const bool need1 = act && Xs < RANS8_L;
    const bool need2 = need1 && Xs < (RANS8_L >> 8);
    const unsigned g1 = __ballot_sync(0xFu, need1);
    const unsigned g2 = __ballot_sync(0xFu, need2);
    // the lane's first byte, o = o1 + o2 bytes past p (o <= 6), and the
    // next one, in the low 16 bits of v: selector 0x11 o + 0x10, with o2's
    // part hidden from the compiler, so that o1's is one multiply-add (it
    // otherwise added o1 and o2 first)
    uint32_t sel2 = __popc(g2 & lower) * 0x11u + 0x10u;
    asm volatile("" : "+r"(sel2));
    const uint32_t v = prmt(w0, w1, __popc(g1 & lower) * 0x11u + sel2);
    // X << 16 | b0 << 8 | b1, X << 8 | b0, or X
    const uint32_t Xn = prmt(Xs, v, need2 ? 0x1045u
                                          : (need1 ? 0x2104u : 0x3210u));
    p += __popc(g1) + __popc(g2);
    st_if(pv, pend, oc);
    oc = lds_u8(al + sym);
    if (ALL) {
        X = Xn;
        if (ORDER) row = tab + (sym << (SHIFT + 2));
        pv = true;
        pend = dst;
    } else {
        X = act ? Xn : X;
        row = act ? tab + (sym << (SHIFT + 2)) : row;
        pv = act;
        pend = dst;
    }
}

}  // namespace

// Shared memory of one direct-route CTA: the fused rows (16 KB each),
// the ring, the base rows (int16) and the alphabet, each part rounded
// up to 16 bytes.  ops/rans8_vmem.py (_direct_smem) holds the same rule.
static size_t rans8_dec_direct_smem(int nrows, int A)
{
    return (size_t)nrows * DROW * 4 + DSB + rans8_dec_part(nrows * (A + 1) * 2)
           + rans8_dec_part(A);
}

template <int ORDER>
__global__ void __launch_bounds__(DTHREADS)
rans8_dec_direct_kernel(const uint32_t* __restrict__ states,
                        const uint8_t* __restrict__ stream,
                        const int32_t* __restrict__ counts,
                        const int16_t* __restrict__ bases,
                        const uint8_t* __restrict__ alpha,
                        uint8_t* __restrict__ out,
                        int W, int A, int N, int q, int K)
{
    const int tid = opaque(threadIdx.x);
    const size_t b = (size_t)opaque(blockIdx.x);
    const int A1 = A + 1;
    const int nrows = ORDER ? A : 1;
    const int rows_per = nrows * A1;
    const uint32_t sb = (uint32_t)opaque((int)__cvta_generic_to_shared(s8mem));
    const int ring_at = nrows * DROW * 4;
    const int rows_at = ring_at + DSB;                          // bytes
    const int al_at = rows_at + rans8_dec_part(rows_per * 2);

    DRing rg;
    rg.buf = sb + ring_at;
    const uint8_t* by = stream + b * (size_t)W;
    rg.base = reinterpret_cast<const uint8_t*>((uintptr_t)by & ~(uintptr_t)15);
    rg.skew = (int)((uintptr_t)by & 15u);
    rg.nb = max(min(counts[b], W), 0);
    rg.next = 0;
    if (tid == 0) {             // the ring's first copies beside the fill
        rg.fill(DSEGS);
        cp_async_commit();
    }
    int16_t* srows = reinterpret_cast<int16_t*>(s8mem + rows_at);
    const int16_t* gt = bases + b * rows_per;
    for (int j = tid; j < rows_per; j += blockDim.x)
        srows[j] = gt[j];
    for (int j = tid; j < A; j += blockDim.x)
        s8mem[al_at + j] = alpha[b * A + j];
    __syncthreads();
    // the fused words, each from the bisection route's own lookup
    uint32_t* words = reinterpret_cast<uint32_t*>(s8mem);
    for (int j = tid; j < nrows * DROW; j += blockDim.x) {
        const int r = j >> SHIFT;
        const int m = j & (DROW - 1);
        const STab row{rows_at / 2 + r * A1};
        int bs, f;
        const int sym = slot_symbol(row, count_le(row, 0, A, m), bs, f);
        words[j] = (uint32_t)f << DF_SHIFT | (uint32_t)sym << DS_SHIFT
                   | (uint32_t)(m - bs);
    }
    if (tid == 0) cp_async_wait<0>();
    __syncthreads();
    if (tid >= 4) return;

    const int lane = tid;
    const unsigned lower = (1u << lane) - 1u;
    const uint32_t tab = sb;
    const uint32_t al = sb + al_at;
    uint32_t X = states[b * 4 + lane];
    uint32_t row = tab;
    uint8_t* const o = out + b * (size_t)N;
    // quarter steps (order 1: lane l's bytes from l q on) or full steps
    // (order 0: byte 4 s + l)
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
    for (; s + DSTAGE <= q; s += DSTAGE) {
        stage();
#pragma unroll
        for (int j = 0; j < DSTAGE; ++j) {
            direct_step<ORDER, true>(rg, tab, al, lane, lower, X, row, p, pv,
                                     pend, oc, dst);
            dst += dstep;
        }
    }
    if (s < q) {
        stage();
        for (; s < q; ++s) {
            direct_step<ORDER, true>(rg, tab, al, lane, lower, X, row, p, pv,
                                     pend, oc, dst);
            dst += dstep;
        }
    }
    if (ORDER && s < K) {       // the tail: state 3 alone, bytes 4 q on
        stage();
        dst = o + 4 * (size_t)q;
        for (; s < K; ++s) {
            direct_step<ORDER, false>(rg, tab, al, lane, lower, X, row, p, pv,
                                      pend, oc, dst);
            ++dst;
        }
    }
    st_if(pv, pend, oc);
    if (lane == 0) cp_async_wait<0>();
    // order 0: the last N & 3 symbols come from the final states, which
    // do not advance
    if (!ORDER && lane < (N & 3))
        o[4 * K + lane] = (uint8_t)lds_u8(
            al + ((lds_u32(tab + ((X & MASK) << 2)) >> DS_SHIFT) & (DMAX_A - 1)));
}

// The direct route over the same arguments as rans8_dec_launch (no
// `threads`, `smem_tables`): one CTA of DTHREADS threads a block.  The
// caller keeps it to launches whose rows are packable (every int16 entry
// in [0, 4096], each row non-decreasing) and A <= DMAX_A.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for bad arguments).
extern "C" int rans8_dec_direct_launch(const void* states, const void* stream,
                                       const void* counts, const void* bases,
                                       const void* alpha, void* out,
                                       int B, int W, int A, int N, int order,
                                       void* cuda_stream)
{
    if (B <= 0 || N <= 0) return 0;
    if (A < 1 || A > DMAX_A || W < 1 || (!order && N < 4))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)stream & 15) return (int)cudaErrorMisalignedAddress;
    const int q = N >> 2;
    const int K = order ? q + (N - 4 * q) : q;
    const size_t smem = rans8_dec_direct_smem(order ? A : 1, A);
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    auto kernel = order ? rans8_dec_direct_kernel<1> : rans8_dec_direct_kernel<0>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<(unsigned)B, DTHREADS, smem, (cudaStream_t)cuda_stream>>>(
        (const uint32_t*)states, (const uint8_t*)stream,
        (const int32_t*)counts, (const int16_t*)bases,
        (const uint8_t*)alpha, (uint8_t*)out, W, A, N, q, K);
    return (int)cudaGetLastError();
}

// CTAs of the direct route that one SM holds at once at this alphabet
// and order, by the CUDA occupancy calculator (what the wrapper's rule
// computes from the shared memory alone); negative: a CUDA error.
extern "C" int rans8_dec_direct_ctas_per_sm(int A, int order)
{
    if (A < 1 || A > DMAX_A) return -(int)cudaErrorInvalidValue;
    const size_t smem = rans8_dec_direct_smem(order ? A : 1, A);
    auto kernel = order ? rans8_dec_direct_kernel<1> : rans8_dec_direct_kernel<0>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, DTHREADS,
                                                        smem);
    return err != cudaSuccess ? -(int)err : n;
}
