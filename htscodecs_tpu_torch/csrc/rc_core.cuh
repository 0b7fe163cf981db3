// rc_core.cuh: the carry-counting byte range coder and the adaptive
// SIMPLE_MODEL, shared by arith_enc.cu, arith_dec.cu and rc_enc.cu.
//
// The coder is htscodecs' c_range_coder.h (RC_Encode, RC_ShiftLow, the
// five finishing shifts), the model its c_simple_model.h, in uint32_t.
//
// Both encoders split RC_Encode into two stages that run in two warps:
// the range chain (rc_range_step), which does not depend on low and
// queues (acc * r, shifts) per symbol, and low, the carry and the bytes
// (rc_low_step).  Each takes r = range / total from its caller, which
// divides through a reciprocal: rc_enc.cu through the 64-bit one staged
// beside each event (rc_udiv64), arith_enc.cu through the 32-bit one
// kept beside each model's total (rc_udiv), as arith_dec.cu does.
// RC_ShiftLow hands each byte to a sink, `cache + carry` once the carry
// is settled and then the `ffnum` deferred bytes `carry - 1` whole, so a
// byte handed over is final; the sink (Ring) gathers the bytes in a
// shared-memory ring that it flushes in 16-byte stores.  The Pallas
// kernels of the JAX package could not store a variable number of bytes
// per step and emitted packed events that were sorted and expanded
// afterwards; nothing of that is needed.
//
// A coded symbol shifts at most twice (total <= 65535, so the range
// loses at most 16 bits), a deferred byte is a shift already counted,
// and the finish adds five: a row of 2 * n + 8 bytes cannot overflow.
//
// The models of arith_enc.cu and arith_dec.cu live in shared memory as
// rows with their total's reciprocals (below: SRow, GRow, row_init,
// Pending, Models, model_words); rows past a block's pool go to a
// global bank.  Shared rows are addressed by index into `dsmem`, so
// that the compiler needs no generic address for them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RC_TOP (1u << 24)
#define RC_THRES 0xFF000000u
#define MODEL_STEP 16u
#define MODEL_MAX_FREQ ((1u << 16) - 17u)

// The dynamic shared memory of every kernel that includes this header.
extern __shared__ __align__(16) uint32_t dsmem[];

struct RcEnc {
    uint32_t low, range, ffnum, cache, carry;
};

__device__ __forceinline__ void rc_enc_init(RcEnc& rc)
{
    rc.low = 0u;
    rc.range = 0xFFFFFFFFu;
    rc.ffnum = 0u;
    rc.cache = 0u;
    rc.carry = 0u;
}

// RC_ShiftLow: `carry` is a counter, and the deferred bytes take
// (carry - 1) & 0xFF: 0xFF without a carry, 0x00 after one.
template <class Sink>
__device__ __forceinline__ void rc_shift_low(RcEnc& rc, Sink& out)
{
    if (rc.low < RC_THRES || rc.carry) {
        out.put(rc.cache + rc.carry);
        const uint32_t run = rc.carry - 1u;
        for (; rc.ffnum; --rc.ffnum) out.put(run);
        rc.cache = rc.low >> 24;
        rc.carry = 0u;
    } else {
        ++rc.ffnum;
    }
    rc.low <<= 8;
}

// The range chain's step of RC_Encode, r = range / total given: the
// multiply by f (>= 1) and the renormalisation as a shift by 0, 8 or 16
// bits, with no branch on the chain's data.  Returns the low stage's
// queue entry (acc * r, shifts).  With valid input two shifts always
// reach RC_TOP; with invalid input the coder still ends.
__device__ __forceinline__ uint2 rc_range_step(uint32_t& range, uint32_t r,
                                               uint32_t acc, uint32_t f)
{
    const uint32_t rg = r * f;
    const uint32_t ns = (rg < RC_TOP) + (rg < (1u << 16));
    range = rg << (8u * ns);
    return make_uint2(acc * r, ns);
}

// The low stage's step: low += acc * r (the carry is its 32-bit wrap),
// then the queued shifts.
template <class Sink>
__device__ __forceinline__ void rc_low_step(RcEnc& rc, Sink& out, uint2 q)
{
    const uint32_t low = rc.low + q.x;
    rc.carry += low < rc.low;
    rc.low = low;
    for (uint32_t j = 0; j < q.y; ++j) rc_shift_low(rc, out);
}

// RC_FinishEncode: five shifts.
template <class Sink>
__device__ __forceinline__ void rc_finish(RcEnc& rc, Sink& out)
{
#pragma unroll 1
    for (int k = 0; k < 5; ++k) rc_shift_low(rc, out);
}

// stream bytes [j, n) of a row from the ring: the unaligned head and
// tail byte by byte, the rest in 16-byte stores (out of line: it runs
// once per ring of bytes)
static __device__ __noinline__ void ring_flush(const uint8_t* ring, uint8_t* row,
                                        uint32_t mask, uint32_t phase, int j,
                                        int n)
{
    for (; j < n && ((phase + j) & 15u); ++j)
        row[j] = ring[(phase + j) & mask];
    for (; j + 16 <= n; j += 16)
        *reinterpret_cast<uint4*>(row + j) =
            *reinterpret_cast<const uint4*>(ring + ((phase + j) & mask));
    for (; j < n; ++j) row[j] = ring[(phase + j) & mask];
}

// The byte sink: stream byte j of the row goes to ring[(phase + j) &
// mask], phase = the row's address & mask, so 16 ring bytes that start
// at a multiple of 16 are 16 output bytes at an aligned address.  When
// the ring's window ends, the bytes since the last flush go out.  A byte
// handed to the ring is final, so no flush rewrites one, and a deferred
// run longer than the ring flushes inside the run.
struct Ring {
    uint8_t* ring;
    uint8_t* row;
    uint32_t mask, phase;
    int n, flushed;

    __device__ __forceinline__ Ring(uint8_t* ring_, uint8_t* row_, int size)
        : ring(ring_), row(row_), mask((uint32_t)size - 1u),
          phase((uint32_t)((uintptr_t)row_ & (uintptr_t)(size - 1))),
          n(0), flushed(0) {}

    __device__ __forceinline__ void flush()
    {
        ring_flush(ring, row, mask, phase, flushed, n);
        flushed = n;
    }

    __device__ __forceinline__ void put(uint32_t byte)
    {
        const uint32_t t = phase + (uint32_t)n;
        ring[t & mask] = (uint8_t)byte;
        ++n;
        if (((t + 1u) & mask) == 0u) flush();
    }
};

// v, hidden from the compiler, so that it keeps v in a register: left to
// itself it rereads the thread index (a special-register read, tens of
// cycles) inside the per-symbol loops
__device__ __forceinline__ int opaque(int v)
{
    asm volatile("" : "+r"(v));
    return v;
}

// Named barriers between two warps of a stage pipeline: the producer
// arrives, the consumer waits (64 threads each).
__device__ __forceinline__ void named_sync(int id)
{
    asm volatile("bar.sync %0, 64;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id)
{
    asm volatile("bar.arrive %0, 64;" :: "r"(id) : "memory");
}

// ---- exact division by a 16-bit total through a reciprocal ----------
//
// rc_enc.cu: m = ceil(2^64 / d) for 2 <= d < 2^16 (d = max(tot, 1)).
// For n < 2^32, floor(n * m / 2^64) = floor(n / d): with e = m d - 2^64
// < d, n * m / 2^64 = n / d + n e / (d 2^64) and n e / 2^64 < 1 / d.
// d = 1 takes m = 0 and one = 1: q = n * one + floor(n * m / 2^64).  Two
// dependent 32-bit wide multiplies give floor(n * m / 2^64), the third
// adds n * one (rc_udiv64).  ops/rc_vmem.py holds the same arithmetic
// (_udiv_recip_plain).
//
// arith_enc.cu, arith_dec.cu: m = floor((2^32 - 1) / d), q0 =
// floor(n * m / 2^32) is floor(n / d) or one less, since m >= 2^32 / d -
// 1 gives n * m / 2^32 > n / d - 1; one correction makes it exact (d =
// 1: m = 2^32 - 1, q0 = n - 1 or 0, corrected to n) (rc_udiv).
__host__ __device__ __forceinline__ uint32_t rc_udiv_recip(uint32_t d)
{
    return 0xFFFFFFFFu / d;
}

__device__ __forceinline__ uint32_t rc_udiv(uint32_t n, uint32_t d, uint32_t m)
{
    const uint32_t q = __umulhi(n, m);
    return q + (n - q * d >= d);
}

// (m_lo, m_hi, one) for rc_udiv64
__device__ __forceinline__ uint3 rc_udiv64_recip(uint32_t d)
{
    if (d <= 1u) return make_uint3(0u, 0u, 1u);
    const unsigned long long m = 0xFFFFFFFFFFFFFFFFull / d + 1ull;
    return make_uint3((uint32_t)m, (uint32_t)(m >> 32), 0u);
}

__device__ __forceinline__ uint32_t rc_udiv64(uint32_t n, uint32_t m_lo,
                                              uint32_t m_hi, uint32_t one)
{
    const unsigned long long t = (unsigned long long)n * m_lo;
    const unsigned long long u = (unsigned long long)n * m_hi + (t >> 32);
    return (uint32_t)(u >> 32) + n * one;
}

// ---- SIMPLE_MODEL ---------------------------------------------------
//
// A model is a row of M + 1 uint32_t: entry j holds
// `symbol << 16 | frequency` (frequencies stay <= 65535), entry M the
// total.  Initial state (convert.model_bank): entry j is
// `j << 16 | (j < max_syms)`, the total max_syms.
//
// After position p was coded (`e` = the entry at p, `prev` the entry at
// p - 1, `total` the row's total before the update; p == M: the symbol
// was not in the model, only the total moves): freq[p] += 16; if the
// total passes 65519, every entry is halved as f -= f >> 1 and the total
// recomputed; THEN one swap with p - 1 if freq[p] > freq[p - 1].  That
// order is visible in the bitstream.  model_update returns the new
// total.  The frequencies of a row never sum past its total (both grow
// by 16 at a hit, the halving sets the total to the sum), and the total
// stays <= 65535 once a symbol was coded.
// `row` is any type whose row[j] is a uint32_t lvalue (SRow, GRow).
template <class Row>
__device__ __forceinline__ void model_init(Row row, int M, int max_syms)
{
    for (int j = 0; j < M; ++j) row[j] = ((uint32_t)j << 16) | (uint32_t)(j < max_syms);
    row[M] = (uint32_t)max_syms;
}

template <class Row>
__device__ __forceinline__ uint32_t model_update(Row row, int M, int p,
                                                 uint32_t e, uint32_t prev,
                                                 uint32_t total)
{
    total += MODEL_STEP;
    const bool hit = p < M;
    if (hit) e += MODEL_STEP;
    if (total > MODEL_MAX_FREQ) {
        if (hit) row[p] = e;
        total = 0u;
        for (int j = 0; j < M; ++j) {
            const uint32_t v = row[j];
            uint32_t f = v & 0xFFFFu;
            f -= f >> 1;
            row[j] = (v & 0xFFFF0000u) | f;
            total += f;
        }
        if (hit) {
            e = row[p];
            if (p > 0) prev = row[p - 1];
        }
    }
    row[M] = total;
    if (hit) {
        if (p > 0 && (e & 0xFFFFu) > (prev & 0xFFFFu)) {
            row[p - 1] = e;
            row[p] = prev;
        } else {
            row[p] = e;
        }
    }
    return total;
}

// ---- model rows with their reciprocals ------------------------------
//
// A row of a coder's model: the SIMPLE_MODEL row (M + 1 words), then the
// reciprocals (rc_udiv_recip) of max(total, 1) at M + 1 and of
// max(total + 16, 1) at M + 2.  Rows are row_stride(M) words apart and
// start row_pad(M) words past a 16-byte boundary, so that row + M is
// 16-byte aligned (word M + 3 is in the row: the 16-byte load of the
// total and its reciprocals reads it).  ops/arith_vmem.py holds the same
// rules (_row_stride, _model_words).
__host__ __device__ __forceinline__ int row_stride(int M)
{
    return (M + 4 + 3) & ~3;
}

__host__ __device__ __forceinline__ int row_pad(int M)
{
    return (4 - (M & 3)) & 3;
}

// A row in shared memory, by word index into dsmem, and one in the
// global bank, by pointer.  head() is the total and its reciprocals in
// one 16-byte load.
struct SRow {
    int at;
    __device__ __forceinline__ uint32_t& operator[](int j) const { return dsmem[at + j]; }
    __device__ __forceinline__ uint4 head(int M) const
    {
        return *reinterpret_cast<const uint4*>(&dsmem[at + M]);
    }
};

struct GRow {
    uint32_t* at;
    __device__ __forceinline__ uint32_t& operator[](int j) const { return at[j]; }
    __device__ __forceinline__ uint4 head(int M) const
    {
        return *reinterpret_cast<const uint4*>(at + M);
    }
};

template <class Row>
__device__ __forceinline__ void row_init(Row row, int M, int max_syms)
{
    model_init(row, M, max_syms);
    row[M + 1] = rc_udiv_recip(max((uint32_t)max_syms, 1u));
    row[M + 2] = rc_udiv_recip(max((uint32_t)max_syms + MODEL_STEP, 1u));
}

// A reciprocal on its way from `rtab` (rtab[t] = rc_udiv_recip(max(t,
// 1))) to a row: stored one symbol after its load was issued, so that
// the load's latency is off the chain.  A row in shared memory is `sat`
// (a word index), one in the global bank `gat` (null otherwise).
//
// A symbol's coder reads the row's head (h: the total and both
// reciprocals), calls begin() before the walk and end() after
// model_update: the update moves the row's second reciprocal into the
// first (the total grows by 16 unless the row is halved, which divides
// afresh), and the reciprocal of total + 32 lands with the next
// symbol's store().
struct Pending {
    int sat;
    uint32_t* gat;
    uint32_t val;

    __device__ __forceinline__ void store() const
    {
        if (gat) *gat = val;
        else dsmem[sat] = val;
    }
    __device__ __forceinline__ void target(SRow r, int M)
    {
        sat = r.at + M + 2;
        gat = nullptr;
    }
    __device__ __forceinline__ void target(GRow r, int M) { gat = r.at + M + 2; }

    template <class Row>
    __device__ __forceinline__ void begin(Row row, int M, uint32_t tot,
                                          const uint32_t* __restrict__ rtab)
    {
        target(row, M);
        val = __ldg(rtab + min(tot + 2u * MODEL_STEP, 0xFFFFu));
    }

    template <class Row>
    __device__ __forceinline__ void end(Row row, int M, uint4 h, uint32_t tot,
                                        uint32_t nt)
    {
        if (nt == tot + MODEL_STEP) {
            row[M + 1] = h.z;
        } else {
            row[M + 1] = rc_udiv_recip(max(nt, 1u));
            val = rc_udiv_recip(max(nt + MODEL_STEP, 1u));
        }
    }
};

// One block's order-1 models: a 256-byte context -> slot map at word
// `map` / 4 of dsmem, `pool` rows from word `rows` and the rows past
// the pool from `grows` in the global bank.  A context gets the next
// slot the first time it occurs: context 0 is always first and owns
// slot 0, so a map entry of 0 means "not yet" for every other context.
// The shared rows are initialised with the map, a global row when its
// slot is handed out.  At order 0 the block has one row, at `rows`.
struct Models {
    int map;            // byte index of the map in dsmem
    int rows;           // word index of slot 0
    uint32_t* grows;    // slot `pool` in the global bank
    int pool, S, M, ms, nused;

    __device__ __forceinline__ void init(bool order1)
    {
        if (order1)
            for (int j = 0; j < 64; ++j) dsmem[map / 4 + j] = 0u;
        for (int slot = 0; slot < (order1 ? pool : 1); ++slot)
            row_init(SRow{rows + slot * S}, M, ms);
        nused = 1;
    }

    __device__ __forceinline__ int slot_of(int ctx) const
    {
        return reinterpret_cast<const uint8_t*>(dsmem)[map + ctx];
    }

    // the slot of context ctx, given its map entry `slot`
    __device__ __forceinline__ int claim(int slot, int ctx)
    {
        if (slot == 0 && ctx != 0) {
            slot = nused++;
            reinterpret_cast<uint8_t*>(dsmem)[map + ctx] = (uint8_t)slot;
            if (slot >= pool) row_init(GRow{grows + (slot - pool) * S}, M, ms);
        }
        return slot;
    }

    __device__ __forceinline__ SRow srow(int slot) const { return SRow{rows + slot * S}; }
    __device__ __forceinline__ GRow grow(int slot) const
    {
        return GRow{grows + (slot - pool) * S};
    }
    // either, as one generic pointer
    __device__ __forceinline__ uint32_t* row_ptr(int slot) const
    {
        return slot < pool ? dsmem + rows + slot * S : grows + (slot - pool) * S;
    }
};

// Shared-memory words of one block's models: order 1 the 256-byte map
// and `pool` rows, order 0 one row, with the row padding; a multiple of
// 4 (16-byte loads) and an odd one of 4, so that the 16-byte loads of 8
// threads fall in different banks.  ops/arith_vmem.py (_model_words)
// holds the same rule.
__host__ __device__ inline int model_words(int M, int order, int pool)
{
    const int w = (order ? 64 + pool * row_stride(M) : row_stride(M))
                  + row_pad(M);
    const int w4 = (w + 3) / 4;
    return 4 * (w4 | 1);
}

// one block per thread, `tpb` threads per CTA
__host__ inline unsigned rc_grid(int B, int tpb)
{
    return (unsigned)((B + tpb - 1) / tpb);
}
