// arith_enc: batched arith_dynamic encode (CRAM 3.1 adaptive range
// coder), order 0 and order 1, for sm_90a.
//
// Replaces the Pallas encode kernel of the JAX package
// (htscodecs_tpu/ops/arith_vmem.py, _build_enc_kernel / _enc_vmem),
// which is order-0 only, caps the model at 64 entries, divides through
// staged float reciprocals, and emits packed byte events that a sort
// stitches and the host expands; and the order-1 case of the XLA scan
// (ops/arith_jax.py, _enc_scan), which serves what that kernel refuses.
//
// Bound on this card: memory traffic (B*N bytes in, the emitted bytes
// out).  In fact each block is a serial chain per symbol: the model walk
// and update (c_simple_model.h), RC_Encode with its divide, and up to
// two RC_ShiftLow.  An encoder knows its symbols in advance, and the
// walk and the update depend only on the symbol sequence, never on the
// coder's range or low, so the chain splits into three stages that run
// in three warps of a CTA, each carrying `G` blocks in its lanes (lane
// g < G: block blockIdx.x * G + g):
//
//   - warp 0, the models (rc_core.cuh: Models, as arith_dec.cu keeps
//     them): in shared memory, initialised by the kernel, one row per
//     block at order 0; at order 1 a context -> slot map and `pool` rows
//     per block, the contexts past the pool in a global bank, both
//     reached through one generic pointer (a shared/global dispatch per
//     symbol cost more).  Per symbol the lane walks the row, updates
//     it, and hands an 8-byte record (acc, f, total) to the range warp;
//     the symbols come through shared memory, a buffer ahead of their
//     use.  The warp keeps nothing else: the reciprocals that arith_dec
//     keeps beside each total are left as row_init wrote them;
//   - warp 1, the range chain (rc_range_step): first, all 32 lanes
//     compute the reciprocals of a buffer's totals; then per symbol
//     r = range / total through the reciprocal and one correction
//     (rc_udiv), the multiply by f and the renormalisation as a shift,
//     with no branch on its data; it queues (acc * r, shifts);
//   - warp 2, low, the carry and the bytes (rc_low_step), which gather
//     per block in a shared-memory ring of `ring` bytes that goes out in
//     16-byte stores (Ring), then the five finishing shifts and the
//     byte count.
//
// Records and queue entries pass in two buffers of `chunk` symbols per
// block, handed over on named barriers as in rc_enc.cu, whose range and
// low stages are the same code.  `G`, `pool`, `chunk` and `ring` are
// launch arguments that do not change the result: the tests run them
// small so that every boundary is crossed at short lengths.  Lengths
// are ragged: each lane stops at its block's own length, a warp's
// chunks run to its longest block.
//
// A symbol that the model does not hold (only with a wrong max-symbol
// argument) codes as position M: acc = the sum of all frequencies,
// frequency 1, only the total is updated, and the next context is 0.
// The plain version does the same.

#include "cp_async.cuh"
#include "rc_core.cuh"

namespace {

constexpr int kThreads = 96;    // warps: 0 the models, 1 the range chain, 2 low
// named barriers (+ s for buffer s), 64 threads each: records staged /
// consumed between warps 0 and 1, queue entries between warps 1 and 2
constexpr int kFull = 1;
constexpr int kEmpty = 3;
constexpr int kQFull = 5;
constexpr int kQEmpty = 7;

// The position of `sym` in the row (M if the model lacks it), with the
// sum of the frequencies before it (acc), its entry (e) and the entry
// before it (prev), walked as c_simple_model.h walks it, two entries
// loaded at a time: the fewest instructions and load rounds for the
// short walks of a sorted row.  A row holds every symbol below M, so
// the walk of such a symbol needs no bound (it reads at most up to the
// total at M); a symbol at or past M (only with a wrong max-symbol
// argument) walks the whole row.
template <class Row>
__device__ __forceinline__ int walk(Row row, int M, uint32_t sym,
                                    uint32_t& acc, uint32_t& e, uint32_t& prev)
{
    acc = 0u;
    prev = 0u;
    int p = 0;
    if (sym < (uint32_t)M) {
        const uint32_t key = sym << 16;
        uint32_t e0 = row[0], e1 = row[1];
        for (;;) {
            if ((e0 ^ key) < 0x10000u) {
                e = e0;
                return p;
            }
            acc += e0 & 0xFFFFu;
            if ((e1 ^ key) < 0x10000u) {
                prev = e0;
                e = e1;
                return p + 1;
            }
            acc += e1 & 0xFFFFu;
            prev = e1;
            p += 2;
            e0 = row[p];
            e1 = row[p + 1];
        }
    }
    for (e = row[0]; p < M; e = row[++p]) {
        acc += e & 0xFFFFu;
        prev = e;
    }
    return p;
}

// One symbol through its model row: the record (acc | max(f, 1) << 16,
// max(total, 1)) of the total before the update; the row is updated.
template <class Row>
__device__ __forceinline__ uint2 model_symbol(Row row, int M, uint32_t sym)
{
    const uint32_t tot = row[M];
    uint32_t acc, e, prev;
    const int p = walk(row, M, sym, acc, e, prev);
    const uint32_t f = p < M ? e & 0xFFFFu : 0u;
    model_update(row, M, p, e, prev, tot);
    return make_uint2(acc | max(f, 1u) << 16, max(tot, 1u));
}

}  // namespace

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
arith_enc_kernel(const uint8_t* __restrict__ blocks,
                 const int32_t* __restrict__ lens,
                 const int32_t* __restrict__ msyms,
                 uint32_t* __restrict__ gbank,
                 uint8_t* __restrict__ out,
                 int32_t* __restrict__ counts,
                 int B, int N, int M, int cap, int G, int pool, int chunk,
                 int ring, int words)
{
    const int warp = threadIdx.x >> 5;
    const int g = opaque(threadIdx.x & 31);
    const int b = opaque(blockIdx.x * G + g);
    const bool live = g < G && b < B;
    const int n = live ? min(max(lens[b], 0), N) : 0;
    const int nmax = __reduce_max_sync(0xffffffffu, n);
    const int nch = (nmax + chunk - 1) / chunk;
    // records rec[(s * chunk + k) * G + g], their reciprocals and the
    // queue entries likewise, then the rings
    uint2* rec = reinterpret_cast<uint2*>(dsmem + G * words);
    uint32_t* rcp = reinterpret_cast<uint32_t*>(rec + 2 * chunk * G);
    uint2* queue = reinterpret_cast<uint2*>(rcp + 2 * chunk * G);
    uint8_t* rings = reinterpret_cast<uint8_t*>(dsmem + G * words)
                     + ((40 * chunk * G + 15) & ~15);
    uint8_t* syms = rings + G * ring;

    if (warp == 0) {
        // ---- the models ----
        const int mine = g * words;
        const int S = row_stride(M);
        Models md{4 * mine, mine + (ORDER ? 64 : 0) + row_pad(M),
                  ORDER ? gbank + (size_t)b * (M - pool) * S + row_pad(M)
                        : nullptr,
                  pool, S, M, live ? msyms[b] : 1, 1};
        // this lane's symbols, a buffer of `chunk` staged a buffer ahead
        // of their use: by cp.async where rows and buffers are 16-byte
        // aligned, else byte by byte
        const uint8_t* in = blocks + (size_t)b * N;
        uint8_t* const sbuf = syms + g * 2 * chunk;
        const bool async = ((uintptr_t)in & 15u) == 0u && chunk % 16 == 0;
        auto stage = [&](int c) {
            const int len = min(chunk, n - c * chunk);
            uint8_t* dst = sbuf + (c & 1) * chunk;
            const uint8_t* src = in + (size_t)c * chunk;
            if (async)
                for (int j = 0; j < len; j += 16)
                    cp_async16(dst + j, src + j, (uint32_t)min(len - j, 16));
            else
                for (int j = 0; j < len; ++j) dst[j] = src[j];
            cp_async_commit();
        };
        if (live) {
            md.init(ORDER);
            stage(0);
        }
        int slot = 0, ctx = 0;
        for (int c = 0; c < nch; ++c) {
            const int s = c & 1, len = min(chunk, n - c * chunk);
            if (live) {
                cp_async_wait<0>();
                stage(c + 1);
            }
            if (c >= 2) named_sync(kEmpty + s);
            uint2* R = rec + s * chunk * G + g;
            const uint8_t* sy = sbuf + s * chunk;
            uint32_t sym = len > 0 ? sy[0] : 0u;
            for (int k = 0; k < len; ++k, R += G) {
                // the next symbol, off the chain
                const uint32_t nsym = k + 1 < len ? sy[k + 1] : 0u;
                if (ORDER) slot = md.claim(slot, ctx);
                // the next context's slot, off the chain
                const int nctx = sym < (uint32_t)M ? (int)sym : 0;
                const int nslot = ORDER ? md.slot_of(nctx) : 0;
                if (ORDER)
                    *R = model_symbol(md.row_ptr(slot), M, sym);
                else
                    *R = model_symbol(md.srow(0), M, sym);
                slot = nslot;
                ctx = nctx;
                sym = nsym;
            }
            __syncwarp();
            named_arrive(kFull + s);
        }
        return;
    }

    if (warp == 1) {
        // ---- the range chain: no branch depends on its data ----
        uint32_t range = 0xFFFFFFFFu;
        for (int c = 0; c < nch; ++c) {
            const int s = c & 1, len = min(chunk, n - c * chunk);
            named_sync(kFull + s);
            if (c >= 2) named_sync(kQEmpty + s);
            // the reciprocals of the buffer's totals, all lanes at once
            // (records past a block's length are stale: any total >= 1)
            const int nrec = min(chunk, nmax - c * chunk) * G;
            const uint2* R0 = rec + s * chunk * G;
            uint32_t* V0 = rcp + s * chunk * G;
            for (int j = g; j < nrec; j += 32)
                V0[j] = rc_udiv_recip(max(R0[j].y, 1u));
            __syncwarp();
            const uint2* R = R0 + g;
            const uint32_t* V = V0 + g;
            uint2* Q = queue + s * chunk * G + g;
            // record k + 1 is loaded a step ahead of the chain (record
            // `len` lies within shared memory and is not used)
            uint2 e = len > 0 ? R[0] : make_uint2(1u, 1u);
            uint32_t m = len > 0 ? V[0] : 0u;
            for (int k = 0; k < len; ++k) {
                const uint2 e1 = R[(k + 1) * G];
                const uint32_t m1 = V[(k + 1) * G];
                Q[k * G] = rc_range_step(range, rc_udiv(range, e.y, m),
                                         e.x & 0xFFFFu, e.x >> 16);
                e = e1;
                m = m1;
            }
            __syncwarp();
            if (c + 2 < nch) named_arrive(kEmpty + s);
            named_arrive(kQFull + s);
        }
        return;
    }

    // ---- low, the carry and the bytes (warp 2) ----
    RcEnc rc;
    rc_enc_init(rc);
    Ring o(rings + g * ring, out + (size_t)b * cap, ring);
    for (int c = 0; c < nch; ++c) {
        const int s = c & 1, len = min(chunk, n - c * chunk);
        named_sync(kQFull + s);
        const uint2* Q = queue + s * chunk * G + g;
        uint2 e = len > 0 ? Q[0] : make_uint2(0u, 0u);
        for (int k = 0; k < len; ++k) {
            const uint2 e1 = Q[(k + 1) * G];
            rc_low_step(rc, o, e);
            e = e1;
        }
        __syncwarp();
        if (c + 2 < nch) named_arrive(kQEmpty + s);
    }
    if (live) {
        rc_finish(rc, o);
        o.flush();
        counts[b] = o.n;
    }
}

// Shared memory of one CTA: G blocks' models, two buffers of `chunk`
// records (8 bytes), reciprocals (4 bytes) and queue entries (8 bytes)
// per block, rounded up to 16 bytes, a ring of `ring` bytes per block
// and two buffers of `chunk` symbols per block.  ops/arith_vmem.py
// (_enc_smem) holds the same rule.
static size_t arith_enc_smem(int M, int order, int pool, int G, int chunk,
                             int ring)
{
    return (size_t)G * 4 * model_words(M, order, pool)
           + ((40 * (size_t)chunk * G + 15) & ~(size_t)15)
           + (size_t)G * (ring + 2 * (size_t)chunk);
}

// blocks (B,N) u8, lens (B,) i32, msyms (B,) i32 the models' initial
// width, gbank (B, M - pool, row_stride(M)) u32 + 4 words scratch (order
// 1 with pool < M; may be null otherwise), out (B,cap) u8 with cap >=
// 2*N + 8, counts (B,) i32; G blocks per warp (1..32), pool rows of shared
// memory per block at order 1 (1..M), chunk symbols per buffer (>= 1),
// ring bytes per block (a power of two >= 16).  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for bad arguments).
extern "C" int arith_enc_launch(const void* blocks, const void* lens,
                                const void* msyms, void* gbank, void* out,
                                void* counts,
                                int B, int N, int M, int cap, int order,
                                int G, int pool, int chunk, int ring,
                                void* cuda_stream)
{
    if (B <= 0) return 0;
    if (N < 0 || M < 1 || M > 256 || cap < 2 * N + 8 || G < 1 || G > 32
        || chunk < 1 || ring < 16 || (ring & (ring - 1)))
        return (int)cudaErrorInvalidValue;
    if (order && (pool < 1 || pool > M || (pool < M && gbank == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (!order) pool = M;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const size_t smem = arith_enc_smem(M, order, pool, G, chunk, ring);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const int words = model_words(M, order, pool);
    cudaStream_t st = (cudaStream_t)cuda_stream;
    const unsigned grid = (unsigned)((B + G - 1) / G);
    auto kernel = order ? arith_enc_kernel<1> : arith_enc_kernel<0>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    kernel<<<grid, kThreads, smem, st>>>(
        (const uint8_t*)blocks, (const int32_t*)lens, (const int32_t*)msyms,
        (uint32_t*)gbank, (uint8_t*)out,
        (int32_t*)counts, B, N, M, cap, G, pool, chunk, ring, words);
    return (int)cudaGetLastError();
}
