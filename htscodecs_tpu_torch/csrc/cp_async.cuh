// cp_async.cuh: asynchronous 16-byte copies from global into shared
// memory (cp.async, sm_80 and later), shared by arith_enc.cu,
// rans8_dec.cu, rans16_dec.cu and rans16_enc_packed.cu, and the ring
// that the two rANS decoders stage their streams in.  The source and
// the destination must be 16-byte aligned; bytes of the 16 past
// `src_bytes` are zero-filled, so a copy never reads past the end of
// what it is given.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Stores under a predicate, with no branch around them: the compiler
// otherwise branches around a store whose address takes a few
// instructions, and a divergent branch costs each step of a chain more
// than the store
__device__ __forceinline__ void st_if(bool p, uint16_t* a, uint16_t v)
{
    asm volatile("{ .reg .pred q; setp.ne.u32 q, %0, 0; @q st.global.u16 [%1], %2; }"
                 :: "r"((uint32_t)p), "l"(a), "h"(v) : "memory");
}

// the low byte of v (a 32-bit register: no conversion waits on the load
// that produced it)
__device__ __forceinline__ void st_if(bool p, uint8_t* a, uint32_t v)
{
    asm volatile("{ .reg .pred q; setp.ne.u32 q, %0, 0; @q st.global.u8 [%1], %2; }"
                 :: "r"((uint32_t)p), "l"(a), "r"(v) : "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// A block's stream staged ahead of its decode chain in a ring `buf` of
// SB bytes (a power of two): stream byte pos sits at
// buf[(skew + pos) % SB], skew = the row's address % 16; segment k is
// the 16 bytes at the aligned address base + 16 k.  Bytes past the
// block's count nb are not copied (zero-filled) and read as 0.
template <int SB>
struct Stage {
    uint8_t* buf;
    const uint8_t* base;
    int skew, nb, nseg, next;

    // ask for the segments below `upto` not yet asked for
    __device__ __forceinline__ void fill(int upto)
    {
        upto = min(upto, nseg);
        for (; next < upto; ++next) {
            const int a = next * 16;
            cp_async16(buf + (a & (SB - 1)), base + a,
                       (uint32_t)min(skew + nb - a, 16));
        }
    }

    // the 12 ring bytes from the aligned word at or before stream byte p
    __device__ __forceinline__ void window(int p, uint32_t w[3], int& w0) const
    {
        w0 = (skew + p) & ~3;
#pragma unroll
        for (int t = 0; t < 3; ++t)
            w[t] = *reinterpret_cast<const uint32_t*>(buf + ((w0 + 4 * t) & (SB - 1)));
    }

    // stream byte pos, within 8 of the window's p
    __device__ __forceinline__ uint32_t at(int pos, const uint32_t w[3],
                                          int w0) const
    {
        const int o = skew + pos - w0;
        const uint32_t v = o < 4 ? w[0] : (o < 8 ? w[1] : w[2]);
        return pos < nb ? (v >> (8 * (o & 3))) & 0xFFu : 0u;
    }

    // the little-endian 16-bit element at stream byte pos, within 8 of
    // the window's p; pos, skew and nb are even (a row of 16-bit words),
    // so the element never straddles two of the window's words
    __device__ __forceinline__ uint32_t at16(int pos, const uint32_t w[3],
                                            int w0) const
    {
        const int o = skew + pos - w0;
        const uint32_t v = o < 4 ? w[0] : (o < 8 ? w[1] : w[2]);
        return pos < nb ? (v >> (8 * (o & 2))) & 0xFFFFu : 0u;
    }
};
