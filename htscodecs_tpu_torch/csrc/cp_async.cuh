// cp_async.cuh: asynchronous 16-byte copies from global into shared
// memory (cp.async, sm_80 and later), shared by arith_enc.cu and
// rans8_dec.cu.  The source and the destination must be 16-byte
// aligned; bytes of the 16 past `src_bytes` are zero-filled, so a copy
// never reads past the end of what it is given.

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

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
