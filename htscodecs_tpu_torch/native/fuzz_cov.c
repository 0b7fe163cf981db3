/* Edge-coverage callback for fuzz_native.c (the counterpart of the JAX
 * package's htscodecs_tpu/native/fuzz_cov.c).  MUST be compiled without
 * -fsanitize-coverage: an instrumented callback calls itself. */
#include <stdint.h>
#include <stddef.h>

uint8_t cov_seen[1 << 16];
uint8_t cov_run[1 << 16];
size_t cov_new;

void __sanitizer_cov_trace_pc(void) {
    uintptr_t pc = (uintptr_t)__builtin_return_address(0);
    uint32_t idx = (uint32_t)((pc >> 2) ^ (pc >> 13)) & 0xFFFF;
    if (!cov_run[idx]) {
        cov_run[idx] = 1;
        if (!cov_seen[idx]) {
            cov_seen[idx] = 1;
            cov_new++;
        }
    }
}
