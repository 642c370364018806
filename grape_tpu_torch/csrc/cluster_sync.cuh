// Shared-memory addressing, mbarriers and remote stores for the kernels
// that run on thread block clusters (prop_cluster.cu, state_scan.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grape {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out)
                 : "r"(local), "r"(rank));
    return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(bar)),
                 "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_addr(bar))
                 : "memory");
}

// arrive and expect `bytes` more of asynchronous writes in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    }
}

// store v at a cluster shared-memory address, completing its 8 or 16
// bytes on the mbarrier at `bar` in the same CTA
__device__ __forceinline__ void st_async(unsigned addr, float2 v,
                                         unsigned bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32"
        " [%0], {%1, %2}, [%3];" ::"r"(addr),
        "f"(v.x), "f"(v.y), "r"(bar)
        : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float4 v,
                                         unsigned bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
        " [%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
        : "memory");
}

}  // namespace grape
