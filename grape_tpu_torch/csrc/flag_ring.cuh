// Point-to-point exchange through global memory for the persistent,
// co-resident grids (cheby_ring.cu, state_grid.cu): release flags on
// 128-byte lines of their own, waits that trap instead of holding the card,
// and the fold of a warp's partial sums across its lanes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sync.cuh"

namespace grape {
namespace exch {

constexpr unsigned kFull = 0xffffffffu;
// a flag per 128-byte line: polls of one flag do not queue behind another's
constexpr int kFlagStride = 32;

// A wait that outlasts this many SM cycles (about 8 s) is a fault of the
// protocol, not a slow neighbour: the kernel traps, so the launch fails
// instead of holding the card.
constexpr long long kSpinCycles = 1ll << 34;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

__device__ __forceinline__ void wait_flag(const unsigned* f,
                                          unsigned target) {
    const long long t0 = clock64();
    while (ld_acquire(f) < target) {
        if (clock64() - t0 > kSpinCycles) __trap();
    }
}

// wait until the mbarrier phase of the given parity has completed
__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
    const long long t0 = clock64();
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
        if (!done && clock64() - t0 > kSpinCycles) __trap();
    }
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// one level of the lanes' fold: C values a lane holds -> C / 2 (the lanes
// with bit O set keep the upper half), or at C = 1 a butterfly sum
template <int C, int O>
__device__ __forceinline__ void fold_level(float* vr, float* vi, int lane) {
    if constexpr (C > 1) {
        constexpr int H = C / 2;
        const bool upper = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float sr = upper ? vr[i] : vr[i + H];
            const float si = upper ? vi[i] : vi[i + H];
            const float kr = upper ? vr[i + H] : vr[i];
            const float ki = upper ? vi[i + H] : vi[i];
            vr[i] = kr + __shfl_xor_sync(kFull, sr, O);
            vi[i] = ki + __shfl_xor_sync(kFull, si, O);
        }
    } else {
        vr[0] += __shfl_xor_sync(kFull, vr[0], O);
        vi[0] += __shfl_xor_sync(kFull, vi[0], O);
    }
}

// Sums of C0 values over the 32 lanes by recursive halving: afterwards the
// lane holds max(1, C0 / 32) sums, sum i being value
// i + max(1, C0 / 32) * (lane / max(1, 32 / C0)) (all lanes of a group of
// 32 / C0 hold the same sums where C0 < 32).
template <int C0>
__device__ __forceinline__ void fold(float (&vr)[C0], float (&vi)[C0],
                                     int lane) {
    fold_level<C0, 16>(vr, vi, lane);
    fold_level<(C0 >= 2 ? C0 / 2 : 1), 8>(vr, vi, lane);
    fold_level<(C0 >= 4 ? C0 / 4 : 1), 4>(vr, vi, lane);
    fold_level<(C0 >= 8 ? C0 / 8 : 1), 2>(vr, vi, lane);
    fold_level<(C0 >= 16 ? C0 / 16 : 1), 1>(vr, vi, lane);
}

}  // namespace exch
}  // namespace grape
