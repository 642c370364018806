// Forward propagation of a LARGE ensemble of TINY systems (d <= 4, one
// generator per trajectory) in ONE launch: the propagators are formed in
// shared memory, window by window, and the state chain reads them there.
//
// Replaces the TPU Pallas kernel forward_scan_pallas_smalld of
// grape_tpu/ops/pallas_prop.py:766 (kernel body _smalld_kernel), as the
// two-launch pair of smalld_scan.cu did before it; the pair stays for
// comparison only.  The pair wrote every propagator to device memory
// (29.5 MB at d = 3, K = 1024, N_T = 400) and read it back with one thread
// per trajectory in 32 one-warp blocks (32 of 132 SMs), four steps in
// flight: the 400-step chain waited on an L2 round trip every four steps.
//
// What bounds this on the card: the chain is N_T dependent d x d
// matrix-vector products per trajectory (latency), the propagators are
// (6 + s) products of 8 d^3 operations per (step, trajectory) item
// (instruction issue), and the bytes are the states written (and U where
// it is kept).
// The design:
//
//   - one CTA per TILE of trajectories (tile a power of two, the smallest
//     whose CTAs fit one wave: 8 at K = 1024 on 132 SMs, 128 CTAs), so
//     every SM runs a chain;
//   - the time axis in WINDOWS of `window` steps (window * tile <= 256
//     items).  256 producer threads form a window's propagators, one item
//     per thread, with the arithmetic of smalld_expm.cuh (the pair's,
//     bit for bit), into one of two shared buffers;
//   - one chain warp (a lane per trajectory of the tile) walks the window
//     in the other buffer, psi in registers, the next step's propagator
//     loaded while a step is computed, and writes the states;
//   - one __syncthreads per window swaps the buffers;
//   - U goes to device memory only when the caller keeps it, copied
//     coalesced from the buffer the chain is reading (a window's items
//     are contiguous in U row by row).  Without it no propagator leaves
//     the CTA, and the windowed call of the pair is one launch.

#include <cuda_runtime.h>

#include "smalld_expm.cuh"

namespace grape {

constexpr int kFusedProducers = 256;  // threads forming propagators
constexpr int kFusedThreads = 32 + kFusedProducers;  // + the chain warp

template <int D>
__global__ void __launch_bounds__(kFusedThreads)
smalld_fused_kernel(const float2* __restrict__ H0,
                    const float2* __restrict__ ops,
                    const float* __restrict__ coeffs,
                    const float* __restrict__ dts,
                    const float2* __restrict__ psi0, int T, int N_T, int K,
                    int s, int tile, int window, float2* __restrict__ storage,
                    float2* __restrict__ U) {
    constexpr int DD = D * D;
    constexpr int kStride = DD | 1;  // odd: no shared-memory bank conflicts
    extern __shared__ float2 fused_smem[];
    const int per_buf = window * tile * kStride;
    const int k0 = blockIdx.x * tile;
    const int kt_valid = min(tile, K - k0);  // >= 1 by the grid size
    const int n_windows = (N_T + window - 1) / window;
    const int tid = threadIdx.x;
    const int ptid = tid - 32;  // producer index (chain warp: < 0)

    // producers: the propagators of window w into buffer w & 1
    auto form = [&](int w) {
        const int n0 = w * window;
        const int items = min(window, N_T - n0) * tile;
        float2* buf = fused_smem + (w & 1) * per_buf;
        for (int i = ptid; i < items; i += kFusedProducers) {
            const int kt = i % tile;
            if (kt < kt_valid) {
                float2 E[DD];
                smalld_propagator<D>(H0, ops, coeffs, dts, T, n0 + i / tile,
                                     k0 + kt, s, E);
#pragma unroll
                for (int e = 0; e < DD; ++e) buf[i * kStride + e] = E[e];
            }
        }
    };

    if (ptid >= 0) form(0);
    float2 psi[D];
    const int k = k0 + tid;  // the chain lane's trajectory
    const bool chain = tid < kt_valid;
    if (chain) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
            psi[i] = psi0[(size_t)k * D + i];
            storage[(size_t)k * D + i] = psi[i];
        }
    }
    __syncthreads();

    for (int w = 0; w < n_windows; ++w) {
        const int n0 = w * window;
        const int steps = min(window, N_T - n0);
        const float2* buf = fused_smem + (w & 1) * per_buf;
        if (chain) {
            float2 u[DD];
#pragma unroll
            for (int e = 0; e < DD; ++e) u[e] = buf[tid * kStride + e];
            for (int nl = 0; nl < steps; ++nl) {
                float2 nxt[D];
                smalld_apply<D>(u, psi, nxt);
                if (nl + 1 < steps) {
                    const float2* src = buf + ((nl + 1) * tile + tid) * kStride;
#pragma unroll
                    for (int e = 0; e < DD; ++e) u[e] = src[e];
                }
                float2* dst = storage + ((size_t)(n0 + nl + 1) * K + k) * D;
#pragma unroll
                for (int i = 0; i < D; ++i) {
                    psi[i] = nxt[i];
                    dst[i] = nxt[i];
                }
            }
        } else if (ptid >= 0) {
            if (U != nullptr) {
                // this window's propagators, row n of U holding the tile's
                // kt_valid items contiguously
                const int per_row = kt_valid * DD;
                const int total = steps * per_row;
                for (int e = ptid; e < total; e += kFusedProducers) {
                    const int nl = e / per_row;
                    const int rem = e - nl * per_row;
                    const int kt = rem / DD;
                    const int el = rem - kt * DD;
                    U[((size_t)(n0 + nl) * K + k0) * DD + rem] =
                        buf[(nl * tile + kt) * kStride + el];
                }
            }
            if (w + 1 < n_windows) form(w + 1);
        }
        __syncthreads();
    }
}

template <int D>
static cudaError_t launch_fused(const float2* H0, const float2* ops,
                                const float* coeffs, const float* dts,
                                const float2* psi0, int T, int N_T, int K,
                                int s, int tile, int window, float2* storage,
                                float2* U, cudaStream_t stream) {
    const size_t smem = (size_t)2 * window * tile * ((D * D) | 1) *
                        sizeof(float2);
    cudaError_t err = cudaFuncSetAttribute(
        smalld_fused_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int blocks = (K + tile - 1) / tile;
    smalld_fused_kernel<D><<<blocks, kFusedThreads, smem, stream>>>(
        H0, ops, coeffs, dts, psi0, T, N_T, K, s, tile, window, storage, U);
    return cudaGetLastError();
}

}  // namespace grape

extern "C" {

// storage (N_T + 1, K, d) and, where U is not null, U (N_T, K, d, d) from
// H0 (K, d, d), ops (K, T, d, d), coeffs (N_T, T), dts (N_T,) and psi0
// (K, d); d in 1..4, tile trajectories per CTA (1..32), window steps per
// shared buffer, window * tile <= 256.
int grape_smalld_fused(const void* H0, const void* ops, const void* coeffs,
                       const void* dts, const void* psi0, int T, int d,
                       int N_T, int K, int s, int tile, int window,
                       void* storage, void* U, void* stream) {
    cudaGetLastError();
    if (N_T < 1 || K < 1 || T < 0 || s < 0 || tile < 1 || tile > 32 ||
        window < 1 || window * tile > grape::kFusedProducers) {
        return (int)cudaErrorInvalidValue;
    }
    const float2* h = (const float2*)H0;
    const float2* o = (const float2*)ops;
    const float* c = (const float*)coeffs;
    const float* t = (const float*)dts;
    const float2* p = (const float2*)psi0;
    float2* st = (float2*)storage;
    float2* u = (float2*)U;
    cudaStream_t sm = (cudaStream_t)stream;
    switch (d) {
        case 1:
            return (int)grape::launch_fused<1>(h, o, c, t, p, T, N_T, K, s,
                                               tile, window, st, u, sm);
        case 2:
            return (int)grape::launch_fused<2>(h, o, c, t, p, T, N_T, K, s,
                                               tile, window, st, u, sm);
        case 3:
            return (int)grape::launch_fused<3>(h, o, c, t, p, T, N_T, K, s,
                                               tile, window, st, u, sm);
        case 4:
            return (int)grape::launch_fused<4>(h, o, c, t, p, T, N_T, K, s,
                                               tile, window, st, u, sm);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
