// Forward propagation of a LARGE ensemble of TINY systems: K trajectories,
// one d x d generator each, d <= 4 (a thousand qutrits, say), in two
// launches.  The fused kernel of smalld_fused.cu replaces this pair on
// every shape (hopper_prop.smalld_route); the pair stays as the
// comparison that chip_smoke.py forces and times, with the same
// propagator arithmetic (smalld_expm.cuh).
//
// Replaces the TPU Pallas kernel forward_scan_pallas_smalld of
// grape_tpu/ops/pallas_prop.py (kernel body _smalld_kernel, helpers
// _rows_mm / _rows_cmm).  That kernel is one sequential grid over the N_T
// time steps with the ensemble on the 128 vector lanes and the matrices as
// (d^2, K) lane planes.  Here the N_T * K exponentials are independent and
// only the state chain is sequential, and only along n, so the work is
// split as in prop_scan.cu, with the matrices in REGISTERS instead of a
// global scratch (d is a template parameter, every loop unrolls):
//
//   (a) smalld_propagator_kernel<D>: one THREAD per item (n, k), threads of
//       a warp on consecutive k.  Each forms U[n, k] by
//       smalld_propagator<D> (smalld_expm.cuh: the degree-16 Taylor
//       polynomial by Paterson-Stockmeyer, s squarings, full float32
//       FMAs).  Bound by bytes: 8 d^2 bytes out per item
//       against (6 + s) products of 8 d^3 operations.  A block's items are
//       contiguous in U, so the block stages its propagators in shared
//       memory and writes them out coalesced.  H0 and ops are read as they
//       come, (K, d, d): a warp's strided loads fall into the same few
//       cache lines, and both arrays stay in L1/L2 (a few hundred KB).
//   (b) smalld_apply_kernel<D>: psi_k <- U[n, k] psi_k, n = 0..N_T-1, one
//       thread per trajectory, psi in registers.  Bound by the latency of
//       N_T dependent steps; the propagators of the next kPrefetch steps
//       are already on their way into registers while a step is computed
//       (their addresses do not depend on the state).

#include <cuda_runtime.h>

#include "smalld_expm.cuh"

namespace grape {

constexpr int kSmalldThreads = 128;  // propagator kernel: items per block
constexpr int kApplyThreads = 32;    // apply-scan: trajectories per block
constexpr int kPrefetch = 4;         // apply-scan: steps of U in flight

// U[n, k] = exp(-i dt_n (H0_k + sum_t coeffs[n, t] ops[k, t]))
template <int D>
__global__ void __launch_bounds__(kSmalldThreads)
smalld_propagator_kernel(const float2* __restrict__ H0,
                         const float2* __restrict__ ops,
                         const float* __restrict__ coeffs,
                         const float* __restrict__ dts, int T, int N_T,
                         int K, int s, float2* __restrict__ U) {
    constexpr int DD = D * D;
    constexpr int kStride = DD | 1;  // odd: no shared-memory bank conflicts
    __shared__ float2 stage[kSmalldThreads * kStride];

    const size_t n_items = (size_t)N_T * K;
    const size_t block_first = (size_t)blockIdx.x * kSmalldThreads;
    const size_t item = block_first + threadIdx.x;

    if (item < n_items) {
        const int n = (int)(item / K);
        const int k = (int)(item % K);
        float2 E[DD];
        smalld_propagator<D>(H0, ops, coeffs, dts, T, n, k, s, E);
#pragma unroll
        for (int i = 0; i < DD; ++i) {
            stage[threadIdx.x * kStride + i] = E[i];
        }
    }
    __syncthreads();
    // the block's propagators are contiguous in U: write them coalesced
    const size_t left = n_items - block_first;  // > 0 by the grid size
    const int n_valid =
        left < (size_t)kSmalldThreads ? (int)left : kSmalldThreads;
    float2* out = U + block_first * DD;
    for (int i = threadIdx.x; i < n_valid * DD; i += kSmalldThreads) {
        out[i] = stage[(i / DD) * kStride + (i % DD)];
    }
}

// storage[0] = psi0; storage[n + 1][k] = U[n, k] storage[n][k]
template <int D>
__global__ void __launch_bounds__(kApplyThreads)
smalld_apply_kernel(const float2* __restrict__ U, const float2* psi0,
                    float2* storage, int N_T, int K) {
    constexpr int DD = D * D;
    const int k = blockIdx.x * kApplyThreads + threadIdx.x;
    if (k >= K) return;
    float2 psi[D];
#pragma unroll
    for (int i = 0; i < D; ++i) psi[i] = psi0[(size_t)k * D + i];
#pragma unroll
    for (int i = 0; i < D; ++i) storage[(size_t)k * D + i] = psi[i];

    float2 u[kPrefetch][DD];
#pragma unroll
    for (int p = 0; p < kPrefetch; ++p) {
        if (p < N_T) {
            const float2* src = U + ((size_t)p * K + k) * DD;
#pragma unroll
            for (int i = 0; i < DD; ++i) u[p][i] = src[i];
        }
    }
    for (int n0 = 0; n0 < N_T; n0 += kPrefetch) {
#pragma unroll
        for (int p = 0; p < kPrefetch; ++p) {
            const int n = n0 + p;
            if (n < N_T) {
                float2 nxt[D];
                smalld_apply<D>(u[p], psi, nxt);
                if (n + kPrefetch < N_T) {
                    const float2* src =
                        U + ((size_t)(n + kPrefetch) * K + k) * DD;
#pragma unroll
                    for (int i = 0; i < DD; ++i) u[p][i] = src[i];
                }
                float2* dst = storage + ((size_t)(n + 1) * K + k) * D;
#pragma unroll
                for (int i = 0; i < D; ++i) {
                    psi[i] = nxt[i];
                    dst[i] = nxt[i];
                }
            }
        }
    }
}

template <int D>
static cudaError_t launch_propagators(const float2* H0, const float2* ops,
                                      const float* coeffs, const float* dts,
                                      int T, int N_T, int K, int s,
                                      float2* U, cudaStream_t stream) {
    const size_t n_items = (size_t)N_T * K;
    const size_t blocks = (n_items + kSmalldThreads - 1) / kSmalldThreads;
    if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
    smalld_propagator_kernel<D><<<(unsigned)blocks, kSmalldThreads, 0,
                                  stream>>>(H0, ops, coeffs, dts, T, N_T, K,
                                            s, U);
    return cudaGetLastError();
}

template <int D>
static cudaError_t launch_apply(const float2* U, const float2* psi0,
                                float2* storage, int N_T, int K,
                                cudaStream_t stream) {
    const int blocks = (K + kApplyThreads - 1) / kApplyThreads;
    smalld_apply_kernel<D><<<blocks, kApplyThreads, 0, stream>>>(
        U, psi0, storage, N_T, K);
    return cudaGetLastError();
}

}  // namespace grape

extern "C" {

// U (N_T, K, d, d) from H0 (K, d, d), ops (K, T, d, d), coeffs (N_T, T),
// dts (N_T,); d in 1..4.
int grape_smalld_propagators(const void* H0, const void* ops,
                             const void* coeffs, const void* dts, int T,
                             int d, int N_T, int K, int s, void* U,
                             void* stream) {
    cudaGetLastError();
    if (N_T < 1 || K < 1 || T < 0 || s < 0) return (int)cudaErrorInvalidValue;
    const float2* h = (const float2*)H0;
    const float2* o = (const float2*)ops;
    const float* c = (const float*)coeffs;
    const float* t = (const float*)dts;
    float2* u = (float2*)U;
    cudaStream_t st = (cudaStream_t)stream;
    switch (d) {
        case 1:
            return (int)grape::launch_propagators<1>(h, o, c, t, T, N_T, K, s,
                                                     u, st);
        case 2:
            return (int)grape::launch_propagators<2>(h, o, c, t, T, N_T, K, s,
                                                     u, st);
        case 3:
            return (int)grape::launch_propagators<3>(h, o, c, t, T, N_T, K, s,
                                                     u, st);
        case 4:
            return (int)grape::launch_propagators<4>(h, o, c, t, T, N_T, K, s,
                                                     u, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// storage (N_T + 1, K, d) from U (N_T, K, d, d) and psi0 (K, d).
int grape_smalld_apply(const void* U, const void* psi0, void* storage,
                       int N_T, int K, int d, void* stream) {
    cudaGetLastError();
    if (N_T < 1 || K < 1) return (int)cudaErrorInvalidValue;
    const float2* u = (const float2*)U;
    const float2* p = (const float2*)psi0;
    float2* o = (float2*)storage;
    cudaStream_t st = (cudaStream_t)stream;
    switch (d) {
        case 1:
            return (int)grape::launch_apply<1>(u, p, o, N_T, K, st);
        case 2:
            return (int)grape::launch_apply<2>(u, p, o, N_T, K, st);
        case 3:
            return (int)grape::launch_apply<3>(u, p, o, N_T, K, st);
        case 4:
            return (int)grape::launch_apply<4>(u, p, o, N_T, K, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
