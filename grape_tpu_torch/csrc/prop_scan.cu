// Forward propagation and co-state chain for a SHARED generator.
//
// Replaces two TPU Pallas kernels of grape_tpu/ops/pallas_prop.py:
//
//   forward_scan_pallas_shared  ->  propagator_kernel + forward_apply_kernel
//   chi_scan_pallas_shared      ->  chi_scan_kernel
//
// The Pallas kernels lean on the TPU grid running its steps in order with
// the state carried in on-chip scratch.  On Hopper blocks run in parallel
// and only the state chains are sequential, so the forward scan is split:
//
//   (a) propagator_kernel: the N_T exponentials are independent.  A
//       persistent grid of blocks walks over the time steps; each block
//       forms A_n = -i dt_n 2^-s H_n, the degree-16 Taylor polynomial by
//       Paterson-Stockmeyer in A^4, s squarings, and writes U_n.  Bound by
//       float32 FMA operations: (6 + s) complex d^3 products per step and
//       only d^2 bytes out.  The working set (A..A^4 and two E buffers,
//       480 KB at d = 100) does not fit shared memory, so it lives in a
//       per-block global scratch and products are tiled through shared
//       memory (cmat.cuh); the scratch is sized by the grid, not by N_T.
//   (b) forward_apply_kernel: psi <- psi U_n^T, n = 0..N_T-1, inside one
//       block per group of 4 trajectories, state carried in shared memory.
//       Bound by reading U once (N_T d^2 8 bytes) and by the latency of
//       N_T dependent steps; eight lanes per row of U keep the loads
//       coalesced in 64-byte segments.
//
// chi_scan_kernel is (b) run backwards with conj(U): chi <- chi conj(U_n),
// emitting chi BEFORE each update (chis[n] = chi(t_{n+1})).  It reads U by
// columns, so threads run along the columns and the row range is split over
// 8 thread groups whose partial sums meet in shared memory.
//
// All arithmetic is full float32 (errors of the state chains compound over
// N_T steps, so no reduced-precision product is acceptable here).

#include "cmat.cuh"

namespace grape {

constexpr int kPropScratch = 6;   // A, A2, A3, A4, E0, E1
constexpr int kKB = 4;            // trajectories per apply-scan block
constexpr int kScanThreads = 1024;
constexpr int kRowGroups = 8;     // chi scan: row range split

__global__ void __launch_bounds__(kThreads, 2)
propagator_kernel(const float2* __restrict__ H0,
                  const float2* __restrict__ ops,
                  const float* __restrict__ coeffs,
                  const float* __restrict__ dts, int T, int d, int N_T,
                  int s, float2* scratch, float2* U) {
    __shared__ GemmSmem sm;
    const size_t dd = (size_t)d * d;
    float2* base = scratch + (size_t)blockIdx.x * kPropScratch * dd;
    float2* A = base;
    float2* A2 = base + dd;
    float2* A3 = base + 2 * dd;
    float2* A4 = base + 3 * dd;
    float2* E[2] = {base + 4 * dd, base + 5 * dd};
    const float scale = exp2f(-(float)s);

    for (int n = blockIdx.x; n < N_T; n += gridDim.x) {
        build_generator(A, H0, ops, coeffs + (size_t)n * T, dts[n], scale, T,
                        d);
        powers(A, A2, A3, A4, d, sm);
        // Horner in A^4, blocks b = 4 (the scalar c16), 3, 2, 1, 0; then s
        // squarings.  The last product writes straight into U[n].
        int cur = 0;
        ps_block(E[cur], 3, A, A2, A3, A4, d);
        const int n_ops = 3 + s;
        for (int op = 0; op < n_ops; ++op) {
            float2* dst = (op == n_ops - 1) ? U + (size_t)n * dd : E[cur ^ 1];
            if (op < 3) {
                ps_block(dst, 2 - op, A, A2, A3, nullptr, d);
                cgemm(dst, A4, E[cur], d, true, sm);
            } else {
                cgemm(dst, E[cur], E[cur], d, false, sm);
            }
            cur ^= 1;
        }
    }
}

// Ask the L2 for the d x d matrix at `M` (one 128-byte line per thread):
// the scans issue this for the NEXT step's propagator, whose address does
// not depend on the state, so its device-memory latency overlaps this
// step's arithmetic and barrier.
__device__ __forceinline__ void prefetch_matrix_l2(const float2* M, int d) {
    const size_t bytes = (size_t)d * d * sizeof(float2);
    const char* base = reinterpret_cast<const char*>(M);
    for (size_t off = (size_t)threadIdx.x * 128; off < bytes;
         off += (size_t)blockDim.x * 128) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(base + off));
    }
}

__device__ __forceinline__ float2 cmul_acc(float2 acc, float2 u, float2 v) {
    acc.x = fmaf(u.x, v.x, acc.x);
    acc.x = fmaf(-u.y, v.y, acc.x);
    acc.y = fmaf(u.x, v.y, acc.y);
    acc.y = fmaf(u.y, v.x, acc.y);
    return acc;
}

// storage[0] = psi0; storage[n+1][k] = U_n psi_k(t_n)
__global__ void __launch_bounds__(kScanThreads, 1)
forward_apply_kernel(const float2* __restrict__ U,
                     const float2* __restrict__ psi0, float2* storage,
                     int N_T, int K, int d) {
    extern __shared__ float2 smem[];
    float2* cur = smem;             // (kKB, d)
    float2* nxt = smem + kKB * d;   // (kKB, d)
    const int tid = threadIdx.x;
    const int sub = tid & 7;    // lane within its 8-lane row group
    const int grp = tid >> 3;   // row group
    const int n_groups = kScanThreads / 8;
    const int k0 = blockIdx.x * kKB;
    const int kn = min(kKB, K - k0);

    for (int idx = tid; idx < kKB * d; idx += kScanThreads) {
        const int k = idx / d;
        cur[idx] = (k < kn) ? psi0[(size_t)k0 * d + idx]
                            : make_float2(0.f, 0.f);
    }
    __syncthreads();

    for (int n = 0; n <= N_T; ++n) {
        // the state entering step n is storage[n] (coalesced write)
        for (int idx = tid; idx < kn * d; idx += kScanThreads) {
            storage[((size_t)n * K + k0) * d + idx] = cur[idx];
        }
        if (n == N_T) break;
        const float2* Un = U + (size_t)n * d * d;
        if (n + 1 < N_T) prefetch_matrix_l2(Un + (size_t)d * d, d);
        // 8 lanes per row of U: 64-byte coalesced segments, 3 shuffle
        // steps; the row loop is uniform across the warp so that the
        // full-mask shuffles are always executed by all 32 lanes
        for (int r0 = 0; r0 < d; r0 += n_groups) {
            const int r = r0 + grp;
            const bool valid = r < d;
            float2 acc[kKB];
#pragma unroll
            for (int k = 0; k < kKB; ++k) acc[k] = make_float2(0.f, 0.f);
            if (valid) {
                for (int c = sub; c < d; c += 8) {
                    const float2 u = Un[(size_t)r * d + c];
#pragma unroll
                    for (int k = 0; k < kKB; ++k) {
                        acc[k] = cmul_acc(acc[k], u, cur[k * d + c]);
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < kKB; ++k) {
#pragma unroll
                for (int off = 4; off > 0; off >>= 1) {
                    acc[k].x += __shfl_xor_sync(0xffffffffu, acc[k].x, off);
                    acc[k].y += __shfl_xor_sync(0xffffffffu, acc[k].y, off);
                }
            }
            if (valid && sub == 0) {
#pragma unroll
                for (int k = 0; k < kKB; ++k) nxt[k * d + r] = acc[k];
            }
        }
        __syncthreads();
        float2* t = cur;
        cur = nxt;
        nxt = t;
    }
}

// chis[n] = chi(t_{n+1}) for n = N_T-1 .. 0, with chi <- chi conj(U_n)
// between two emissions (row-vector form of U_n^dagger chi).
__global__ void __launch_bounds__(kScanThreads, 1)
chi_scan_kernel(const float2* __restrict__ U,
                const float2* __restrict__ chi_hat, float2* chis, int N_T,
                int K, int d) {
    extern __shared__ float2 smem[];
    float2* cur = smem;                 // (kKB, d)
    float2* partial = smem + kKB * d;   // (kRowGroups, kKB, d)
    const int tid = threadIdx.x;
    const int group_threads = kScanThreads / kRowGroups;  // 128
    const int rg = tid / group_threads;
    const int ci = tid % group_threads;
    const int k0 = blockIdx.x * kKB;
    const int kn = min(kKB, K - k0);

    for (int idx = tid; idx < kKB * d; idx += kScanThreads) {
        const int k = idx / d;
        cur[idx] = (k < kn) ? chi_hat[(size_t)k0 * d + idx]
                            : make_float2(0.f, 0.f);
    }
    __syncthreads();

    for (int n = N_T - 1; n >= 0; --n) {
        for (int idx = tid; idx < kn * d; idx += kScanThreads) {
            chis[((size_t)n * K + k0) * d + idx] = cur[idx];
        }
        if (n == 0) break;  // the update past t_1 is never consumed
        const float2* Un = U + (size_t)n * d * d;
        if (n > 1) prefetch_matrix_l2(Un - (size_t)d * d, d);
        for (int c = ci; c < d; c += group_threads) {
            float2 acc[kKB];
#pragma unroll
            for (int k = 0; k < kKB; ++k) acc[k] = make_float2(0.f, 0.f);
            for (int r = rg; r < d; r += kRowGroups) {
                float2 u = Un[(size_t)r * d + c];
                u.y = -u.y;  // conj(U)
#pragma unroll
                for (int k = 0; k < kKB; ++k) {
                    acc[k] = cmul_acc(acc[k], cur[k * d + r], u);
                }
            }
#pragma unroll
            for (int k = 0; k < kKB; ++k) {
                partial[(rg * kKB + k) * d + c] = acc[k];
            }
        }
        __syncthreads();
        for (int idx = tid; idx < kKB * d; idx += kScanThreads) {
            float2 sum = make_float2(0.f, 0.f);
#pragma unroll
            for (int g = 0; g < kRowGroups; ++g) {
                const float2 p = partial[g * kKB * d + idx];
                sum.x += p.x;
                sum.y += p.y;
            }
            cur[idx] = sum;
        }
        __syncthreads();
    }
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace grape

extern "C" {

int grape_propagator_scratch_matrices() { return grape::kPropScratch; }

const char* grape_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// U[n] = exp(-i dt_n H_n), n < N_T.  `scratch` holds n_blocks *
// grape_propagator_scratch_matrices() complex d x d matrices.
int grape_propagators(const void* H0, const void* ops, const void* coeffs,
                      const void* dts, int T, int d, int N_T, int s,
                      void* scratch, int n_blocks, void* U, void* stream) {
    cudaGetLastError();
    grape::propagator_kernel<<<n_blocks, grape::kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float2*)H0, (const float2*)ops, (const float*)coeffs,
        (const float*)dts, T, d, N_T, s, (float2*)scratch, (float2*)U);
    return (int)cudaGetLastError();
}

int grape_forward_apply(const void* U, const void* psi0, void* storage,
                        int N_T, int K, int d, void* stream) {
    cudaGetLastError();
    const size_t smem = (size_t)2 * grape::kKB * d * sizeof(float2);
    cudaError_t err = grape::allow_smem(grape::forward_apply_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (K + grape::kKB - 1) / grape::kKB;
    grape::forward_apply_kernel<<<blocks, grape::kScanThreads, smem,
                                  (cudaStream_t)stream>>>(
        (const float2*)U, (const float2*)psi0, (float2*)storage, N_T, K, d);
    return (int)cudaGetLastError();
}

int grape_chi_scan(const void* U, const void* chi_hat, void* chis, int N_T,
                   int K, int d, void* stream) {
    cudaGetLastError();
    const size_t smem =
        (size_t)(1 + grape::kRowGroups) * grape::kKB * d * sizeof(float2);
    cudaError_t err = grape::allow_smem(grape::chi_scan_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (K + grape::kKB - 1) / grape::kKB;
    grape::chi_scan_kernel<<<blocks, grape::kScanThreads, smem,
                             (cudaStream_t)stream>>>(
        (const float2*)U, (const float2*)chi_hat, (float2*)chis, N_T, K, d);
    return (int)cudaGetLastError();
}

}  // extern "C"
