// Forward propagation and co-state chain for one generator per GROUP of
// trajectories: G groups of gs contiguous trajectories each, K = G * gs.
// G = 1 is the shared generator (gate optimization), gs = 1 one generator
// per trajectory (robust ensembles), anything between a gate ensemble.
//
// No shape takes these kernels by rule any more: the cluster kernels of
// prop_cluster.cu and state_scan.cu hold the shapes they fit, and past
// them (ops/hopper_prop.py propagator_route: d > 108; scan_route: from
// d = 417 at one group of 4 on 132 SMs) the wide propagator kernel of
// prop_wide.cu and the grid scans of state_grid.cu.  They run only where
// hopper_prop._forced_routes asks for them, as the kernels the new ones
// are timed and checked against.
//
// Replaces four TPU Pallas kernels of grape_tpu/ops/pallas_prop.py:
//
//   forward_scan_pallas_shared   (G = 1)   \
//   forward_scan_pallas_grouped  (gs > 1)   > propagator_kernel
//   forward_scan_pallas          (gs = 1)  /    + forward_apply_kernel
//   chi_scan_pallas_shared      ->  chi_scan_kernel (here with a group axis
//                                   too: the reference runs the grouped
//                                   chain as a scan of small products)
//
// The Pallas trio exists because a TPU grid is sequential and keeps one
// trajectory's (or group's) planes resident; here the N_T * G exponentials
// are independent items of one persistent grid, so one kernel serves all.
//
// The Pallas kernels lean on the TPU grid running its steps in order with
// the state carried in on-chip scratch.  On Hopper blocks run in parallel
// and only the state chains are sequential, so the forward scan is split:
//
//   (a) propagator_kernel: the N_T * G exponentials are independent.  A
//       persistent grid of blocks walks over the items (n, g); each block
//       forms A = -i dt_n 2^-s H_ng from group g's operators (and group
//       g's coefficient row, where the tables differ per group), the
//       degree-16 Taylor polynomial by Paterson-Stockmeyer in A^4, s
//       squarings, and writes U[n, g].  Bound by float32 FMA operations:
//       (6 + s) complex d^3 products per item and only d^2 bytes out.  The working set (A..A^4 and two E buffers,
//       480 KB at d = 100) does not fit shared memory, so it lives in a
//       per-block global scratch and products are tiled through shared
//       memory (cmat.cuh); the scratch is sized by the grid, not by N_T.
//   (b) forward_apply_kernel: psi <- psi U_ng^T, n = 0..N_T-1, inside one
//       block per chunk of up to 4 trajectories OF ONE GROUP (a block
//       reads one U per step, so it never straddles two groups), state
//       carried in shared memory.  Bound by reading U once
//       (N_T G d^2 8 bytes) and by the latency of N_T dependent steps;
//       eight lanes per row of U keep the loads coalesced in 64-byte
//       segments.
//
// chi_scan_kernel is (b) run backwards with conj(U): chi <- chi conj(U_n),
// emitting chi BEFORE each update (chis[n] = chi(t_{n+1})); on request it
// also applies U_0 and hands the co-state carried out of the window back,
// for a chain that is run window by window.  It reads U by
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
                  int G, size_t coeff_group_stride, int s, float2* scratch,
                  float2* U) {
    __shared__ GemmSmem sm;
    const size_t dd = (size_t)d * d;
    float2* base = scratch + (size_t)blockIdx.x * kPropScratch * dd;
    float2* A = base;
    float2* A2 = base + dd;
    float2* A3 = base + 2 * dd;
    float2* A4 = base + 3 * dd;
    float2* E[2] = {base + 4 * dd, base + 5 * dd};
    const float scale = exp2f(-(float)s);

    const size_t n_items = (size_t)N_T * G;
    for (size_t item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int n = (int)(item / G);
        const int g = (int)(item % G);
        build_generator(A, H0 + (size_t)g * dd, ops + (size_t)g * T * dd,
                        coeffs + (size_t)g * coeff_group_stride +
                            (size_t)n * T,
                        dts[n], scale, T, d);
        powers(A, A2, A3, A4, d, sm);
        // Horner in A^4, blocks b = 4 (the scalar c16), 3, 2, 1, 0; then s
        // squarings.  The last product writes straight into U[n, g].
        int cur = 0;
        ps_block(E[cur], 3, A, A2, A3, A4, d);
        const int n_ops = 3 + s;
        for (int op = 0; op < n_ops; ++op) {
            float2* dst = (op == n_ops - 1) ? U + item * dd : E[cur ^ 1];
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

// The trajectories one scan block carries: chunk `blockIdx.x % chunks` of
// group `blockIdx.x / chunks`, with chunks = ceil(gs / kKB).  A block reads
// ONE propagator per step, so it holds trajectories of one group only.
struct ScanChunk {
    int g;   // group
    int k0;  // first trajectory
    int kn;  // trajectories held (1..kKB)
};

__host__ __device__ inline int scan_chunks(int gs) {
    return (gs + kKB - 1) / kKB;
}

__device__ __forceinline__ ScanChunk scan_chunk(int gs) {
    const int chunks = scan_chunks(gs);
    ScanChunk c;
    c.g = blockIdx.x / chunks;
    const int j0 = (blockIdx.x % chunks) * kKB;
    c.k0 = c.g * gs + j0;
    c.kn = min(kKB, gs - j0);
    return c;
}

// storage[0] = psi0; storage[n+1][k] = U[n, g(k)] psi_k(t_n), K = G * gs
__global__ void __launch_bounds__(kScanThreads, 1)
forward_apply_kernel(const float2* __restrict__ U,
                     const float2* __restrict__ psi0, float2* storage,
                     int N_T, int K, int d, int G, int gs) {
    extern __shared__ float2 smem[];
    float2* cur = smem;             // (kKB, d)
    float2* nxt = smem + kKB * d;   // (kKB, d)
    const int tid = threadIdx.x;
    const int sub = tid & 7;    // lane within its 8-lane row group
    const int grp = tid >> 3;   // row group
    const int n_groups = kScanThreads / 8;
    const ScanChunk chunk = scan_chunk(gs);
    const int k0 = chunk.k0;
    const int kn = chunk.kn;
    const size_t dd = (size_t)d * d;

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
        const float2* Un = U + ((size_t)n * G + chunk.g) * dd;
        if (n + 1 < N_T) prefetch_matrix_l2(Un + (size_t)G * dd, d);
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

// chis[n] = chi(t_{n+1}) for n = N_T-1 .. 0, with chi <- chi conj(U[n, g])
// between two emissions (row-vector form of U^dagger chi).  With chi_out
// the update by U[0, g] is applied too and its result written there: the
// co-state carried out of this window of steps.
__global__ void __launch_bounds__(kScanThreads, 1)
chi_scan_kernel(const float2* __restrict__ U,
                const float2* __restrict__ chi_hat, float2* chis,
                float2* chi_out, int N_T, int K, int d, int G, int gs) {
    extern __shared__ float2 smem[];
    float2* cur = smem;                 // (kKB, d)
    float2* partial = smem + kKB * d;   // (kRowGroups, kKB, d)
    const int tid = threadIdx.x;
    const int group_threads = kScanThreads / kRowGroups;  // 128
    const int rg = tid / group_threads;
    const int ci = tid % group_threads;
    const ScanChunk chunk = scan_chunk(gs);
    const int k0 = chunk.k0;
    const int kn = chunk.kn;
    const size_t dd = (size_t)d * d;

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
        // the update past t_1 is consumed only by a caller that asked
        // for the carry
        if (n == 0 && chi_out == nullptr) break;
        const float2* Un = U + ((size_t)n * G + chunk.g) * dd;
        if (n > 0) prefetch_matrix_l2(Un - (size_t)G * dd, d);
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
    if (chi_out != nullptr) {
        for (int idx = tid; idx < kn * d; idx += kScanThreads) {
            chi_out[(size_t)k0 * d + idx] = cur[idx];
        }
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

// U[n, g] = exp(-i dt_n H_ng), n < N_T, g < G, with H0 (G, d, d),
// ops (G, T, d, d) and the coefficient row of (n, g) at
// coeffs[g * coeff_group_stride + n * T] (stride 0: one table for all
// groups).  `scratch` holds n_blocks * grape_propagator_scratch_matrices()
// complex d x d matrices.
int grape_propagators(const void* H0, const void* ops, const void* coeffs,
                      const void* dts, int T, int d, int N_T, int G,
                      long long coeff_group_stride, int s, void* scratch,
                      int n_blocks, void* U, void* stream) {
    cudaGetLastError();
    grape::propagator_kernel<<<n_blocks, grape::kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float2*)H0, (const float2*)ops, (const float*)coeffs,
        (const float*)dts, T, d, N_T, G, (size_t)coeff_group_stride, s,
        (float2*)scratch, (float2*)U);
    return (int)cudaGetLastError();
}

// U (N_T, G, d, d); K = G * gs trajectories, group-contiguous.
int grape_forward_apply(const void* U, const void* psi0, void* storage,
                        int N_T, int K, int d, int G, int gs,
                        void* stream) {
    cudaGetLastError();
    if (G < 1 || gs < 1 || G * gs != K) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)2 * grape::kKB * d * sizeof(float2);
    cudaError_t err = grape::allow_smem(grape::forward_apply_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = G * grape::scan_chunks(gs);
    grape::forward_apply_kernel<<<blocks, grape::kScanThreads, smem,
                                  (cudaStream_t)stream>>>(
        (const float2*)U, (const float2*)psi0, (float2*)storage, N_T, K, d,
        G, gs);
    return (int)cudaGetLastError();
}

// chi_out (K, d) or null, see chi_scan_kernel.
int grape_chi_scan(const void* U, const void* chi_hat, void* chis,
                   void* chi_out, int N_T, int K, int d, int G, int gs,
                   void* stream) {
    cudaGetLastError();
    if (G < 1 || gs < 1 || G * gs != K) return (int)cudaErrorInvalidValue;
    const size_t smem =
        (size_t)(1 + grape::kRowGroups) * grape::kKB * d * sizeof(float2);
    cudaError_t err = grape::allow_smem(grape::chi_scan_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = G * grape::scan_chunks(gs);
    grape::chi_scan_kernel<<<blocks, grape::kScanThreads, smem,
                             (cudaStream_t)stream>>>(
        (const float2*)U, (const float2*)chi_hat, (float2*)chis,
        (float2*)chi_out, N_T, K, d, G, gs);
    return (int)cudaGetLastError();
}

}  // extern "C"
