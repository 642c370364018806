// Chebyshev-series propagation scan for ONE generator shared by K
// trajectories, forward (psi) or adjoint (the co-state chi), with a
// grid-wide barrier per term.  The ring kernel of cheby_ring.cu replaces
// it wherever its layout fits (hopper_cheby.cheby_route: up to 8 rows per
// SM, d <= 1056 on 132 SMs); this one takes the rest, up to the gate's
// CHEBY_MAX_DIM.
//
// Replaces the two TPU Pallas kernels of grape_tpu/ops/pallas_prop.py
//
//   cheby_scan_pallas_shared  (the operator planes resident in VMEM)
//   cheby_scan_pallas_stream  (the planes streamed per step in row blocks)
//
// which compute one function: per step n the normalised generator
// Hn = (2 H_n - shift I) / dE, H_n = H0 + sum_t c[n, t] Op_t, the
// n_cheby-term recursion phi_{m+1} = 2 Hn phi_m - phi_{m-1} on the (K, d)
// state block, acc = sum_m tab[n, m] phi_m, and the new state ph[n] acc.
// The adjoint walks the time axis backwards with Hn built from H^dagger and
// emits, for each step, the state ENTERING it (chis[n] = chi(t_{n+1})); the
// forward emits the state after each step.
//
// The TPU pair exists because Mosaic needs its sequential grid over N_T and
// a VMEM budget for the d x d planes (resident below it, streamed above).
// None of that carries over.  Here the work of one step, n_cheby - 1
// DEPENDENT matrix-vector products of a d x d matrix with K vectors, is
// split by ROWS across a persistent, co-resident grid:
//
//   - each block owns `rows` rows of Hn and forms them in its shared memory
//     at the start of every step from the T + 1 operator planes (row slices
//     of H0 and Op_t; for the adjoint the wrapper hands over conjugate-
//     transposed planes, so the block reads rows of H^dagger contiguously).
//     The planes (42 MB at d = 1024, T = 4) stay mostly in the 50 MB L2;
//   - per Chebyshev term every block computes its rows of 2 Hn phi - phi'
//     for all K trajectories, one warp per row and lanes along the row,
//     with phi staged through shared memory in tiles of up to kTileK
//     trajectories (read from L2 with ld.global.cg: other blocks wrote it);
//     the new rows go to a global ring of two (K, d) buffers, the running
//     sum acc and phi_{m-2} stay with the rows' owner;
//   - one grid-wide barrier (cooperative groups) per term that a later term
//     reads, and one at the end of each step after the new state is
//     written: n_cheby - 1 barriers per step.  A grid that cannot be
//     co-resident is refused at launch, never run.
//
// Bounds on this card: 8 K d^2 float32 operations per term against
// (T + 1) d^2 8 bytes of planes per step, so by operations for K >= 1 and
// the dependent barriers (about 2700 per direction at d = 1024, N_T = 100)
// at small K.  Full float32 FMAs, no tensor cores: the recursion compounds
// over n_cheby * N_T dependent products.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace grape {

constexpr int kChebyThreads = 256;
constexpr int kChebyWarps = kChebyThreads / 32;
constexpr int kTileK = 8;   // most trajectories of phi per shared tile
constexpr int kInFlight = 8;  // loads a thread keeps in flight

// dst[e] = src[e], e < n, from L2 (other blocks wrote src), each thread
// with kInFlight independent loads in flight
__device__ __forceinline__ void cheby_stage(float2* dst, const float2* src,
                                            int n) {
    for (int e0 = threadIdx.x; e0 < n; e0 += kChebyThreads * kInFlight) {
        float2 v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
            const int e = e0 + u * kChebyThreads;
            if (e < n) v[u] = __ldcg(src + e);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
            const int e = e0 + u * kChebyThreads;
            if (e < n) dst[e] = v[u];
        }
    }
}

__device__ __forceinline__ float2 cheby_cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__global__ void __launch_bounds__(kChebyThreads)
cheby_scan_kernel(const float2* __restrict__ planes,
                  const float* __restrict__ coeffs,
                  const float2* __restrict__ tab,
                  const float2* __restrict__ ph, float shift, float inv_dE,
                  const float2* __restrict__ psi0, int T, int d, int K,
                  int N_T, int n_cheby, int adjoint, int rows, int tile_k,
                  float2* ring, float2* acc, float2* out) {
    extern __shared__ float2 cheby_smem[];
    float2* Hs = cheby_smem;                       // rows x d
    float2* tile = cheby_smem + (size_t)rows * d;  // tile_k x d
    cg::grid_group grid = cg::this_grid();

    const int r0 = blockIdx.x * rows;
    const int nrows = min(rows, d - r0);  // >= 1 by the grid size
    const size_t Kd = (size_t)K * d;
    const size_t dd = (size_t)d * d;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int n_own = K * nrows;  // (k, row) pairs this block owns

    if (adjoint) {
        // chis[N_T - 1] = chi(T), the state entering the last step
        for (int e = tid; e < n_own; e += kChebyThreads) {
            const size_t idx = (size_t)(e / nrows) * d + r0 + e % nrows;
            out[(size_t)(N_T - 1) * Kd + idx] = psi0[idx];
        }
    }

    for (int step = 0; step < N_T; ++step) {
        const int n = adjoint ? N_T - 1 - step : step;
        const float2* state;
        float2* dest;
        if (adjoint) {
            state = (n == N_T - 1) ? psi0 : out + (size_t)n * Kd;
            dest = (n > 0) ? out + (size_t)(n - 1) * Kd : nullptr;
        } else {
            state = (n == 0) ? psi0 : out + (size_t)(n - 1) * Kd;
            dest = out + (size_t)n * Kd;
        }

        // this block's rows of Hn = (2 H_n - shift I) / dE
        const float* c = coeffs + (size_t)n * T;
        for (int r = 0; r < nrows; ++r) {
            const int i = r0 + r;
#pragma unroll 4
            for (int j = tid; j < d; j += kChebyThreads) {
                const size_t off = (size_t)i * d + j;
                float2 h = __ldg(planes + off);
                for (int t = 0; t < T; ++t) {
                    const float ct = __ldg(c + t);
                    const float2 o = __ldg(planes + (size_t)(t + 1) * dd + off);
                    h.x = fmaf(ct, o.x, h.x);
                    h.y = fmaf(ct, o.y, h.y);
                }
                float hr = 2.0f * h.x;
                if (i == j) hr -= shift;
                Hs[(size_t)r * d + j] = make_float2(hr * inv_dE,
                                                    2.0f * h.y * inv_dE);
            }
        }
        // acc = tab[n, 0] phi_0 on the own rows
        const float2 t0 = __ldg(tab + (size_t)n * n_cheby);
        for (int e = tid; e < n_own; e += kChebyThreads) {
            const size_t idx = (size_t)(e / nrows) * d + r0 + e % nrows;
            acc[idx] = cheby_cmul(t0, __ldcg(state + idx));
        }
        __syncthreads();

        for (int m = 1; m < n_cheby; ++m) {
            const float2* src = (m == 1) ? state : ring + ((m - 1) & 1) * Kd;
            float2* dst = ring + (m & 1) * Kd;
            // phi_{m-2} on the own rows: the state for m = 2, else the ring
            // slot this term overwrites (written by the same lane)
            const float2* prev = (m == 2) ? state : dst;
            const bool keep = m < n_cheby - 1;  // a later term reads phi_m
            const float2 cm = __ldg(tab + (size_t)n * n_cheby + m);
            for (int k0 = 0; k0 < K; k0 += tile_k) {
                const int kc = min(tile_k, K - k0);
                cheby_stage(tile, src + (size_t)k0 * d, kc * d);
                __syncthreads();
                for (int r = warp; r < nrows; r += kChebyWarps) {
                    // the owner's old values, loaded while the row is summed
                    const size_t idx = (size_t)(k0 + lane) * d + r0 + r;
                    float2 a = make_float2(0.f, 0.f);
                    float2 p2 = make_float2(0.f, 0.f);
                    if (lane < kc) {
                        a = acc[idx];
                        if (m >= 2) p2 = __ldcg(prev + idx);
                    }
                    float2 s[kTileK];
#pragma unroll
                    for (int q = 0; q < kTileK; ++q) s[q] = make_float2(0.f, 0.f);
                    const float2* hrow = Hs + (size_t)r * d;
                    for (int j = lane; j < d; j += 32) {
                        const float2 h = hrow[j];
#pragma unroll
                        for (int q = 0; q < kTileK; ++q) {
                            if (q < kc) {
                                const float2 p = tile[(size_t)q * d + j];
                                s[q].x = fmaf(h.x, p.x, s[q].x);
                                s[q].x = fmaf(-h.y, p.y, s[q].x);
                                s[q].y = fmaf(h.x, p.y, s[q].y);
                                s[q].y = fmaf(h.y, p.x, s[q].y);
                            }
                        }
                    }
                    float2 y = make_float2(0.f, 0.f);
#pragma unroll
                    for (int q = 0; q < kTileK; ++q) {
                        if (q < kc) {
#pragma unroll
                            for (int o = 16; o > 0; o >>= 1) {
                                s[q].x += __shfl_xor_sync(0xffffffffu, s[q].x, o);
                                s[q].y += __shfl_xor_sync(0xffffffffu, s[q].y, o);
                            }
                            if (q == lane) y = s[q];
                        }
                    }
                    if (lane < kc) {
                        if (m >= 2) {
                            y.x = 2.0f * y.x - p2.x;
                            y.y = 2.0f * y.y - p2.y;
                        }
                        a.x = fmaf(cm.x, y.x, fmaf(-cm.y, y.y, a.x));
                        a.y = fmaf(cm.x, y.y, fmaf(cm.y, y.x, a.y));
                        acc[idx] = a;
                        if (keep) dst[idx] = y;
                    }
                }
                __syncthreads();  // the next tile overwrites this one
            }
            if (keep) grid.sync();
        }

        // the new state on the own rows
        if (dest != nullptr) {
            const float2 p = __ldg(ph + n);
            for (int e = tid; e < n_own; e += kChebyThreads) {
                const size_t idx = (size_t)(e / nrows) * d + r0 + e % nrows;
                dest[idx] = cheby_cmul(p, acc[idx]);
            }
        }
        grid.sync();
    }
}

// rows per block, blocks, phi tile and shared bytes for (d, K) on the
// current device; cudaErrorInvalidValue when no layout fits
static cudaError_t cheby_layout(int d, int K, int* rows, int* blocks,
                                int* tile_k, size_t* smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int sms = 0, max_smem = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (d < 1 || K < 1 || sms < 1) return cudaErrorInvalidValue;
    *rows = (d + sms - 1) / sms;
    *blocks = (d + *rows - 1) / *rows;
    int tk = K < kTileK ? K : kTileK;
    const size_t row_bytes = (size_t)d * sizeof(float2);
    while (tk >= 1 && (size_t)(*rows + tk) * row_bytes > (size_t)max_smem) {
        --tk;
    }
    if (tk < 1) return cudaErrorInvalidValue;
    *tile_k = tk;
    *smem = (size_t)(*rows + tk) * row_bytes;
    return cudaSuccess;
}

}  // namespace grape

extern "C" {

// The layout the scan takes at (d, K): out4 = {rows per block, blocks,
// trajectories per phi tile, shared bytes per block}.
int grape_cheby_scan_layout(int d, int K, int* out4) {
    int rows, blocks, tile_k;
    size_t smem;
    cudaError_t err =
        grape::cheby_layout(d, K, &rows, &blocks, &tile_k, &smem);
    if (err != cudaSuccess) return (int)err;
    out4[0] = rows;
    out4[1] = blocks;
    out4[2] = tile_k;
    out4[3] = (int)smem;
    return 0;
}

// planes (T + 1, d, d): [H0, Op_1..Op_T] (forward) or their conjugate
// transposes (adjoint); coeffs (N_T, T) float; tab (N_T, n_cheby) and
// ph (N_T,) complex; psi0 (K, d); scratch (3, K, d) complex; out
// (N_T, K, d) complex.  cudaErrorCooperativeLaunchTooLarge if the grid
// cannot be co-resident.
int grape_cheby_scan(const void* planes, const void* coeffs, const void* tab,
                     const void* ph, float shift, float inv_dE,
                     const void* psi0, int T, int d, int K, int N_T,
                     int n_cheby, int adjoint, void* scratch, void* out,
                     void* stream) {
    cudaGetLastError();
    if (N_T < 1 || n_cheby < 2 || T < 0) return (int)cudaErrorInvalidValue;
    int rows, blocks, tile_k;
    size_t smem;
    cudaError_t err =
        grape::cheby_layout(d, K, &rows, &blocks, &tile_k, &smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(grape::cheby_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grape::cheby_scan_kernel, grape::kChebyThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if ((long long)per_sm * sms < blocks) {
        return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    const float2* pl = (const float2*)planes;
    const float* co = (const float*)coeffs;
    const float2* tb = (const float2*)tab;
    const float2* phs = (const float2*)ph;
    const float2* p0 = (const float2*)psi0;
    float2* ring = (float2*)scratch;
    float2* acc = ring + (size_t)2 * K * d;
    float2* o = (float2*)out;
    void* args[] = {(void*)&pl,   (void*)&co,     (void*)&tb,
                    (void*)&phs,  (void*)&shift,  (void*)&inv_dE,
                    (void*)&p0,   (void*)&T,      (void*)&d,
                    (void*)&K,    (void*)&N_T,    (void*)&n_cheby,
                    (void*)&adjoint, (void*)&rows, (void*)&tile_k,
                    (void*)&ring, (void*)&acc,    (void*)&o};
    err = cudaLaunchCooperativeKernel((void*)grape::cheby_scan_kernel,
                                      dim3(blocks), dim3(grape::kChebyThreads),
                                      args, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
