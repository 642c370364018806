// One order of the time-vectorized Taylor backward recursion in a single
// launch, with each step's generator formed on the fly from the static
// operators.
//
// Replaces no TPU kernel: the JAX package runs this pass as XLA einsums
// (grape_tpu/fg.py _backward_vectorized), and so did the port through
// cuBLAS until this kernel (fg._backward_vectorized, the static-operator
// branch: every order applied all T + 1 operators to every vector, then
// combined them with the per-step coefficients).
//
// What it computes.  Per step n, generator group g (trajectories
// k = g GS .. g GS + GS - 1) and order m, with A_n = H_n^dagger / h,
// H_n = H0 + sum_t c[n, t] Op_t (real c), and mu_nl^dagger =
// sum_t dM[n, t, l] Op_t^dagger:
//
//   P_t       = Op_t^dagger Hm_m[n, k]                (t = 1..T)
//   Hm_{m+1}  = A_n Hm_m[n, k]                         (unless last)
//   phi_m     = A_n phi_{m-1}[n, k, l] + sum_t dM[n, t, l] P_t
//   acc      += coef[n] phi_m
//
// where Hm_m = A_n^{m-1} chi and coef[n] = (i dt_n h)^m / m!.  The Hm
// chain runs one order ahead of phi, so that the mu^dagger products of
// this order's phi read this launch's input, not its output: one launch
// an order.  The first order (first = 1) has no phi input: phi_1 =
// mu^dagger chi, acc = coef phi_1.
//
// Work per row, step and contraction index: T complex-by-real FMAs to form
// the entry of H_n^dagger (the coefficients are real), GS L complex FMAs
// with phi, GS with Hm and T GS with the operators: 304 flops at GS = L =
// T = 4 against the 288 the recursion needs; the static-operator einsums
// did 5 x 20 + 4 x 4 = 116 complex products, 928 flops.
//
// Design for the card:
//   - a CTA owns kBM = 64 rows and 8 steps of one group; 8 warps, each 16
//     row slots (2 rows each) x 2 steps; a thread keeps all its sums in
//     registers: 2 GS (L + 1 + T) complex values (72 at GS = L = T = 4,
//     254 registers in all, so one CTA an SM);
//   - the contraction runs in chunks of 16 columns staged by cp.async in
//     three shared buffers: the T + 1 operator tiles of the CTA's rows,
//     read in their stored layout (row j of Op_t holds column j of
//     Op_t^dagger, so the conjugate transpose is taken on load: no
//     transposed copies), and the chunk of every input vector of the
//     CTA's steps.  One operator value serves the thread's GS (L + 1 + T)
//     columns; one vector value serves its 2 rows;
//   - tiles run with the step block fastest, so the CTAs that share a row
//     block run together and read its operator rows from L2 (the T + 1
//     operators are 42 MB at d = 1024, near the 50 MB L2);
//   - the last wave: where the tiles are a whole number of waves and
//     `rest` more (208 = 132 + 76 at the dim-1024 CZ), the first tiles run
//     whole and each of the rest is split into kparts ranges of the
//     contraction (5 there: 380 CTAs, 3 waves of a fifth instead of one
//     wave of whole tiles that leaves 56 SMs idle).  Each part writes its
//     partial sums to a workspace, and the tile's last CTA to arrive (an
//     atomic count) adds the parts in their order 0, 1, .. and runs the
//     epilogue, so the result does not depend on which CTA finishes last;
//   - the first order, which has no phi input, is its own instantiation
//     (no branch in the inner loop);
//   - ragged edges (d not a multiple of the row tile or the chunk, N not a
//     multiple of 8) are zero-filled on load and masked on store.  d is
//     even, so that every row starts on 16 bytes (the route's condition).
//
// Bound: operations.  At d = 1024, N = 100, GS = L = T = 4 an order needs
// 30.2 GFLOP (31.9 done), 0.45 ms at 67 TFLOP/s; its device traffic is the
// operators (42 MB, from L2 for all but the first CTAs of a row block), the
// vectors, outputs and sums (about 60 MB) and the split tiles' partial sums
// (56 MB each way), 0.06 ms at 3.35 TB/s.  Measured on an H100 SXM (700 W):
// 0.87 ms an order, 52% of the bound.  The inner loop is 1216 FFMAs in 1287
// instructions; the copies cost about a tenth (0.80 ms with them left
// out), the last wave a tenth more (whole tiles: 1.03 ms); shared-memory
// bandwidth does not bind (broadcasting every load changed nothing).

// Full float32 FMAs: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace grape {
namespace torder {

constexpr int kThreads = 256;
constexpr int kBK = 16;          // contraction columns per chunk
constexpr int kSteps = 8;        // steps per CTA
constexpr int kSlots = 16;       // row slots per warp
constexpr int kWarpRows = 2;     // warps along the rows
constexpr int kRows = 2;         // rows a thread owns
constexpr int kBM = kWarpRows * kSlots * kRows;  // rows per CTA
constexpr int kStages = 3;       // shared buffers in flight

struct Args {
    const float2* H0;       // (G, d, d)
    const float2* ops;      // (G, T, d, d)
    const float* coeffs;    // (N, T) or, per trajectory, (G, N, T)
    const float* dM;        // (N, T, L) or (G, N, T, L)
    const float2* coef;     // (N,) this order's series coefficients
    const float2* phi_in;   // (N, K, L, d); unused at the first order
    const float2* hm_in;    // (N, K, d)
    float2* phi_out;        // (N, K, L, d)
    float2* hm_out;         // (N, K, d); unused unless write_hm
    float2* acc;            // (N, K, L, d), read after the first order
    float2* ws;             // partial sums of the split tiles
    int* counters;          // one per split tile, zero between launches
    int d, N, G, K, per, write_hm;
    int step_blocks, row_blocks;  // tiles: step block fastest, then rows, g
    int full;                // tiles whole; the rest split into kparts
    int kparts, chunks_per_part;
    float inv_h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// acc += conj(a) b
__device__ __forceinline__ void cmac_conj(float2& acc, float2 a, float2 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(-a.y, b.x, acc.y);
}

// Two complex values (16 bytes) of `src`, or zeros where not `ok` (then
// nothing is read, from the valid address `safe`).
__device__ __forceinline__ void load_pair(float2* dst, const float2* src,
                                          bool ok, const float2* safe) {
    cp16(dst, ok ? src : safe, ok);
}

template <int GS, int L, int T>
struct Plan {
    static constexpr int kPhi = GS * L;
    static constexpr int kCol = kPhi + GS;
    static constexpr int kOpsTile = kBK * kBM;            // float2
    static constexpr int kVecStride = kCol * kBK + 2;      // float2, padded
    static constexpr int kStage = (T + 1) * kOpsTile + kSteps * kVecStride;
    static constexpr int kSums = kRows * (kPhi + GS + T * GS);  // float2
    static constexpr size_t kSmem = sizeof(float2) * (size_t)kStages * kStage;
};

// One chunk of the contraction into a shared buffer: the T + 1 operator
// tiles (rows k0 .. k0 + 15 of H0 and of each Op_t, i.e. columns of their
// conjugate transposes, at the CTA's row0 .. row0 + kBM - 1) and the chunk
// of each vector of the CTA's steps, phi first (not at the first order),
// then Hm.  A warp copies rows warp and warp + 8 of each operator tile,
// lane l the 16 bytes at columns row0 + 2 l, + 1.
template <int GS, int L, int T, bool FIRST>
__device__ __forceinline__ void load_stage(const Args& a, float2* st, int g,
                                           int row0, int step0, int k0) {
    using P = Plan<GS, L, T>;
    static_assert(kBK * kBM / 2 == 2 * kThreads, "a tile: two copies each");
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int d = a.d;
    const long long dd = (long long)d * d;
    const int col = row0 + 2 * lane;
#pragma unroll
    for (int t = 0; t <= T; ++t) {
        const float2* plane =
            t == 0 ? a.H0 + g * dd : a.ops + (g * T + (t - 1)) * dd;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int j = k0 + warp + 8 * hh;
            load_pair(st + (t * kBK + warp + 8 * hh) * kBM + 2 * lane,
                      plane + (long long)j * d + col, j < d && col < d,
                      a.hm_in);
        }
    }
    float2* vs = st + (T + 1) * P::kOpsTile;
    constexpr int kPairs = kBK / 2;
    constexpr int kC0 = FIRST ? P::kPhi : 0;
    constexpr int kCols = P::kCol - kC0;
    constexpr int kItems = kSteps * kCols * kPairs;
    // not unrolled: the copies' addresses would take registers that the
    // sums need
#pragma unroll 1
    for (int q = tid; q < kItems; q += kThreads) {
        const int jp = q % kPairs;
        const int sc = q / kPairs;
        const int s = sc / kCols;
        const int c = kC0 + (sc - s * kCols);
        const int n = step0 + s;
        const int jcol = k0 + 2 * jp;
        const long long nk = (long long)n * a.K + g * GS;
        // phi rows (n, k, l) of the group are consecutive: (n K + g GS) L + c
        const float2* src = c < P::kPhi
            ? a.phi_in + (nk * L + c) * d + jcol
            : a.hm_in + (nk + (c - P::kPhi)) * d + jcol;
        load_pair(vs + s * P::kVecStride + c * kBK + 2 * jp, src,
                  n < a.N && jcol < d, a.hm_in);
    }
}

template <int GS, int L, int T, bool FIRST>
__global__ void __launch_bounds__(kThreads, 1)
taylor_order_kernel(const Args a) {
    using P = Plan<GS, L, T>;
    extern __shared__ __align__(16) float2 smem[];
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp % kWarpRows, wn = warp / kWarpRows;
    const int slot = lane & (kSlots - 1), sp = lane >> 4;
    // this CTA's tile and range of the contraction: the first `full`
    // tiles whole, each later tile in kparts consecutive CTAs
    int tile, part = 0, nparts = 1;
    if ((int)blockIdx.x < a.full) {
        tile = blockIdx.x;
    } else {
        const int q = blockIdx.x - a.full;
        tile = a.full + q / a.kparts;
        part = q - (tile - a.full) * a.kparts;
        nparts = a.kparts;
    }
    const int sb = tile % a.step_blocks;
    const int rb = (tile / a.step_blocks) % a.row_blocks;
    const int g = tile / (a.step_blocks * a.row_blocks);
    const int row0 = rb * kBM;
    const int step0 = sb * kSteps;
    const int s_loc = wn * 2 + sp;                  // this thread's step
    const int r_loc = wm * kSlots * kRows + slot * kRows;  // its first row
    const int n = step0 + s_loc;
    const int d = a.d;

    // this step's real coefficients
    float c[T];
    {
        const int nn = n < a.N ? n : 0;
        const float* cp = a.coeffs +
            ((a.per ? (long long)g * a.N : 0) + nn) * T;
#pragma unroll
        for (int t = 0; t < T; ++t) c[t] = __ldg(cp + t);
    }

    float2 Y[kRows][P::kPhi];
    float2 Q[kRows][GS];
    float2 Pt[kRows][T][GS];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int i = 0; i < P::kPhi; ++i) Y[r][i] = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < GS; ++k) {
            Q[r][k] = make_float2(0.f, 0.f);
#pragma unroll
            for (int t = 0; t < T; ++t) Pt[r][t][k] = make_float2(0.f, 0.f);
        }
    }

    const int n_chunks = (d + kBK - 1) / kBK;
    const int kc_begin = nparts > 1 ? part * a.chunks_per_part : 0;
    const int kc_end =
        nparts > 1 ? min(n_chunks, kc_begin + a.chunks_per_part) : n_chunks;
    const int nk = max(0, kc_end - kc_begin);

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk)
            load_stage<GS, L, T, FIRST>(a, smem + s * P::kStage, g, row0,
                                        step0, (kc_begin + s) * kBK);
        cp_commit();
    }

    for (int it = 0; it < nk; ++it) {
        cp_wait<kStages - 2>();
        __syncthreads();
        {
            const int nxt = it + kStages - 1;
            if (nxt < nk)
                load_stage<GS, L, T, FIRST>(
                    a, smem + (nxt % kStages) * P::kStage, g, row0, step0,
                    (kc_begin + nxt) * kBK);
            cp_commit();
        }
        const float2* st = smem + (it % kStages) * P::kStage;
        const float2* vs = st + (T + 1) * P::kOpsTile + s_loc * P::kVecStride;
#pragma unroll 2
        for (int jp = 0; jp < kBK / 2; ++jp) {
            // the operators' entries at (row, j) and (row, j + 1), rows
            // r_loc, r_loc + 1, and the generator's, formed
            float2 o[T + 1][kRows][2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
#pragma unroll
                for (int t = 0; t <= T; ++t) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        st + (t * kBK + 2 * jp + q) * kBM + r_loc);
                    o[t][0][q] = make_float2(v.x, v.y);
                    o[t][1][q] = make_float2(v.z, v.w);
                }
            }
            float2 h[kRows][2];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    float2 x = o[0][r][q];
#pragma unroll
                    for (int t = 0; t < T; ++t) {
                        x.x = fmaf(c[t], o[t + 1][r][q].x, x.x);
                        x.y = fmaf(c[t], o[t + 1][r][q].y, x.y);
                    }
                    h[r][q] = x;
                }
            }
            if (!FIRST) {
#pragma unroll
                for (int i = 0; i < P::kPhi; ++i) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(vs + i * kBK + 2 * jp);
                    const float2 v0 = make_float2(v.x, v.y);
                    const float2 v1 = make_float2(v.z, v.w);
#pragma unroll
                    for (int r = 0; r < kRows; ++r) {
                        cmac_conj(Y[r][i], h[r][0], v0);
                        cmac_conj(Y[r][i], h[r][1], v1);
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < GS; ++k) {
                const float4 v = *reinterpret_cast<const float4*>(
                    vs + (P::kPhi + k) * kBK + 2 * jp);
                const float2 v0 = make_float2(v.x, v.y);
                const float2 v1 = make_float2(v.z, v.w);
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    cmac_conj(Q[r][k], h[r][0], v0);
                    cmac_conj(Q[r][k], h[r][1], v1);
#pragma unroll
                    for (int t = 0; t < T; ++t) {
                        cmac_conj(Pt[r][t][k], o[t + 1][r][0], v0);
                        cmac_conj(Pt[r][t][k], o[t + 1][r][1], v1);
                    }
                }
            }
        }
    }
    cp_wait<0>();

    if (nparts > 1) {
        // partial sums to the workspace; the tile's last CTA to arrive adds
        // them in the order of the parts
        __shared__ int s_last;
        const int split = tile - a.full;
        float2* w = a.ws + ((long long)split * a.kparts + part) * P::kSums *
                               kThreads + tid;
        int idx = 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int i = 0; i < P::kPhi; ++i) w[(idx++) * kThreads] = Y[r][i];
#pragma unroll
            for (int k = 0; k < GS; ++k) {
                w[(idx++) * kThreads] = Q[r][k];
#pragma unroll
                for (int t = 0; t < T; ++t)
                    w[(idx++) * kThreads] = Pt[r][t][k];
            }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) {
            const int prev = atomicAdd(a.counters + split, 1);
            s_last = prev == a.kparts - 1;
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int i = 0; i < P::kPhi; ++i) Y[r][i] = make_float2(0.f, 0.f);
#pragma unroll
            for (int k = 0; k < GS; ++k) {
                Q[r][k] = make_float2(0.f, 0.f);
#pragma unroll
                for (int t = 0; t < T; ++t)
                    Pt[r][t][k] = make_float2(0.f, 0.f);
            }
        }
        for (int p = 0; p < a.kparts; ++p) {
            const float2* wp = a.ws + ((long long)split * a.kparts + p) *
                                          P::kSums * kThreads + tid;
            int j = 0;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
                for (int i = 0; i < P::kPhi; ++i) {
                    const float2 v = __ldcg(wp + (j++) * kThreads);
                    Y[r][i].x += v.x;
                    Y[r][i].y += v.y;
                }
#pragma unroll
                for (int k = 0; k < GS; ++k) {
                    float2 v = __ldcg(wp + (j++) * kThreads);
                    Q[r][k].x += v.x;
                    Q[r][k].y += v.y;
#pragma unroll
                    for (int t = 0; t < T; ++t) {
                        v = __ldcg(wp + (j++) * kThreads);
                        Pt[r][t][k].x += v.x;
                        Pt[r][t][k].y += v.y;
                    }
                }
            }
        }
        if (tid == 0) a.counters[split] = 0;
    }

    // epilogue: Hm_{m+1}, phi_m and the sum, for this thread's rows
    if (n >= a.N) return;
    const float inv_h = a.inv_h;
    const float2 cf = a.coef[n];
    float dm[T][L];
    {
        const float* src = a.dM + ((a.per ? (long long)g * a.N : 0) + n) *
                                      (T * L);
#pragma unroll
        for (int t = 0; t < T; ++t) {
#pragma unroll
            for (int l = 0; l < L; ++l) dm[t][l] = __ldg(src + t * L + l);
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int i = row0 + r_loc + r;
        if (i >= d) continue;
#pragma unroll
        for (int kk = 0; kk < GS; ++kk) {
            const long long nk_row = (long long)n * a.K + g * GS + kk;
            if (a.write_hm)
                a.hm_out[nk_row * d + i] =
                    make_float2(Q[r][kk].x * inv_h, Q[r][kk].y * inv_h);
#pragma unroll
            for (int l = 0; l < L; ++l) {
                float2 ph = FIRST ? make_float2(0.f, 0.f)
                                  : make_float2(Y[r][kk * L + l].x * inv_h,
                                                Y[r][kk * L + l].y * inv_h);
#pragma unroll
                for (int t = 0; t < T; ++t) {
                    ph.x = fmaf(dm[t][l], Pt[r][t][kk].x, ph.x);
                    ph.y = fmaf(dm[t][l], Pt[r][t][kk].y, ph.y);
                }
                const long long at = (nk_row * L + l) * d + i;
                a.phi_out[at] = ph;
                float2 ac = FIRST ? make_float2(0.f, 0.f) : a.acc[at];
                ac.x = fmaf(cf.x, ph.x, fmaf(-cf.y, ph.y, ac.x));
                ac.y = fmaf(cf.x, ph.y, fmaf(cf.y, ph.x, ac.y));
                a.acc[at] = ac;
            }
        }
    }
}

template <int GS, int L, int T>
cudaError_t launch(const Args& a, bool first, cudaStream_t stream) {
    const size_t smem = Plan<GS, L, T>::kSmem;
    const int tiles = a.step_blocks * a.row_blocks * a.G;
    const dim3 grid(a.full + (tiles - a.full) * a.kparts);
    cudaError_t err;
    if (first) {
        err = cudaFuncSetAttribute(
            taylor_order_kernel<GS, L, T, true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        taylor_order_kernel<GS, L, T, true><<<grid, kThreads, smem, stream>>>(
            a);
    } else {
        err = cudaFuncSetAttribute(
            taylor_order_kernel<GS, L, T, false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        taylor_order_kernel<GS, L, T, false>
            <<<grid, kThreads, smem, stream>>>(a);
    }
    return cudaGetLastError();
}

// the instantiated layouts: (GS, L, T)
#define GRAPE_TAYLOR_LAYOUTS(X) \
    X(4, 4, 4)                  \
    X(2, 4, 4)                  \
    X(1, 4, 4)                  \
    X(4, 3, 3)                  \
    X(2, 3, 3)                  \
    X(1, 3, 3)                  \
    X(4, 2, 2)                  \
    X(2, 2, 2)                  \
    X(1, 2, 2)                  \
    X(4, 1, 1)                  \
    X(2, 1, 1)                  \
    X(1, 1, 1)

}  // namespace torder
}  // namespace grape

extern "C" {

// Shared bytes and partial sums (complex values a thread) of the layout
// (gs, L, T): out[0] = smem bytes, out[1] = sums a thread; nonzero where
// the layout is not built.
int grape_taylor_order_plan(int gs, int L, int T, int* out) {
    using namespace grape::torder;
#define GRAPE_TAYLOR_PLAN(GS_, L_, T_)                     \
    if (gs == GS_ && L == L_ && T == T_) {                 \
        out[0] = (int)Plan<GS_, L_, T_>::kSmem;            \
        out[1] = Plan<GS_, L_, T_>::kSums;                 \
        return 0;                                          \
    }
    GRAPE_TAYLOR_LAYOUTS(GRAPE_TAYLOR_PLAN)
#undef GRAPE_TAYLOR_PLAN
    return (int)cudaErrorInvalidValue;
}

// One order (see the note at the top).  The first `full` tiles run whole;
// each later one is split into kparts ranges of the contraction, whose
// partial sums go through ws (kparts x sums x 256 complex values a split
// tile) and counters (an int a split tile, zero).
int grape_taylor_order(const void* H0, const void* ops, const void* coeffs,
                       const void* dM, const void* coef, const void* phi_in,
                       const void* hm_in, void* phi_out, void* hm_out,
                       void* acc, void* ws, void* counters, int d, int N,
                       int G, int gs, int L, int T, int per, int first,
                       int write_hm, int full, int kparts, float inv_h,
                       void* stream) {
    using namespace grape::torder;
    const int step_blocks = (N + kSteps - 1) / kSteps;
    const int row_blocks = (d + kBM - 1) / kBM;
    const int tiles = step_blocks * row_blocks * G;
    if (d < 2 || d % 2 != 0 || N < 1 || G < 1 || gs < 1 || kparts < 1 ||
        full < 0 ||
        full > tiles ||
        (full < tiles && kparts > 1 &&
         (ws == nullptr || counters == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    Args a;
    a.H0 = (const float2*)H0;
    a.ops = (const float2*)ops;
    a.coeffs = (const float*)coeffs;
    a.dM = (const float*)dM;
    a.coef = (const float2*)coef;
    a.phi_in = (const float2*)phi_in;
    a.hm_in = (const float2*)hm_in;
    a.phi_out = (float2*)phi_out;
    a.hm_out = (float2*)hm_out;
    a.acc = (float2*)acc;
    a.ws = (float2*)ws;
    a.counters = (int*)counters;
    a.d = d;
    a.N = N;
    a.G = G;
    a.K = G * gs;
    a.per = per;
    a.write_hm = write_hm;
    a.step_blocks = step_blocks;
    a.row_blocks = row_blocks;
    // a tile split into one part is whole
    a.full = kparts > 1 ? full : tiles;
    a.kparts = kparts;
    const int chunks = (d + kBK - 1) / kBK;
    a.chunks_per_part = (chunks + kparts - 1) / kparts;
    a.inv_h = inv_h;
    cudaStream_t s = (cudaStream_t)stream;
#define GRAPE_TAYLOR_LAUNCH(GS_, L_, T_)                       \
    if (gs == GS_ && L == L_ && T == T_) {                     \
        return (int)launch<GS_, L_, T_>(a, first != 0, s);     \
    }
    GRAPE_TAYLOR_LAYOUTS(GRAPE_TAYLOR_LAUNCH)
#undef GRAPE_TAYLOR_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
