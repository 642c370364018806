// Fused rank-1 Frechet-trace gradient kernel, one generator per GROUP of
// gs contiguous trajectories (K = G * gs).
//
// Replaces the TPU Pallas kernels frechet_trace_pallas_shared (G = 1) and
// frechet_trace_pallas_pertraj (gs = 1, or gs > 1 in its grouped mode) of
// grape_tpu/ops/pallas_frechet.py:
//
//   trj[n, k, t] = tr(Op_gt * L(A_ng, R_nk)),   A_ng = -i dt_n H_ng,
//   R_nk[b, a] = psi_nk[b] * conj(chi_nk[a]),   g = k / gs
//
// with L(A, R) the Frechet derivative of expm at A in direction R, by the
// degree-16 Taylor polynomial (Paterson-Stockmeyer in A^4) at A / 2^s and s
// pair doublings.  Per item (step n, group g) the kernel forms the powers of
// A and the E history ONCE from group g's operators and group g's
// coefficient row, then for each of the group's gs directions the M-chain
// (M_{j+1} = A M_j + R A^j), the Horner recursion replaying the E history,
// the doublings L <- E_j L + L E_j with the ladder E_j = E^(2^j), and the T
// trace reductions with Op_gt; the (gs, d, d) Frechet factors never leave
// the block's scratch, only gs * T complex scalars per item are written out.
// The TPU kernel's budget gates do not exist here: no 128-lane padded
// output, no coefficient table in scalar memory, no lower or upper bound on
// d (matrices live in the scratch, products are tiled).
//
// Bound on this card: float32 FMA operations, (5 + s) + gs (12 + 2s)
// complex d^3 products per item against a few KB of input per item, with
// every item independent (no error compounds across steps, but full
// float32 is kept anyway: the Pallas kernel's reduced-precision "high"
// mode exists only because the TPU matrix unit has no float32 mode).
// That is this algorithm's count, carried over from the Pallas kernel.  The
// function needs far less: R has rank one, so L is a sum of outer products
// (A^i psi)(chi^dagger A^j) and needs only matrix-vector products until the
// doublings.  frechet_factored.cu computes it so, and the wrapper takes this
// kernel only where it needs fewer operations (tiny d, many doublings).
// Design: a persistent grid walks over the N_T * G items, one item per
// block at a time; the (14 + s) matrix working set (about 1.2 MB at d = 100)
// cannot live in the 227 KB of shared memory, so it sits in a per-block
// global scratch sized by the grid (not by N_T) and each product is tiled
// through shared memory (cmat.cuh).  At 33 FMA-flops per scratch byte the
// products stay compute-bound even when the scratch spills from L2.

#include "cmat.cuh"

namespace grape {

// scratch matrices: A, A2, A3, A4, Eh1, Eh2, Eh3, ladder[max(s,1)],
// R, M2, M3, M4, L0, L1
__host__ __device__ inline int frechet_scratch_matrices(int s) {
    return 7 + (s > 1 ? s : 1) + 6;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // red[] free from the previous use
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    return total;
}

__global__ void __launch_bounds__(kThreads, 2)
frechet_trace_kernel(const float2* __restrict__ H0,
                     const float2* __restrict__ ops,
                     const float* __restrict__ coeffs,
                     const float* __restrict__ dts,
                     const float2* __restrict__ psis,
                     const float2* __restrict__ chis, int T, int d, int N_T,
                     int K, int G, int gs, size_t coeff_group_stride, int s,
                     float2* scratch, float2* trj) {
    __shared__ GemmSmem sm;
    __shared__ float red[kThreads / 32];
    const size_t dd = (size_t)d * d;
    const int n_ladder = s > 1 ? s : 1;
    float2* base =
        scratch + (size_t)blockIdx.x * frechet_scratch_matrices(s) * dd;
    float2* A = base;
    float2* A2 = base + dd;
    float2* A3 = base + 2 * dd;
    float2* A4 = base + 3 * dd;
    float2* Eh[4] = {nullptr, base + 4 * dd, base + 5 * dd, base + 6 * dd};
    float2* ladder = base + 7 * dd;  // ladder[j] = E^(2^j), j < s
    float2* R = ladder + (size_t)n_ladder * dd;
    float2* M2 = R + dd;
    float2* M3 = R + 2 * dd;
    float2* M4 = R + 3 * dd;
    float2* Lb[2] = {R + 4 * dd, R + 5 * dd};
    const float scale = exp2f(-(float)s);
    const int tid = threadIdx.x;

    const size_t n_items = (size_t)N_T * G;
    for (size_t item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int n = (int)(item / G);
        const int g = (int)(item % G);
        const float2* ops_g = ops + (size_t)g * T * dd;
        // ---- base, shared by the gs directions of this item -------------
        build_generator(A, H0 + (size_t)g * dd, ops_g,
                        coeffs + (size_t)g * coeff_group_stride +
                            (size_t)n * T,
                        dts[n], scale, T, d);
        powers(A, A2, A3, A4, d, sm);
        // E history: the value of E BEFORE each Horner update.  Eh[0] is
        // the scalar block c16 * I and is never materialised.
        ps_block(Eh[1], 3, A, A2, A3, A4, d);
        ps_block(Eh[2], 2, A, A2, A3, nullptr, d);
        cgemm(Eh[2], A4, Eh[1], d, true, sm);
        ps_block(Eh[3], 1, A, A2, A3, nullptr, d);
        cgemm(Eh[3], A4, Eh[2], d, true, sm);
        if (s > 0) {
            ps_block(ladder, 0, A, A2, A3, nullptr, d);
            cgemm(ladder, A4, Eh[3], d, true, sm);
            for (int j = 1; j < s; ++j) {
                cgemm(ladder + (size_t)j * dd, ladder + (size_t)(j - 1) * dd,
                      ladder + (size_t)(j - 1) * dd, d, false, sm);
            }
        }

        for (int k = g * gs; k < (g + 1) * gs; ++k) {
            // ---- R = 2^-s psi chi^dagger --------------------------------
            const float2* psi = psis + ((size_t)n * K + k) * d;
            const float2* chi = chis + ((size_t)n * K + k) * d;
            for (int idx = tid; idx < d * d; idx += kThreads) {
                const float2 p = psi[idx / d];
                const float2 c = chi[idx % d];
                R[idx] = make_float2(scale * (p.x * c.x + p.y * c.y),
                                     scale * (p.y * c.x - p.x * c.y));
            }
            __syncthreads();
            // ---- M-chain: M1 = R, M_{j+1} = A M_j + R A^j ---------------
            cgemm(M2, A, R, d, false, sm);
            cgemm(M2, R, A, d, true, sm);
            cgemm(M3, A, M2, d, false, sm);
            cgemm(M3, R, A2, d, true, sm);
            cgemm(M4, A, M3, d, false, sm);
            cgemm(M4, R, A3, d, true, sm);
            // ---- Horner in A^4 for the Frechet factor -------------------
            // dblk_b = c_{4b+1} M1 + c_{4b+2} M2 + c_{4b+3} M3;
            // first update: dE = M4 (c16 I) + dblk_3 (exact as c16 * M4)
            int cur = 0;
            lincomb(Lb[cur], 0.f, c_fact_inv[16], M4, c_fact_inv[13], R,
                    c_fact_inv[14], M2, c_fact_inv[15], M3, d);
            for (int b = 2; b >= 0; --b) {
                float2* dst = Lb[cur ^ 1];
                cgemm(dst, M4, Eh[3 - b], d, false, sm);
                cgemm(dst, A4, Lb[cur], d, true, sm);
                // dst += dblk_b
                for (int idx = tid; idx < d * d; idx += kThreads) {
                    float2 o = dst[idx];
                    const float2 m1 = R[idx];
                    const float2 m2 = M2[idx];
                    const float2 m3 = M3[idx];
                    float br = c_fact_inv[4 * b + 1] * m1.x;
                    float bi = c_fact_inv[4 * b + 1] * m1.y;
                    br += c_fact_inv[4 * b + 2] * m2.x;
                    bi += c_fact_inv[4 * b + 2] * m2.y;
                    br += c_fact_inv[4 * b + 3] * m3.x;
                    bi += c_fact_inv[4 * b + 3] * m3.y;
                    o.x += br;
                    o.y += bi;
                    dst[idx] = o;
                }
                __syncthreads();
                cur ^= 1;
            }
            // ---- pair doublings: L <- E_j L + L E_j ---------------------
            for (int j = 0; j < s; ++j) {
                float2* dst = Lb[cur ^ 1];
                const float2* Ej = ladder + (size_t)j * dd;
                cgemm(dst, Ej, Lb[cur], d, false, sm);
                cgemm(dst, Lb[cur], Ej, d, true, sm);
                cur ^= 1;
            }
            // ---- traces: sum_ab Op_t[a, b] G[b, a] ----------------------
            const float2* G = Lb[cur];
            for (int t = 0; t < T; ++t) {
                const float2* Op = ops_g + (size_t)t * dd;
                float sr = 0.f;
                float si = 0.f;
                for (int idx = tid; idx < d * d; idx += kThreads) {
                    const int b = idx / d;
                    const int a = idx % d;
                    const float2 g = G[idx];          // G[b, a]
                    const float2 o = Op[a * d + b];   // Op_t[a, b]
                    sr += o.x * g.x - o.y * g.y;
                    si += o.x * g.y + o.y * g.x;
                }
                sr = block_sum(sr, red);
                si = block_sum(si, red);
                if (tid == 0) {
                    trj[((size_t)n * K + k) * T + t] = make_float2(sr, si);
                }
            }
            __syncthreads();
        }
    }
}

}  // namespace grape

extern "C" {

int grape_frechet_scratch_matrices(int s) {
    return grape::frechet_scratch_matrices(s);
}

// trj (N_T, K, T) complex64 with H0 (G, d, d), ops (G, T, d, d), K = G * gs
// and the coefficient row of (n, g) at
// coeffs[g * coeff_group_stride + n * T] (stride 0: one table for all
// groups).  `scratch` holds n_blocks * grape_frechet_scratch_matrices(s)
// complex d x d matrices.
int grape_frechet_trace(const void* H0, const void* ops, const void* coeffs,
                        const void* dts, const void* psis, const void* chis,
                        int T, int d, int N_T, int K, int G, int gs,
                        long long coeff_group_stride, int s, void* scratch,
                        int n_blocks, void* trj, void* stream) {
    cudaGetLastError();
    if (G < 1 || gs < 1 || G * gs != K) return (int)cudaErrorInvalidValue;
    grape::frechet_trace_kernel<<<n_blocks, grape::kThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const float2*)H0, (const float2*)ops, (const float*)coeffs,
        (const float*)dts, (const float2*)psis, (const float2*)chis, T, d,
        N_T, K, G, gs, (size_t)coeff_group_stride, s, (float2*)scratch,
        (float2*)trj);
    return (int)cudaGetLastError();
}

}  // extern "C"
