// The exponential of one small generator in registers, d <= 4: the
// arithmetic that both small-dimension scans share (smalld_scan.cu, the
// two-launch pair, and smalld_fused.cu, the fused scan), so that both give
// the same propagators bit for bit.
//
// smalld_propagator<D> forms H = H0_k + sum_t c[n,t] Op_kt,
// A = -i dt_n 2^-s H, the degree-16 Taylor polynomial by Paterson-Stockmeyer
// (A^2, A^3, A^4, Horner in A^4 over blocks of four coefficients; the
// scalar block c16 I enters as a scaling) and s squarings.  Full float32
// FMAs, complex products in the 4-multiply form.
#pragma once

#include <cuda_runtime.h>

namespace grape {

// 1/k! for k = 0..16 (this file's own copy: cmat.cuh brings the block-GEMM
// machinery that these kernels have no use for)
static __constant__ float c_smalld_fact_inv[17] = {
    (float)(1.0),
    (float)(1.0),
    (float)(1.0 / 2.0),
    (float)(1.0 / 6.0),
    (float)(1.0 / 24.0),
    (float)(1.0 / 120.0),
    (float)(1.0 / 720.0),
    (float)(1.0 / 5040.0),
    (float)(1.0 / 40320.0),
    (float)(1.0 / 362880.0),
    (float)(1.0 / 3628800.0),
    (float)(1.0 / 39916800.0),
    (float)(1.0 / 479001600.0),
    (float)(1.0 / 6227020800.0),
    (float)(1.0 / 87178291200.0),
    (float)(1.0 / 1307674368000.0),
    (float)(1.0 / 20922789888000.0),
};

__device__ __forceinline__ float2 cfma(float2 acc, float2 a, float2 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
    return acc;
}

// c = a b for D x D complex matrices in registers (c aliases neither)
template <int D>
__device__ __forceinline__ void cmm(const float2 (&a)[D * D],
                                    const float2 (&b)[D * D],
                                    float2 (&c)[D * D]) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int m = 0; m < D; ++m) {
                acc = cfma(acc, a[i * D + m], b[m * D + j]);
            }
            c[i * D + j] = acc;
        }
    }
}

// e += c0 I + c1 A + c2 A2 + c3 A3 with the coefficients of block b
template <int D>
__device__ __forceinline__ void add_ps_block(float2 (&e)[D * D], int b,
                                             const float2 (&A)[D * D],
                                             const float2 (&A2)[D * D],
                                             const float2 (&A3)[D * D]) {
    const float c0 = c_smalld_fact_inv[4 * b];
    const float c1 = c_smalld_fact_inv[4 * b + 1];
    const float c2 = c_smalld_fact_inv[4 * b + 2];
    const float c3 = c_smalld_fact_inv[4 * b + 3];
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
        float x = fmaf(c1, A[i].x, e[i].x);
        float y = fmaf(c1, A[i].y, e[i].y);
        x = fmaf(c2, A2[i].x, x);
        y = fmaf(c2, A2[i].y, y);
        x = fmaf(c3, A3[i].x, x);
        y = fmaf(c3, A3[i].y, y);
        if (i % (D + 1) == 0) x += c0;
        e[i] = make_float2(x, y);
    }
}

// E = exp(-i dt_n (H0_k + sum_t coeffs[n, t] ops[k, t])), H0 (K, D, D),
// ops (K, T, D, D), coeffs (N_T, T), dts (N_T,)
template <int D>
__device__ __forceinline__ void smalld_propagator(
    const float2* __restrict__ H0, const float2* __restrict__ ops,
    const float* __restrict__ coeffs, const float* __restrict__ dts, int T,
    int n, int k, int s, float2 (&E)[D * D]) {
    constexpr int DD = D * D;
    float2 A[DD], A2[DD], A3[DD], A4[DD];
    const float2* h0 = H0 + (size_t)k * DD;
#pragma unroll
    for (int i = 0; i < DD; ++i) A[i] = h0[i];
    for (int t = 0; t < T; ++t) {
        const float c = coeffs[(size_t)n * T + t];
        const float2* op = ops + ((size_t)k * T + t) * DD;
#pragma unroll
        for (int i = 0; i < DD; ++i) {
            const float2 o = op[i];
            A[i].x = fmaf(c, o.x, A[i].x);
            A[i].y = fmaf(c, o.y, A[i].y);
        }
    }
    // A = -i dt 2^-s H:  Ar = w Hi,  Ai = -w Hr
    const float w = dts[n] * exp2f(-(float)s);
#pragma unroll
    for (int i = 0; i < DD; ++i) {
        A[i] = make_float2(w * A[i].y, -w * A[i].x);
    }
    cmm<D>(A, A, A2);
    cmm<D>(A2, A, A3);
    cmm<D>(A3, A, A4);
    // Horner in A^4: E = blk_3 + c16 A4, then E = blk_b + A4 E
    const float c16 = c_smalld_fact_inv[16];
#pragma unroll
    for (int i = 0; i < DD; ++i) {
        E[i] = make_float2(c16 * A4[i].x, c16 * A4[i].y);
    }
    add_ps_block<D>(E, 3, A, A2, A3);
#pragma unroll
    for (int b = 2; b >= 0; --b) {
        float2 P[DD];
        cmm<D>(A4, E, P);
#pragma unroll
        for (int i = 0; i < DD; ++i) E[i] = P[i];
        add_ps_block<D>(E, b, A, A2, A3);
    }
    for (int q = 0; q < s; ++q) {
        float2 P[DD];
        cmm<D>(E, E, P);
#pragma unroll
        for (int i = 0; i < DD; ++i) E[i] = P[i];
    }
}

// nxt = u psi for a D x D propagator and a D-vector (the chains' order)
template <int D>
__device__ __forceinline__ void smalld_apply(const float2 (&u)[D * D],
                                             const float2 (&psi)[D],
                                             float2 (&nxt)[D]) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < D; ++j) acc = cfma(acc, u[i * D + j], psi[j]);
        nxt[i] = acc;
    }
}

}  // namespace grape
