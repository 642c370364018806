// Block-level dense complex matrix helpers shared by the GRAPE kernels.
//
// Every matrix is d x d, row-major, interleaved complex64 (float2), and
// lives in global memory: the kernels keep their working set (powers of A,
// Horner partials, the E ladder) in a per-block scratch area that the
// wrapper allocates, because a block has 227 KB of shared memory and one
// complex 100 x 100 matrix is already 80 KB.  Products are tiled through
// shared memory and accumulated with plain float32 FMAs in the 4-product
// complex form: no tensor cores, no TF32, no reduced precision anywhere.
//
// All functions are called by every thread of a 256-thread block and end
// with __syncthreads(), so the result is visible to the whole block on
// return.  Scratch pointers are deliberately not const __restrict__: data
// that the block wrote must never be served from the read-only cache path.
#pragma once

#include <cuda_runtime.h>

namespace grape {

constexpr int kThreads = 256;  // threads per block (16 x 16)
constexpr int kTile = 64;      // output tile edge; 4 x 4 entries per thread
constexpr int kBK = 16;        // depth of one shared-memory stage

// 1/k! for k = 0..16: the degree-16 Taylor coefficients.
static __constant__ float c_fact_inv[17] = {
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

struct GemmSmem {
    float2 a[kBK][kTile + 1];  // A tile, transposed: a[k][row]
    float2 b[kBK][kTile];      // B tile: b[k][col]
};

// One thread's share of the next shared-memory stage, held in registers
// while the block computes on the current stage.
struct TileRegs {
    float2 a[4];
    float2 b[4];
};

// Global -> registers: rows r0.. of A and columns c0.. of B at depth k0
// (zero beyond the matrix edge).
__device__ __forceinline__ void fetch_tiles(TileRegs& t, const float2* A,
                                            const float2* B, int d, int r0,
                                            int c0, int k0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        const int idx = tid + l * kThreads;
        // A tile: neighbouring threads along k (contiguous)
        const int gr = r0 + (idx >> 4);
        const int gk = k0 + (idx & (kBK - 1));
        t.a[l] = (gr < d && gk < d) ? A[gr * d + gk] : make_float2(0.f, 0.f);
        // B tile: neighbouring threads along the column
        const int gc = c0 + (idx & (kTile - 1));
        const int gk2 = k0 + (idx >> 6);
        t.b[l] = (gk2 < d && gc < d) ? B[gk2 * d + gc]
                                     : make_float2(0.f, 0.f);
    }
}

// Registers -> shared memory.
__device__ __forceinline__ void stage_tiles(GemmSmem& sm, const TileRegs& t) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        const int idx = tid + l * kThreads;
        sm.a[idx & (kBK - 1)][idx >> 4] = t.a[l];
        sm.b[idx >> 6][idx & (kTile - 1)] = t.b[l];
    }
}

// dst = A * B (accumulate == false) or dst += A * B (accumulate == true).
// dst must not alias A or B.  The loads of stage k+1 are issued before the
// FMAs of stage k, so the global-memory latency overlaps the arithmetic.
__device__ __forceinline__ void cgemm(float2* dst, const float2* A,
                                      const float2* B, int d,
                                      bool accumulate, GemmSmem& sm) {
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    for (int r0 = 0; r0 < d; r0 += kTile) {
        for (int c0 = 0; c0 < d; c0 += kTile) {
            float accr[4][4];
            float acci[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    accr[i][j] = 0.f;
                    acci[i][j] = 0.f;
                }
            }
            TileRegs next;
            fetch_tiles(next, A, B, d, r0, c0, 0);
            for (int k0 = 0; k0 < d; k0 += kBK) {
                stage_tiles(sm, next);
                __syncthreads();
                if (k0 + kBK < d) fetch_tiles(next, A, B, d, r0, c0, k0 + kBK);
#pragma unroll
                for (int kk = 0; kk < kBK; ++kk) {
                    float2 av[4];
                    float2 bv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
                    for (int j = 0; j < 4; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            accr[i][j] = fmaf(av[i].x, bv[j].x, accr[i][j]);
                            accr[i][j] = fmaf(-av[i].y, bv[j].y, accr[i][j]);
                            acci[i][j] = fmaf(av[i].x, bv[j].y, acci[i][j]);
                            acci[i][j] = fmaf(av[i].y, bv[j].x, acci[i][j]);
                        }
                    }
                }
                __syncthreads();
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int gr = r0 + ty + 16 * i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int gc = c0 + tx + 16 * j;
                    if (gr < d && gc < d) {
                        float2 o = make_float2(accr[i][j], acci[i][j]);
                        if (accumulate) {
                            const float2 p = dst[gr * d + gc];
                            o.x += p.x;
                            o.y += p.y;
                        }
                        dst[gr * d + gc] = o;
                    }
                }
            }
        }
    }
    __syncthreads();
}

// dst = c0 * I + c1 * P1 + c2 * P2 + c3 * P3 + c4 * P4, summed in this
// order; a null pointer drops its term (and c0 == 0 drops the identity).
__device__ __forceinline__ void lincomb(float2* dst, float c0, float c1,
                                        const float2* P1, float c2,
                                        const float2* P2, float c3,
                                        const float2* P3, float c4,
                                        const float2* P4, int d) {
    const int n = d * d;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        float2 o = make_float2(0.f, 0.f);
        if (c0 != 0.f && (idx / d) == (idx % d)) o.x = c0;
        if (P1) {
            const float2 v = P1[idx];
            o.x += c1 * v.x;
            o.y += c1 * v.y;
        }
        if (P2) {
            const float2 v = P2[idx];
            o.x += c2 * v.x;
            o.y += c2 * v.y;
        }
        if (P3) {
            const float2 v = P3[idx];
            o.x += c3 * v.x;
            o.y += c3 * v.y;
        }
        if (P4) {
            const float2 v = P4[idx];
            o.x += c4 * v.x;
            o.y += c4 * v.y;
        }
        dst[idx] = o;
    }
    __syncthreads();
}

// A = -i * dt * 2^-s * (H0 + sum_t c[t] * Op_t):  Ar = f * Hi, Ai = -f * Hr
// with f = dt * 2^-s.  H0 (d, d), ops (T, d, d) are read-only inputs.
__device__ __forceinline__ void build_generator(
    float2* A, const float2* __restrict__ H0, const float2* __restrict__ ops,
    const float* __restrict__ coeffs_n, float dt, float scale, int T, int d) {
    const int n = d * d;
    const float f = dt * scale;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        float2 h = H0[idx];
        for (int t = 0; t < T; ++t) {
            const float c = coeffs_n[t];
            const float2 o = ops[t * n + idx];
            h.x += c * o.x;
            h.y += c * o.y;
        }
        A[idx] = make_float2(f * h.y, -f * h.x);
    }
    __syncthreads();
}

// A2 = A*A, A3 = A2*A, A4 = A3*A
__device__ __forceinline__ void powers(float2* A, float2* A2, float2* A3,
                                       float2* A4, int d, GemmSmem& sm) {
    cgemm(A2, A, A, d, false, sm);
    cgemm(A3, A2, A, d, false, sm);
    cgemm(A4, A3, A, d, false, sm);
}

// Paterson-Stockmeyer block b of the degree-16 Taylor polynomial,
// blk_b = sum_{r<4} A^r / (4b+r)!, written to dst.  For b == 3 the
// c16 * A^4 term of the first Horner update (A^4 times the scalar block
// c16 * I, exact) is folded in through `A4`; pass nullptr otherwise.
__device__ __forceinline__ void ps_block(float2* dst, int b, const float2* A,
                                         const float2* A2, const float2* A3,
                                         const float2* A4, int d) {
    lincomb(dst, c_fact_inv[4 * b], c_fact_inv[4 * b + 1], A,
            c_fact_inv[4 * b + 2], A2, c_fact_inv[4 * b + 3], A3,
            c_fact_inv[16], A4, d);
}

}  // namespace grape
