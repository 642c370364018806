// Batched propagators past the cluster kernel (d > 108):
//
//   U[n, g] = [Taylor-PS degree 16 of (-i dt_n 2^-s H_ng)]^(2^s),
//   H_ng = H0_g + sum_t c[n, t] Op_gt,
//
// for the independent items (n, g), through the C interface of
// grape_propagators (prop_scan.cu: items (n, g), the coefficient row of
// (n, g) at coeffs[g * coeff_group_stride + n * T], the same s).
//
// Replaces, above the cluster kernel of prop_cluster.cu, the propagator half
// of the TPU kernels of grape_tpu/ops/pallas_prop.py:
// forward_scan_pallas_shared (:373), forward_scan_pallas_grouped (:494),
// forward_scan_pallas (:144) and forward_scan_pallas_time (:275), whose
// body (:66-101) forms A = -i dt 2^-s H, A^2, A^3, A^4, Horner over A^4 and
// s squarings with 3-multiplication (Karatsuba) complex products.
//
// What bounds it on this card: operations.  An item is 6 + s complex d x d
// products: 6 d^3 float32 operations each in the Karatsuba form, against
// d^2 bytes out (100 items at d = 1024, s = 3: 5.8 T operations, 86 ms at
// the float32 peak; 115 ms in the 4-multiplication form).  The kernel of
// prop_scan.cu gave one block to each exponential and walked its products
// through one SM, so 100 items filled 100 SMs at 44% of their rate.  Here:
//
//   - EVERY STAGE IS ONE BATCHED PRODUCT over (item, output tile, plane):
//     the generator pass writes A; then A^2 = A A, A^3 = A^2 A,
//     A^4 = A^3 A (whose combine also writes E = c12 I + c13 A + c14 A^2 +
//     c15 A^3 + c16 A^4, the first Horner value), three Horner products
//     E <- block_b(A, A^2, A^3) + A^4 E with the block added in the
//     combine, and s squarings; the last product writes U.  A launch holds
//     a window of items (ops/hopper_prop.py wide_plan: at d = 1024, 24
//     items, 64 tiles and 3 planes each);
//   - KARATSUBA PRODUCTS, as the TPU kernel computes them: each matrix is
//     kept as three float32 planes (re, im, re + im), so a complex product
//     is three real ones, P1 = Xr Yr, P2 = Xi Yi, P3 = Xs Ys, and
//     C = (P1 - P2) + i (P3 - P1 - P2): 6 d^3 operations, not 8 d^3;
//   - REGISTER TILES: a CTA forms one plane's 128 x 128 tile (64 x 64 in
//     the middle range, where it wastes less on the ragged edge), a thread
//     8 x 8 entries of it (64 sums against 16 shared loads a depth step);
//     the three planes of a tile are neighbouring CTAs, and the last of the
//     three to finish (a counter per tile) combines them into C and writes
//     it, while the planes are still in L2;
//   - SCRATCH WITHIN A BUDGET: seven matrices of three planes per item in
//     flight (A, A^2, A^3, A^4, two Horner buffers, the products), the
//     window sized by the wrapper from a byte budget; rows padded to a
//     multiple of 4 floats (zero), so every copy is 16 bytes.
//
// The generator is formed by an elementwise pass rather than inside the
// first product: A is read again by three later stages (and its blocks by
// the Horner combines), so it is written in any case; the pass moves
// 12 d^2 bytes an item, under 1% of the work at d = 1024.
//
// Full float32 FMAs: no tensor cores, no TF32 (the state chains compound
// over N_T steps).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sync.cuh"
#include "cmat.cuh"

namespace grape {
namespace wide {

constexpr int kMats = 7;      // A, A2, A3, A4, E0, E1 and the products P
constexpr int kPlanes = 3;    // re, im, re + im (P: P1, P2, P3)
constexpr int kThreads1d = 256;

__host__ __device__ inline int pitch_of(int d) { return (d + 3) / 4 * 4; }

struct Args {
    const float* X;      // left operand of item 0 (three planes)
    const float* Y;      // right operand of item 0
    float* P;            // the three real products of item 0
    float* Z;            // output planes, or null (U only)
    float* Z2;           // A^4 stage: c16 C + block 3, or null
    const float* blk;    // item 0's A (A^2, A^3 follow at matrix stride)
    float2* U;           // the last product, interleaved, or null
    int* done;           // planes finished per (item, tile), zero between
    long long item0;     // global index of the window's first item
    long long item_stride;  // floats between two items' scratch
    long long plane;        // floats per plane (d * pitch)
    int d, pitch, block;    // Horner block added to the output (-1: none)
    int tiles_n, tiles;
};

__device__ __forceinline__ float part(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// block b of the degree-16 polynomial at the four entries (row, col0..+3):
// c_4b I + c_4b+1 A + c_4b+2 A^2 + c_4b+3 A^3, summed in this order
__device__ __forceinline__ void block_terms(float (&br)[4], float (&bi)[4],
                                            int b, const float* Ab,
                                            long long plane, long long off,
                                            int row, int col0) {
    const long long mat = kPlanes * plane;
    const float c0 = c_fact_inv[4 * b], c1 = c_fact_inv[4 * b + 1];
    const float c2 = c_fact_inv[4 * b + 2], c3 = c_fact_inv[4 * b + 3];
    float4 r[3], i[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        r[q] = *reinterpret_cast<const float4*>(Ab + q * mat + off);
        i[q] = *reinterpret_cast<const float4*>(Ab + q * mat + plane + off);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        float vr = (row == col0 + e) ? c0 : 0.f;
        vr += c1 * part(r[0], e);
        vr += c2 * part(r[1], e);
        vr += c3 * part(r[2], e);
        float vi = c1 * part(i[0], e);
        vi += c2 * part(i[1], e);
        vi += c3 * part(i[2], e);
        br[e] = vr;
        bi[e] = vi;
    }
}

__device__ __forceinline__ void store_planes(float* Z, long long plane,
                                             long long off, const float (&r)[4],
                                             const float (&i)[4]) {
    *reinterpret_cast<float4*>(Z + off) = make_float4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<float4*>(Z + plane + off) =
        make_float4(i[0], i[1], i[2], i[3]);
    *reinterpret_cast<float4*>(Z + 2 * plane + off) = make_float4(
        r[0] + i[0], r[1] + i[1], r[2] + i[2], r[3] + i[3]);
}

// C = (P1 - P2) + i (P3 - P1 - P2) at the entries (row, col0..+3) of item
// z, plus the Horner block; written as three planes, or to U
__device__ __forceinline__ void combine_quad(const Args& a, long long z,
                                             int row, int col0) {
    const int d = a.d;
    const long long pl = a.plane;
    const long long off = (long long)row * a.pitch + col0;
    const float* P = a.P + z * a.item_stride;
    const float4 p1 = __ldcg(reinterpret_cast<const float4*>(P + off));
    const float4 p2 = __ldcg(reinterpret_cast<const float4*>(P + pl + off));
    const float4 p3 =
        __ldcg(reinterpret_cast<const float4*>(P + 2 * pl + off));
    float cr[4], ci[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        cr[e] = part(p1, e) - part(p2, e);
        ci[e] = part(p3, e) - part(p1, e) - part(p2, e);
    }
    const float* Ab = a.blk + z * a.item_stride;
    if (a.Z2 != nullptr) {
        // C is A^4: keep it, and start Horner with block 3 + c16 A^4
        store_planes(a.Z + z * a.item_stride, pl, off, cr, ci);
        float br[4], bi[4];
        block_terms(br, bi, 3, Ab, pl, off, row, col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            br[e] += c_fact_inv[16] * cr[e];
            bi[e] += c_fact_inv[16] * ci[e];
        }
        store_planes(a.Z2 + z * a.item_stride, pl, off, br, bi);
        return;
    }
    if (a.block >= 0) {
        float br[4], bi[4];
        block_terms(br, bi, a.block, Ab, pl, off, row, col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            cr[e] = br[e] + cr[e];
            ci[e] = bi[e] + ci[e];
        }
    }
    if (a.U != nullptr) {
        float2* u = a.U + (a.item0 + z) * (long long)d * d + (long long)row * d;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (col0 + e < d) u[col0 + e] = make_float2(cr[e], ci[e]);
        }
    } else {
        store_planes(a.Z + z * a.item_stride, pl, off, cr, ci);
    }
}

// After a CTA has written its plane of the tile: the last of the three
// planes' CTAs combines the tile (and resets its counter for the next
// product).
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void finish_tile(const Args& a, long long z,
                                            int tile, int m0, int n0) {
    __shared__ int last;
    __threadfence();  // this CTA's plane is visible before the count
    __syncthreads();
    if (threadIdx.x == 0) {
        int* c = a.done + z * a.tiles + tile;
        last = atomicAdd(c, 1) == kPlanes - 1;
        if (last) *c = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();  // the other planes' writes before our reads
    for (int q = threadIdx.x; q < BM * (BN / 4); q += THREADS) {
        const int row = m0 + q / (BN / 4);
        const int col0 = n0 + 4 * (q % (BN / 4));
        if (row < a.d && col0 < a.pitch) combine_quad(a, z, row, col0);
    }
}

// ---- the 128 x 128 tile (the larger dimensions) ----------------------------
// 256 threads, each 8 x 8 entries in four 4 x 4 blocks 64 rows and 64
// columns apart; the left tile is staged transposed ([depth][row]) so that
// a thread reads its 8 rows of a depth in two 16-byte loads, and both tiles
// go through registers into a shared double buffer of depth 8, one depth
// step ahead of the products.
constexpr int kBig = 128;
constexpr int kBigDepth = 8;
constexpr int kBigPitch = kBig + 4;  // floats per depth row of a tile
constexpr int kBigThreads = 256;

__global__ void __launch_bounds__(kBigThreads, 2)
wide_product_big_kernel(const Args a) {
    __shared__ __align__(16) float xs[2][kBigDepth][kBigPitch];
    __shared__ __align__(16) float ys[2][kBigDepth][kBigPitch];
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    // a warp holds 8 x 4 threads: 32 columns and 32 rows of the tile
    const int tx = (warp % 2) * 8 + lane % 8;
    const int ty = (warp / 2) * 4 + lane / 8;
    const int d = a.d, pitch = a.pitch;
    const int tile = blockIdx.x / kPlanes;
    const long long z = blockIdx.y;
    const long long off_z =
        z * a.item_stride + (blockIdx.x % kPlanes) * a.plane;
    const int m0 = (tile / a.tiles_n) * kBig;
    const int n0 = (tile % a.tiles_n) * kBig;
    const float* X = a.X + off_z;
    const float* Y = a.Y + off_z;
    const int k_tiles = (pitch + kBigDepth - 1) / kBigDepth;
    // this thread's loads: left row tid / 2 at depths 4 (tid % 2)..+3,
    // right depth row tid / 32 at columns 4 (tid % 32)..+3
    const int lr = tid / 2, lk = 4 * (tid % 2);
    const int rk = tid / 32, rc = 4 * (tid % 32);
    auto fetch = [&](int kt, float4& xv, float4& yv) {
        const int k0 = kt * kBigDepth;
        const bool okx = m0 + lr < d && k0 + lk < pitch;
        xv = okx ? __ldcg(reinterpret_cast<const float4*>(
                       X + (long long)(m0 + lr) * pitch + k0 + lk))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const bool oky = k0 + rk < d && n0 + rc < pitch;
        yv = oky ? __ldcg(reinterpret_cast<const float4*>(
                       Y + (long long)(k0 + rk) * pitch + n0 + rc))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto put = [&](int b, const float4& xv, const float4& yv) {
        xs[b][lk + 0][lr] = xv.x;
        xs[b][lk + 1][lr] = xv.y;
        xs[b][lk + 2][lr] = xv.z;
        xs[b][lk + 3][lr] = xv.w;
        *reinterpret_cast<float4*>(&ys[b][rk][rc]) = yv;
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float4 xv, yv;
    fetch(0, xv, yv);
    put(0, xv, yv);
    __syncthreads();
    for (int kt = 0; kt < k_tiles; ++kt) {
        const int b = kt & 1;
        if (kt + 1 < k_tiles) fetch(kt + 1, xv, yv);
#pragma unroll
        for (int k = 0; k < kBigDepth; ++k) {
            const float4 x0 = *reinterpret_cast<const float4*>(&xs[b][k][4 * ty]);
            const float4 x1 =
                *reinterpret_cast<const float4*>(&xs[b][k][4 * ty + 64]);
            const float4 y0 = *reinterpret_cast<const float4*>(&ys[b][k][4 * tx]);
            const float4 y1 =
                *reinterpret_cast<const float4*>(&ys[b][k][4 * tx + 64]);
            const float xr[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
            const float yc[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(xr[i], yc[j], acc[i][j]);
        }
        if (kt + 1 < k_tiles) put(b ^ 1, xv, yv);
        __syncthreads();
    }

    float* P = a.P + off_z;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = m0 + 4 * ty + (i % 4) + 64 * (i / 4);
        if (row >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col0 = n0 + 4 * tx + 64 * h;
            if (col0 >= pitch) continue;
            *reinterpret_cast<float4*>(P + (long long)row * pitch + col0) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
    }
    finish_tile<kBig, kBig, kBigThreads>(a, z, tile, m0, n0);
}

// ---- the 64 x 64 tile (the middle range) -----------------------------------
// 64 threads, each 8 x 8 entries (rows 8 apart, columns in two chunks of
// four 32 apart); a depth step of 16 staged by cp.async, four stages deep,
// the left tile row-major so that one 16-byte load gives a row four depths.
constexpr int kMid = 64;
constexpr int kMidDepth = 16;
constexpr int kMidLeftPitch = kMidDepth + 4;
constexpr int kMidStages = 4;
constexpr int kMidThreads = 64;
constexpr int kMidLeft = kMid * kMidLeftPitch;   // floats
constexpr int kMidRight = kMidDepth * kMid;      // floats
constexpr size_t kMidSmem =
    (size_t)kMidStages * (kMidLeft + kMidRight) * sizeof(float);

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kMidThreads)
wide_product_mid_kernel(const Args a) {
    extern __shared__ __align__(128) float wsm[];
    const int tid = threadIdx.x;
    const int tx = tid % 8;
    const int ty = tid / 8;
    const int d = a.d, pitch = a.pitch;
    const int tile = blockIdx.x / kPlanes;
    const long long z = blockIdx.y;
    const long long off_z =
        z * a.item_stride + (blockIdx.x % kPlanes) * a.plane;
    const int m0 = (tile / a.tiles_n) * kMid;
    const int n0 = (tile % a.tiles_n) * kMid;
    const float* X = a.X + off_z;
    const float* Y = a.Y + off_z;
    const int k_tiles = (pitch + kMidDepth - 1) / kMidDepth;

    auto stage = [&](int kt) {
        float* sl = wsm + (size_t)(kt % kMidStages) * (kMidLeft + kMidRight);
        float* sr = sl + kMidLeft;
        const int k0 = kt * kMidDepth;
#pragma unroll
        for (int q = tid; q < kMid * 4; q += kMidThreads) {
            const int r = q / 4;
            const int c = k0 + 4 * (q % 4);
            const bool ok = m0 + r < d && c < pitch;
            cp16(sl + r * kMidLeftPitch + 4 * (q % 4),
                 ok ? X + (long long)(m0 + r) * pitch + c : X, ok);
        }
#pragma unroll
        for (int q = tid; q < kMidDepth * (kMid / 4); q += kMidThreads) {
            const int r = q / (kMid / 4);
            const int c = n0 + 4 * (q % (kMid / 4));
            const bool ok = k0 + r < d && c < pitch;
            cp16(sr + r * kMid + 4 * (q % (kMid / 4)),
                 ok ? Y + (long long)(k0 + r) * pitch + c : Y, ok);
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int kt = 0; kt < kMidStages - 1; ++kt) {
        if (kt < k_tiles) stage(kt);
        cp_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
        cp_wait<kMidStages - 2>();
        __syncthreads();
        if (kt + kMidStages - 1 < k_tiles) stage(kt + kMidStages - 1);
        cp_commit();
        const float* sl =
            wsm + (size_t)(kt % kMidStages) * (kMidLeft + kMidRight);
        const float* xl = sl + ty * kMidLeftPitch;
        const float* yr = sl + kMidLeft + 4 * tx;
#pragma unroll
        for (int kk = 0; kk < kMidDepth; kk += 4) {
            float4 av[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                av[i] = *reinterpret_cast<const float4*>(
                    xl + i * 8 * kMidLeftPitch + kk);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float4 b0 =
                    *reinterpret_cast<const float4*>(yr + (kk + k) * kMid);
                const float4 b1 =
                    *reinterpret_cast<const float4*>(yr + (kk + k) * kMid + 32);
                const float yc[8] = {b0.x, b0.y, b0.z, b0.w,
                                     b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float x = part(av[i], k);
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = fmaf(x, yc[j], acc[i][j]);
                }
            }
        }
    }
    cp_wait<0>();

    float* P = a.P + off_z;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty + 8 * i;
        if (row >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col0 = n0 + 4 * tx + 32 * h;
            if (col0 >= pitch) continue;
            *reinterpret_cast<float4*>(P + (long long)row * pitch + col0) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
    }
    finish_tile<kMid, kMid, kMidThreads>(a, z, tile, m0, n0);
}

// A = -i dt 2^-s H of each item of the window, as three planes (re, im,
// re + im) with the padding columns zero
__global__ void __launch_bounds__(kThreads1d)
wide_generator_kernel(const float2* __restrict__ H0,
                      const float2* __restrict__ ops,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ dts, int T, int d, int G,
                      long long coeff_group_stride, float scale,
                      long long item0, float* scratch, long long item_stride,
                      long long plane) {
    const int pitch = pitch_of(d);
    const int idx = blockIdx.x * kThreads1d + threadIdx.x;
    if (idx >= d * pitch) return;
    const long long item = item0 + blockIdx.y;
    const int n = (int)(item / G);
    const int g = (int)(item % G);
    const int i = idx / pitch;
    const int j = idx - i * pitch;
    float ar = 0.f, ai = 0.f;
    if (j < d) {
        const size_t dd = (size_t)d * d;
        const size_t e = (size_t)i * d + j;
        float2 h = H0[(size_t)g * dd + e];
        const float* c = coeffs + (size_t)g * coeff_group_stride + (size_t)n * T;
        for (int t = 0; t < T; ++t) {
            const float ct = c[t];
            const float2 o = ops[((size_t)g * T + t) * dd + e];
            h.x += ct * o.x;
            h.y += ct * o.y;
        }
        const float f = dts[n] * scale;
        ar = f * h.y;
        ai = -f * h.x;
    }
    float* A = scratch + (long long)blockIdx.y * item_stride;
    A[idx] = ar;
    A[plane + idx] = ai;
    A[2 * plane + idx] = ar + ai;
}

// the output tile of configuration 0 (128) or 1 (64)
__host__ __device__ inline int tile_of(int config) {
    return config == 0 ? kBig : kMid;
}

inline int tiles_of(int d, int config) {
    const int t = tile_of(config);
    return ((d + t - 1) / t) * ((pitch_of(d) + t - 1) / t);
}

static cudaError_t product(Args a, int config, int items,
                           cudaStream_t stream) {
    const int t = tile_of(config);
    a.tiles_n = (a.pitch + t - 1) / t;
    a.tiles = tiles_of(a.d, config);
    const dim3 grid(a.tiles * kPlanes, items);
    if (config == 0) {
        wide_product_big_kernel<<<grid, kBigThreads, 0, stream>>>(a);
    } else {
        cudaError_t err = cudaFuncSetAttribute(
            wide_product_mid_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMidSmem);
        if (err != cudaSuccess) return err;
        wide_product_mid_kernel<<<grid, kMidThreads, kMidSmem, stream>>>(a);
    }
    return cudaGetLastError();
}

}  // namespace wide
}  // namespace grape

extern "C" {

// Floats of scratch a call takes: `window` items of seven matrices of three
// planes, then one counter per (item, tile) of the window.
long long grape_propagators_wide_scratch_floats(int d, int window,
                                                int config) {
    using namespace grape::wide;
    return (long long)window *
           ((long long)kMats * kPlanes * d * pitch_of(d) + tiles_of(d, config));
}

// U[n, g] as grape_propagators; `scratch` holds
// grape_propagators_wide_scratch_floats(d, window, config) floats; `config`
// picks the output tile, 0: 128 x 128, 1: 64 x 64 (ops/hopper_prop.py
// wide_plan).
int grape_propagators_wide(const void* H0, const void* ops, const void* coeffs,
                           const void* dts, int T, int d, int N_T, int G,
                           long long coeff_group_stride, int s, void* scratch,
                           int window, int config, void* U, void* stream) {
    using namespace grape::wide;
    cudaGetLastError();
    if (d < 1 || N_T < 1 || G < 1 || T < 0 || s < 0 || s > 32 ||
        window < 1 || window > 65535 || (config != 0 && config != 1) ||
        scratch == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const int pitch = pitch_of(d);
    const long long plane = (long long)d * pitch;
    const long long mat = kPlanes * plane;
    const long long item_stride = kMats * mat;
    const long long n_items = (long long)N_T * G;
    const float scale = exp2f(-(float)s);
    float* base = (float*)scratch;
    int* done = reinterpret_cast<int*>(base + window * item_stride);
    cudaError_t err = cudaMemsetAsync(
        done, 0, sizeof(int) * (size_t)window * tiles_of(d, config), st);
    if (err != cudaSuccess) return (int)err;
    auto M = [&](int m) { return base + m * mat; };
    auto run = [&](Args a, int items) -> cudaError_t {
        a.item_stride = item_stride;
        a.plane = plane;
        a.d = d;
        a.pitch = pitch;
        a.blk = M(0);
        a.P = M(6);
        a.done = done;
        return product(a, config, items, st);
    };
    for (long long w0 = 0; w0 < n_items; w0 += window) {
        const int nw = (int)(n_items - w0 < window ? n_items - w0 : window);
        const int build_blocks = (d * pitch + kThreads1d - 1) / kThreads1d;
        wide_generator_kernel<<<dim3(build_blocks, nw), kThreads1d, 0, st>>>(
            (const float2*)H0, (const float2*)ops, (const float*)coeffs,
            (const float*)dts, T, d, G, coeff_group_stride, scale, w0, base,
            item_stride, plane);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        Args a = {};
        a.item0 = w0;
        a.block = -1;
        // A^2 = A A, A^3 = A^2 A, A^4 = A^3 A (and E0 = block 3 + c16 A^4)
        const int chain[3][2] = {{0, 1}, {1, 2}, {2, 3}};
        for (int q = 0; q < 3; ++q) {
            Args b = a;
            b.X = M(chain[q][0]);
            b.Y = M(0);
            b.Z = M(chain[q][1]);
            if (q == 2) b.Z2 = M(4);
            if ((err = run(b, nw)) != cudaSuccess) return (int)err;
        }
        // Horner in A^4 with blocks 2, 1, 0, then s squarings; the last
        // product writes U
        int cur = 4;
        const int n_ops = 3 + s;
        for (int op = 0; op < n_ops; ++op) {
            const bool last = op == n_ops - 1;
            Args b = a;
            b.X = op < 3 ? M(3) : M(cur);
            b.Y = M(cur);
            b.Z = last ? nullptr : M(9 - cur);
            b.U = last ? (float2*)U : nullptr;
            b.block = op < 3 ? 2 - op : -1;
            if ((err = run(b, nw)) != cudaSuccess) return (int)err;
            cur = 9 - cur;  // E0 (4) <-> E1 (5)
        }
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
