// The propagator kernel for Hopper: U[n, g] = exp(-i dt_n H_ng), every
// (step, group) item formed by one thread block CLUSTER of four CTAs whose
// working set never leaves shared memory.
//
// Replaces, for every d whose working set fits the cluster
// (ops/hopper_prop.py propagator_route), the propagator half of the TPU
// kernels of grape_tpu/ops/pallas_prop.py:
//
//   forward_scan_pallas          (:144, K5)
//   forward_scan_pallas_time     (:275, K10)
//   forward_scan_pallas_shared   (:373, K1)
//   forward_scan_pallas_grouped  (:494, K4)
//
// and the re-formed propagators of chi_scan_recompute.  Larger d keeps the
// global-scratch propagator_kernel of prop_scan.cu.
//
// The function is the one of propagator_kernel: A = -i dt_n 2^-s H_ng, the
// degree-16 Taylor polynomial by Paterson-Stockmeyer in A^4 (A^2, A^3, A^4,
// then three Horner products), then s squarings: (6 + s) complex d x d
// products per item.  What bounds it on this card is float32 FMA issue
// (8 d^3 operations per product at 67 TFLOP/s; only d^2 bytes out).  The
// design aims the whole kernel at that bound:
//
// - Working set on chip.  The matrices of an item are split by rows over
//   the four CTAs of a cluster: each CTA owns a slab of ceil(d/4) rows of
//   A, A^2, A^3 and E, stored transposed ([k][row]) in split real and
//   imaginary planes.  Every product of the algorithm is X . Y with the
//   left operand one of the CTA's own slabs and the right operand A, A^4
//   or E, so a product needs only the CTA's slab of X and a full copy of Y.
//   Horner runs as E <- E A^4 + blk, which equals A^4 E + blk (polynomials
//   in A commute), so A^4 is exchanged once.  At d = 100: four slabs of
//   28 x 100 (padded rows), the copy of Y and an export buffer, 192 KB per
//   CTA, one CTA per SM; nothing goes through device memory except H0, the
//   operators (L2-resident) and U itself.
// - Exchange by pushes.  The rows that become a right operand (A as it is
//   built, A^4 and E as products write them) are also written row-major
//   into an export buffer, and every thread pushes 16-byte pieces of it
//   into the four CTAs' copies of Y by st.async, each completing on an
//   mbarrier of the receiving CTA: no thread waits on a remote load, and
//   the issue is spread over the block (a gather by remote loads, and bulk
//   copies issued by one thread, were both slower).
// - Tiles fitted to d.  Each half-warp owns 16 complex 4 x 4 output tiles
//   of the CTA's (rows x d) slab, the two halves of a warp the two halves
//   of the depth (summed by one shuffle): at d = 100, 7 x 25 tiles of
//   28 x 100, 1.12x the needed work (the 64 x 64 x 16 tiles of cmat.cuh did
//   1.84x), on 11 of 12 warps, so that the four schedulers of the SM carry
//   3, 3, 3 and 2 warps.
// - FMA-bound inner loop.  Per k a thread loads four float4 (4 rows of X,
//   4 columns of Y, real and imaginary planes; the X loads are broadcasts
//   within a half-warp) for 64 FMAs.
// - Float32 FMAs in the 4-product complex form, no tensor cores, no TF32:
//   the state chains compound the propagators' rounding over N_T steps.
//
// Cluster barriers per item: one at its start (every copy of Y free) and
// one before each later exchange (A^4, and E per squaring).  A persistent
// grid of as many clusters as can be resident walks over the items.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sync.cuh"
#include "cmat.cuh"  // c_fact_inv: the Taylor coefficients
#include "phase_clock.cuh"

namespace cg = cooperative_groups;

namespace grape {
namespace pcl {

constexpr int kCtas = 4;             // CTAs per cluster (rows split 4 ways)
constexpr int kThreads = 384;        // 12 warps: 192 tiles x 2 depth halves
constexpr int kTileSlots = kThreads / 2;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kHeadBytes = 128;      // the exchange mbarrier, padded

// rows of a slab (the last CTA may own fewer, or none at tiny d)
__host__ __device__ inline int slab_rows(int d) {
    return (d + kCtas - 1) / kCtas;
}
// row pitch of a transposed slab plane: rows padded to the 4-row tile
__host__ __device__ inline int slab_pitch(int d) {
    return 4 * ((slab_rows(d) + 3) / 4);
}
// row pitch of Y and of the export: columns padded to the 4-column tile
__host__ __device__ inline int y_pitch(int d) { return 4 * ((d + 3) / 4); }
// depth rows of Y and of the slabs: d padded to the two depth halves
__host__ __device__ inline int depth(int d) { return 2 * ((d + 1) / 2); }
// output tiles of a slab
__host__ __device__ inline int n_tiles(int d) {
    return (slab_pitch(d) / 4) * (y_pitch(d) / 4);
}

// the mbarrier, Y (2 planes of depth x y_pitch), 4 slabs (2 planes of
// depth x slab_pitch each), the export (2 planes of slab_pitch x y_pitch);
// mirrored by ops/hopper_prop.py _prop_cluster_smem
__host__ __device__ inline size_t smem_bytes(int d) {
    const size_t K2 = depth(d), P = slab_pitch(d), W = y_pitch(d);
    return kHeadBytes + sizeof(float) * (2 * K2 * W + 8 * K2 * P + 2 * P * W);
}

// the kernel's shapes at d: fits one CTA's shared memory and its tiles
// fit the block
__host__ __device__ inline bool fits(int d) {
    return d >= 1 && smem_bytes(d) <= kMaxSmem && n_tiles(d) <= kTileSlots;
}

// phases: 0 A's rows and their exchange, 1 A^2..A^4, 2 exchange of A^4,
// 3 E, 4 Horner, 5 squarings
GRAPE_CLOCK_TABLE(g_clock_pcl)

enum Slab { kA = 0, kA2 = 1, kA3 = 2, kE = 3 };

struct Ctx {
    float* Yr;
    float* Yi;
    float* S;        // slab planes: re of slab m at S + 2m*plane, im after
    float* X;        // export planes: re at X, im at X + xplane
    size_t plane;    // floats per slab plane (depth * P)
    size_t xplane;   // floats per export plane (P * W)
    int d, R, P, W;  // size, slab rows, slab pitch, Y pitch
    int kh;          // depth of one half
    int row0, nrows; // this CTA's rows
    int rg, cgi;     // this thread's output tile
    int half;        // this thread's half of the depth
    bool busy;       // the warp holds at least one tile
    bool writer;     // the thread's tile exists and it writes it (half 0)
    __device__ float* re(int m) const { return S + 2 * m * plane; }
    __device__ float* im(int m) const { return S + (2 * m + 1) * plane; }
    __device__ float* xre() const { return X; }
    __device__ float* xim() const { return X + xplane; }
};

// (all threads) the export's rows into rows row0.. of the four CTAs'
// copies of Y, completing on each receiver's mbarrier
__device__ __forceinline__ void push_export(const Ctx& c, uint64_t* bar) {
    const int n4 = c.nrows * c.W / 4;  // float4 per plane
    const size_t at = (size_t)c.row0 * c.W;
    const float4* xr = reinterpret_cast<const float4*>(c.xre());
    const float4* xi = reinterpret_cast<const float4*>(c.xim());
    for (int q = 0; q < kCtas; ++q) {
        const unsigned rbar = cluster_addr(smem_addr(bar), q);
        const unsigned yr = cluster_addr(smem_addr(c.Yr + at), q);
        const unsigned yi = cluster_addr(smem_addr(c.Yi + at), q);
        for (int e = threadIdx.x; e < n4; e += blockDim.x) {
            st_async(yr + 16 * e, xr[e], rbar);
            st_async(yi + 16 * e, xi[e], rbar);
        }
    }
}

// acc = X_slab . Y for this thread's 4 x 4 tile; X transposed ([k][row],
// pitch P), Y row-major (pitch W), split planes.  Each half of the warp
// sums its half of the depth, one shuffle adds the two; called by whole
// busy warps (the shuffle needs every lane).
__device__ __forceinline__ void slab_product(const Ctx& c, int m,
                                             float (&ar)[4][4],
                                             float (&ai)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            ar[i][j] = 0.f;
            ai[i][j] = 0.f;
        }
    }
    const size_t k0 = (size_t)c.half * c.kh;
    const float* xr = c.re(m) + k0 * c.P + 4 * c.rg;
    const float* xi = c.im(m) + k0 * c.P + 4 * c.rg;
    const float* yr = c.Yr + k0 * c.W + 4 * c.cgi;
    const float* yi = c.Yi + k0 * c.W + 4 * c.cgi;
#pragma unroll 4
    for (int k = 0; k < c.kh; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(xr + k * c.P);
        const float4 b = *reinterpret_cast<const float4*>(xi + k * c.P);
        const float4 u = *reinterpret_cast<const float4*>(yr + k * c.W);
        const float4 v = *reinterpret_cast<const float4*>(yi + k * c.W);
        const float x_r[4] = {a.x, a.y, a.z, a.w};
        const float x_i[4] = {b.x, b.y, b.z, b.w};
        const float y_r[4] = {u.x, u.y, u.z, u.w};
        const float y_i[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                ar[i][j] = fmaf(x_r[i], y_r[j], ar[i][j]);
                ar[i][j] = fmaf(-x_i[i], y_i[j], ar[i][j]);
                ai[i][j] = fmaf(x_r[i], y_i[j], ai[i][j]);
                ai[i][j] = fmaf(x_i[i], y_r[j], ai[i][j]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            ar[i][j] += __shfl_xor_sync(0xffffffffu, ar[i][j], 16);
            ai[i][j] += __shfl_xor_sync(0xffffffffu, ai[i][j], 16);
        }
    }
}

// Add the Paterson-Stockmeyer block b, sum_{r<4} A^r / (4b+r)!, to the
// tile (rows beyond the CTA's own are masked by the stores).
__device__ __forceinline__ void add_block(const Ctx& c, int b,
                                          float (&ar)[4][4],
                                          float (&ai)[4][4]) {
    const float c0 = c_fact_inv[4 * b], c1 = c_fact_inv[4 * b + 1];
    const float c2 = c_fact_inv[4 * b + 2], c3 = c_fact_inv[4 * b + 3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int col = 4 * c.cgi + j;
        if (col >= c.d) continue;
        const size_t at = (size_t)col * c.P + 4 * c.rg;
        const float4 p1r = *reinterpret_cast<const float4*>(c.re(kA) + at);
        const float4 p1i = *reinterpret_cast<const float4*>(c.im(kA) + at);
        const float4 p2r = *reinterpret_cast<const float4*>(c.re(kA2) + at);
        const float4 p2i = *reinterpret_cast<const float4*>(c.im(kA2) + at);
        const float4 p3r = *reinterpret_cast<const float4*>(c.re(kA3) + at);
        const float4 p3i = *reinterpret_cast<const float4*>(c.im(kA3) + at);
        const float a1r[4] = {p1r.x, p1r.y, p1r.z, p1r.w};
        const float a1i[4] = {p1i.x, p1i.y, p1i.z, p1i.w};
        const float a2r[4] = {p2r.x, p2r.y, p2r.z, p2r.w};
        const float a2i[4] = {p2i.x, p2i.y, p2i.z, p2i.w};
        const float a3r[4] = {p3r.x, p3r.y, p3r.z, p3r.w};
        const float a3i[4] = {p3i.x, p3i.y, p3i.z, p3i.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float br = (c.row0 + 4 * c.rg + i == col) ? c0 : 0.f;
            float bi = 0.f;
            br += c1 * a1r[i];
            bi += c1 * a1i[i];
            br += c2 * a2r[i];
            bi += c2 * a2i[i];
            br += c3 * a3r[i];
            bi += c3 * a3i[i];
            ar[i][j] += br;
            ai[i][j] += bi;
        }
    }
}

// The tile into slab m (transposed; rows past the CTA's own written as 0).
__device__ __forceinline__ void store_slab(const Ctx& c, int m,
                                           const float (&ar)[4][4],
                                           const float (&ai)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int col = 4 * c.cgi + j;
        if (col >= c.d) continue;
        float vr[4], vi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const bool own = 4 * c.rg + i < c.nrows;
            vr[i] = own ? ar[i][j] : 0.f;
            vi[i] = own ? ai[i][j] : 0.f;
        }
        const size_t at = (size_t)col * c.P + 4 * c.rg;
        *reinterpret_cast<float4*>(c.re(m) + at) =
            make_float4(vr[0], vr[1], vr[2], vr[3]);
        *reinterpret_cast<float4*>(c.im(m) + at) =
            make_float4(vi[0], vi[1], vi[2], vi[3]);
    }
}

// The tile's own rows into the export (row-major; columns past d as 0).
__device__ __forceinline__ void store_export(const Ctx& c,
                                             const float (&ar)[4][4],
                                             const float (&ai)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int rl = 4 * c.rg + i;
        if (rl >= c.nrows) continue;
        float vr[4], vi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bool in = 4 * c.cgi + j < c.d;
            vr[j] = in ? ar[i][j] : 0.f;
            vi[j] = in ? ai[i][j] : 0.f;
        }
        const size_t at = (size_t)rl * c.W + 4 * c.cgi;
        *reinterpret_cast<float4*>(c.xre() + at) =
            make_float4(vr[0], vr[1], vr[2], vr[3]);
        *reinterpret_cast<float4*>(c.xim() + at) =
            make_float4(vi[0], vi[1], vi[2], vi[3]);
    }
}

// The tile's own rows into U (interleaved complex, row-major d x d).
__device__ __forceinline__ void store_global(const Ctx& c, float2* Uitem,
                                             const float (&ar)[4][4],
                                             const float (&ai)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int rl = 4 * c.rg + i;
        if (rl >= c.nrows) continue;
        float2* row = Uitem + (size_t)(c.row0 + rl) * c.d;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = 4 * c.cgi + j;
            if (col < c.d) row[col] = make_float2(ar[i][j], ai[i][j]);
        }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
propagator_cluster_kernel(const float2* __restrict__ H0,
                          const float2* __restrict__ ops,
                          const float* __restrict__ coeffs,
                          const float* __restrict__ dts, int T, int d,
                          int N_T, int G, size_t coeff_group_stride, int s,
                          float2* __restrict__ U) {
    extern __shared__ __align__(128) float4 smem4[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
    float* smem = reinterpret_cast<float*>(
        reinterpret_cast<char*>(smem4) + kHeadBytes);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x;

    Ctx c;
    c.d = d;
    c.R = slab_rows(d);
    c.P = slab_pitch(d);
    c.W = y_pitch(d);
    c.kh = depth(d) / 2;
    const int K2 = depth(d);
    c.plane = (size_t)K2 * c.P;
    c.xplane = (size_t)c.P * c.W;
    c.Yr = smem;
    c.Yi = smem + (size_t)K2 * c.W;
    c.S = c.Yi + (size_t)K2 * c.W;
    c.X = c.S + 8 * c.plane;
    c.row0 = rank * c.R;
    c.nrows = max(0, min(d, c.row0 + c.R) - c.row0);
    const int CG = c.W / 4;
    const int tiles = n_tiles(d);
    const int tile = (tid >> 5) * 16 + (tid & 15);
    c.half = (tid >> 4) & 1;
    c.busy = (tid >> 5) * 16 < tiles;
    c.writer = tile < tiles && c.half == 0;
    // a lane without a tile computes a copy of tile 0 and writes nothing
    c.rg = tile < tiles ? tile / CG : 0;
    c.cgi = tile < tiles ? tile % CG : 0;

    // padding rows and columns stay zero
    const size_t total = 2 * (size_t)K2 * c.W + 8 * c.plane + 2 * c.xplane;
    for (size_t i = tid; i < total; i += blockDim.x) smem[i] = 0.f;
    if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // bytes one exchange brings into this CTA's Y: every row of the matrix
    const unsigned incoming = (unsigned)(sizeof(float) * 2 * d * c.W);
    unsigned phase = 0;  // parity of the exchange mbarrier
    const float scale = exp2f(-(float)s);
    const size_t dd = (size_t)d * d;
    const int n_clusters = gridDim.x / kCtas;
    const size_t n_items = (size_t)N_T * G;
    float ar[4][4], ai[4][4];
    GRAPE_CLOCK_START

    for (size_t item = blockIdx.x / kCtas; item < n_items;
         item += n_clusters) {
        const int n = (int)(item / G);
        const int g = (int)(item % G);
        float2* Uitem = U + item * dd;

        if (tid == 0) mbar_arrive_tx(bar, incoming);
        cluster.sync();  // every copy of Y free, every export landed

        // A's own rows, transposed into slab A and row-major into the export:
        // A = -i f H, f = dt 2^-s (Ar = f Hi, Ai = -f Hr)
        {
            const float2* H0g = H0 + (size_t)g * dd;
            const float2* opsg = ops + (size_t)g * T * dd;
            const float* co =
                coeffs + (size_t)g * coeff_group_stride + (size_t)n * T;
            const float f = dts[n] * scale;
            const int n_el = c.nrows * d;
            for (int base = tid; base < n_el; base += 2 * blockDim.x) {
                // two entries a thread, their operator loads in flight
                float2 h[2];
                size_t at[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int idx = min(base + u * (int)blockDim.x, n_el - 1);
                    const int rl = idx / d;
                    at[u] = (size_t)(c.row0 + rl) * d + (idx - rl * d);
                    h[u] = H0g[at[u]];
                }
                for (int t = 0; t < T; ++t) {
                    const float ct = co[t];
                    const float2 o0 = opsg[(size_t)t * dd + at[0]];
                    const float2 o1 = opsg[(size_t)t * dd + at[1]];
                    h[0].x += ct * o0.x;
                    h[0].y += ct * o0.y;
                    h[1].x += ct * o1.x;
                    h[1].y += ct * o1.y;
                }
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int idx = base + u * (int)blockDim.x;
                    if (idx >= n_el) continue;
                    const int rl = idx / d;
                    const int col = idx - rl * d;
                    const float vr = f * h[u].y;
                    const float vi = -f * h[u].x;
                    c.re(kA)[(size_t)col * c.P + rl] = vr;
                    c.im(kA)[(size_t)col * c.P + rl] = vi;
                    c.xre()[(size_t)rl * c.W + col] = vr;
                    c.xim()[(size_t)rl * c.W + col] = vi;
                }
            }
        }
        __syncthreads();
        push_export(c, bar);
        mbar_wait(bar, phase);  // Y = A
        phase ^= 1;
        GRAPE_CLOCK_MARK(0)

        // A^2, A^3 = (A, A^2) . A into their slabs; A^4 = A^3 . A into
        // the export only
        for (int m = kA; m <= kA3; ++m) {
            if (c.busy) slab_product(c, m, ar, ai);
            if (c.writer) {
                if (m < kA3) {
                    store_slab(c, m + 1, ar, ai);
                } else {
                    store_export(c, ar, ai);
                }
            }
            __syncthreads();
        }
        GRAPE_CLOCK_MARK(1)
        if (tid == 0) mbar_arrive_tx(bar, incoming);
        cluster.sync();  // every CTA done with Y = A; A^4 exported
        push_export(c, bar);

        // E = c12 I + c13 A + c14 A^2 + c15 A^3 + c16 A^4 (own rows; A^4
        // from the export), while the exchange runs
        for (int idx = tid; idx < c.nrows * d; idx += blockDim.x) {
            const int col = idx / c.nrows;
            const int rl = idx - col * c.nrows;
            const size_t at = (size_t)col * c.P + rl;
            const size_t ax = (size_t)rl * c.W + col;
            float er = (c.row0 + rl == col) ? c_fact_inv[12] : 0.f;
            float ei = 0.f;
            er += c_fact_inv[13] * c.re(kA)[at];
            ei += c_fact_inv[13] * c.im(kA)[at];
            er += c_fact_inv[14] * c.re(kA2)[at];
            ei += c_fact_inv[14] * c.im(kA2)[at];
            er += c_fact_inv[15] * c.re(kA3)[at];
            ei += c_fact_inv[15] * c.im(kA3)[at];
            er += c_fact_inv[16] * c.xre()[ax];
            ei += c_fact_inv[16] * c.xim()[ax];
            c.re(kE)[at] = er;
            c.im(kE)[at] = ei;
        }
        mbar_wait(bar, phase);  // Y = A^4
        phase ^= 1;
        __syncthreads();
        GRAPE_CLOCK_MARK(2)

        // Horner in A^4: E <- E A^4 + blk_b, b = 2, 1, 0 (in place; the
        // last into U, or exported for the first squaring)
        for (int b = 2; b >= 0; --b) {
            if (c.busy) slab_product(c, kE, ar, ai);
            if (c.writer) add_block(c, b, ar, ai);
            __syncthreads();
            if (c.writer) {
                if (b == 0 && s == 0) {
                    store_global(c, Uitem, ar, ai);
                } else {
                    store_slab(c, kE, ar, ai);
                    if (b == 0) store_export(c, ar, ai);
                }
            }
            __syncthreads();
        }
        GRAPE_CLOCK_MARK(4)

        // s squarings E <- E E, the last into U
        for (int q = 0; q < s; ++q) {
            if (tid == 0) mbar_arrive_tx(bar, incoming);
            cluster.sync();  // every copy of Y free; E exported
            push_export(c, bar);
            mbar_wait(bar, phase);  // Y = E
            phase ^= 1;
            if (c.busy) slab_product(c, kE, ar, ai);
            __syncthreads();
            if (c.writer) {
                if (q == s - 1) {
                    store_global(c, Uitem, ar, ai);
                } else {
                    store_slab(c, kE, ar, ai);
                    store_export(c, ar, ai);
                }
            }
            __syncthreads();
        }
        GRAPE_CLOCK_MARK(5)
    }
    cluster.sync();  // no CTA leaves while a copy into it may be in flight
    if (tid == 0) GRAPE_CLOCK_FLUSH(g_clock_pcl)
}

}  // namespace pcl
}  // namespace grape

GRAPE_CLOCK_READER(grape_propagators_cluster_clock, grape::pcl::g_clock_pcl)

extern "C" {

// Clusters the card holds at once at dimension d (0 if none), or a
// negative CUDA error code.
int grape_propagators_cluster_resident(int d) {
    using namespace grape::pcl;
    if (!fits(d)) return -(int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        propagator_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCtas, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, propagator_cluster_kernel, &cfg);
    if (err != cudaSuccess) return -(int)err;
    return n;
}

// U[n, g] = exp(-i dt_n H_ng) by the cluster kernel; arguments as
// grape_propagators (prop_scan.cu), without the scratch.
int grape_propagators_cluster(const void* H0, const void* ops,
                              const void* coeffs, const void* dts, int T,
                              int d, int N_T, int G,
                              long long coeff_group_stride, int s, void* U,
                              void* stream) {
    using namespace grape::pcl;
    cudaGetLastError();
    const int resident = grape_propagators_cluster_resident(d);
    if (resident < 0) return -resident;
    if (resident == 0) return (int)cudaErrorInvalidConfiguration;
    const long long items = (long long)N_T * G;
    const int n = (int)(items < resident ? items : resident);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCtas * n, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(d);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, propagator_cluster_kernel, (const float2*)H0,
        (const float2*)ops, (const float*)coeffs, (const float*)dts, T, d,
        N_T, G, (size_t)coeff_group_stride, s, (float2*)U);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
