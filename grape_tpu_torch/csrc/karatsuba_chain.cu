// Chains of complex matrix products with the operands resident on chip:
// the throughput probe of the port's complex float32 products.
//
// Replaces the TPU Pallas kernel pallas_karatsuba_chain of
// experiments/mxu_probe.py (kernel body `kernel`, a grid over the batch
// whose every step runs a `reps`-long chain c <- c * b in VMEM with three
// real products per complex product, Karatsuba).
//
// What it computes: for each batch item b, starting from c = a,
//   reps times:  t1 = cr br,  t2 = ci bi,  t3 = (cr + ci)(br + bi),
//                cr <- t1 - t2,  ci <- t3 - t1 - t2
// (three real D x D products per complex product, as the TPU kernel), and
// writes c as interleaved complex64 (B, D, D).
//
// Design for the card, not block by block: the rows of c * b depend only
// on the same rows of c, so each block owns kRows = 32 rows of one item's
// c and runs the whole chain with no synchronisation between blocks.  The
// block keeps all of b in shared memory (two float32 planes, 128 KB at
// D = 128; br + bi is formed as the operands are read) and its rows of c,
// transposed (c^T[k][r]) so that a warp reads the rows it needs at one k
// contiguously; b's rows are padded by 8 floats and c^T's by 8 so that the
// tensor-core fragment loads below are free of bank conflicts.  Eight
// warps each own a 16-row x 32-column tile of the block's 32 x Dp output
// (Dp = D rounded up to 32, at most 128), keep its three partial products
// in registers, and after a block barrier write the new rows of c back in
// place.  Zero padding beyond D keeps every padded row and column zero.
//
//   precision "highest": full float32 FMAs, each thread 4 rows x 4 columns
//     (float4 shared loads; 48 FMAs to 4 loads a step), the regime of the
//     port's expm, Fréchet and scan kernels.  Bound by the float32 FMA rate
//     (67 TFLOP/s counted as 8 D^3 per complex product; Karatsuba does 6
//     D^3 real operations and the padded columns at D = 100 cost 1.64x).
//   precision "default": TF32 tensor cores (mma.sync m16n8k8, operands
//     rounded to TF32 with cvt.rna, float32 accumulation), the card's
//     counterpart of the TPU's one-pass reduced-precision MXU product.  A
//     probe only: no chain of the optimizer uses TF32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;      // rows of c per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDim = 128;   // largest D (two b planes in shared memory)
constexpr int kPad = 8;        // row padding of the shared planes (floats)
constexpr int kCStride = kRows + kPad;

__host__ __device__ inline int round_up32(int d) { return (d + 31) / 32 * 32; }

__host__ __device__ inline size_t smem_bytes(int dp) {
    return sizeof(float) * (size_t)(2 * dp * (dp + kPad) + 2 * dp * kCStride);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// d[0..3] += A (16 x 8, row-major fragment) * B (8 x 8, column fragment)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One complex product of the warp's 16 x 32 tile in float32 FMAs; the new
// entries are written to c^T after the block barrier.
__device__ __forceinline__ void product_fma(float* sbr, float* sbi,
                                            float* scr, float* sci, int D,
                                            int bs, int rb, int cb,
                                            bool active) {
    const int lane = threadIdx.x & 31;
    const int r0 = rb + (lane >> 3) * 4;  // the thread's 4 rows
    const int c0 = cb + (lane & 7) * 4;   // and 4 columns
    float t1[4][4], t2[4][4], t3[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) t1[i][j] = t2[i][j] = t3[i][j] = 0.f;
    if (active) {
#pragma unroll 4
        for (int k = 0; k < D; ++k) {
            const float4 cr = *reinterpret_cast<const float4*>(
                &scr[k * kCStride + r0]);
            const float4 ci = *reinterpret_cast<const float4*>(
                &sci[k * kCStride + r0]);
            const float4 br = *reinterpret_cast<const float4*>(
                &sbr[k * bs + c0]);
            const float4 bi = *reinterpret_cast<const float4*>(
                &sbi[k * bs + c0]);
            const float vr[4] = {cr.x, cr.y, cr.z, cr.w};
            const float vi[4] = {ci.x, ci.y, ci.z, ci.w};
            const float wr[4] = {br.x, br.y, br.z, br.w};
            const float wi[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float vs = vr[i] + vi[i];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    t1[i][j] = fmaf(vr[i], wr[j], t1[i][j]);
                    t2[i][j] = fmaf(vi[i], wi[j], t2[i][j]);
                    t3[i][j] = fmaf(vs, wr[j] + wi[j], t3[i][j]);
                }
            }
        }
    }
    __syncthreads();  // every warp has read the old c
    if (active) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float4 nr, ni;
            nr.x = t1[0][j] - t2[0][j];
            nr.y = t1[1][j] - t2[1][j];
            nr.z = t1[2][j] - t2[2][j];
            nr.w = t1[3][j] - t2[3][j];
            ni.x = t3[0][j] - t1[0][j] - t2[0][j];
            ni.y = t3[1][j] - t1[1][j] - t2[1][j];
            ni.z = t3[2][j] - t1[2][j] - t2[2][j];
            ni.w = t3[3][j] - t1[3][j] - t2[3][j];
            *reinterpret_cast<float4*>(&scr[(c0 + j) * kCStride + r0]) = nr;
            *reinterpret_cast<float4*>(&sci[(c0 + j) * kCStride + r0]) = ni;
        }
    }
    __syncthreads();  // the new c is complete
}

// One complex product of the warp's 16 x 32 tile on the TF32 tensor cores
// (four m16n8k8 column tiles, three products each per step of 8 in k).
__device__ __forceinline__ void product_tf32(float* sbr, float* sbi,
                                             float* scr, float* sci, int D,
                                             int bs, int rb, int cb,
                                             bool active) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // group of the fragment layouts
    const int t = lane & 3;   // thread within the group
    float t1[4][4], t2[4][4], t3[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) t1[j][q] = t2[j][q] = t3[j][q] = 0.f;
    if (active) {
        const int dk = (D + 7) / 8 * 8;
        for (int k0 = 0; k0 < dk; k0 += 8) {
            // A fragment: (row g, col t), (g+8, t), (g, t+4), (g+8, t+4)
            const int ka = (k0 + t) * kCStride + rb + g;
            const int kb = (k0 + t + 4) * kCStride + rb + g;
            const float xr[4] = {scr[ka], scr[ka + 8], scr[kb], scr[kb + 8]};
            const float xi[4] = {sci[ka], sci[ka + 8], sci[kb], sci[kb + 8]};
            uint32_t ar[4], ai[4], as[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                ar[q] = to_tf32(xr[q]);
                ai[q] = to_tf32(xi[q]);
                as[q] = to_tf32(xr[q] + xi[q]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                // B fragment: (row t, col g), (row t+4, col g)
                const int c = cb + 8 * j + g;
                const float yr0 = sbr[(k0 + t) * bs + c];
                const float yr1 = sbr[(k0 + t + 4) * bs + c];
                const float yi0 = sbi[(k0 + t) * bs + c];
                const float yi1 = sbi[(k0 + t + 4) * bs + c];
                const uint32_t br[2] = {to_tf32(yr0), to_tf32(yr1)};
                const uint32_t bi[2] = {to_tf32(yi0), to_tf32(yi1)};
                const uint32_t bsum[2] = {to_tf32(yr0 + yi0),
                                          to_tf32(yr1 + yi1)};
                mma_tf32(t1[j], ar, br);
                mma_tf32(t2[j], ai, bi);
                mma_tf32(t3[j], as, bsum);
            }
        }
    }
    __syncthreads();
    if (active) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            // accumulator: (row g, col 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = rb + g + (q >> 1) * 8;
                const int c = cb + 8 * j + 2 * t + (q & 1);
                scr[c * kCStride + r] = t1[j][q] - t2[j][q];
                sci[c * kCStride + r] = t3[j][q] - t1[j][q] - t2[j][q];
            }
        }
    }
    __syncthreads();
}

template <bool kTf32>
__global__ void __launch_bounds__(kThreads, 1)
karatsuba_chain_kernel(const float* __restrict__ ar,
                       const float* __restrict__ ai,
                       const float* __restrict__ br,
                       const float* __restrict__ bi, float2* __restrict__ out,
                       int D, int reps) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int dp = round_up32(D);
    const int bs = dp + kPad;
    float* sbr = smem;
    float* sbi = sbr + dp * bs;
    float* scr = sbi + dp * bs;
    float* sci = scr + dp * kCStride;

    const size_t item = blockIdx.y;
    const int row0 = blockIdx.x * kRows;
    const size_t off = item * (size_t)D * D;

    // b, zero-padded to dp x dp
    for (int idx = threadIdx.x; idx < dp * dp; idx += kThreads) {
        const int k = idx / dp;
        const int c = idx - k * dp;
        const bool in = k < D && c < D;
        sbr[k * bs + c] = in ? br[off + (size_t)k * D + c] : 0.f;
        sbi[k * bs + c] = in ? bi[off + (size_t)k * D + c] : 0.f;
    }
    // the block's rows of a, transposed, zero-padded
    for (int idx = threadIdx.x; idx < kRows * dp; idx += kThreads) {
        const int r = idx / dp;
        const int k = idx - r * dp;
        const bool in = row0 + r < D && k < D;
        scr[k * kCStride + r] =
            in ? ar[off + (size_t)(row0 + r) * D + k] : 0.f;
        sci[k * kCStride + r] =
            in ? ai[off + (size_t)(row0 + r) * D + k] : 0.f;
    }
    __syncthreads();

    // warp w owns the 16-row x 32-column tile (w / col_tiles, w % col_tiles)
    const int warp = threadIdx.x >> 5;
    const int col_tiles = dp / 32;
    const bool active = warp < 2 * col_tiles;
    const int rb = (warp / col_tiles) * 16;
    const int cb = (warp % col_tiles) * 32;
    for (int rep = 0; rep < reps; ++rep) {
        if (kTf32) {
            product_tf32(sbr, sbi, scr, sci, D, bs, rb, cb, active);
        } else {
            product_fma(sbr, sbi, scr, sci, D, bs, rb, cb, active);
        }
    }

    for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
        const int r = idx / D;
        const int c = idx - r * D;
        if (row0 + r < D) {
            out[off + (size_t)(row0 + r) * D + c] =
                make_float2(scr[c * kCStride + r], sci[c * kCStride + r]);
        }
    }
}

}  // namespace

extern "C" {

// out (B, D, D) complex64 <- a (B, D, D) times b (B, D, D), reps times;
// planes ar, ai, br, bi float32.  tf32 != 0: TF32 tensor cores.
int grape_karatsuba_chain(const void* ar, const void* ai, const void* br,
                          const void* bi, void* out, int B, int D, int reps,
                          int tf32, void* stream) {
    if (B < 1 || D < 1 || D > kMaxDim || reps < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = smem_bytes(round_up32(D));
    const dim3 grid((D + kRows - 1) / kRows, B);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (tf32) {
        err = cudaFuncSetAttribute(karatsuba_chain_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        karatsuba_chain_kernel<true><<<grid, kThreads, smem, s>>>(
            (const float*)ar, (const float*)ai, (const float*)br,
            (const float*)bi, (float2*)out, D, reps);
    } else {
        err = cudaFuncSetAttribute(karatsuba_chain_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        karatsuba_chain_kernel<false><<<grid, kThreads, smem, s>>>(
            (const float*)ar, (const float*)ai, (const float*)br,
            (const float*)bi, (float2*)out, D, reps);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
