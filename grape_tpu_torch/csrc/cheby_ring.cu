// Chebyshev-series propagation scan for ONE generator shared by K
// trajectories, forward (psi) or adjoint (the co-state chi), on a
// persistent grid that exchanges the series' vectors point to point: no
// grid-wide barrier.
//
// Replaces the two TPU Pallas kernels of grape_tpu/ops/pallas_prop.py
// (cheby_scan_pallas_shared, :956, planes resident in VMEM, and
// cheby_scan_pallas_stream, :1183, planes streamed per step), as the
// grid-barrier kernel of cheby_scan.cu did before it; that kernel stays
// the route where this one's buffers do not fit (hopper_cheby.cheby_route).
// The function is the same: per step n the normalised generator
// Hn = (2 H_n - shift I) / dE, H_n = H0 + sum_t c[n, t] Op_t, the
// n_cheby-term recursion phi_{m+1} = 2 Hn phi_m - phi_{m-1} on the (K, d)
// state block, acc = sum_m tab[n, m] phi_m and the new state ph[n] acc.
// The adjoint walks the time axis backwards with the wrapper's conjugate-
// transposed planes and emits the state ENTERING each step.
//
// What bounds it on this card.  One step is n_cheby - 1 DEPENDENT products
// of a d x d matrix with K vectors (8 K d^2 operations each), so at small
// K the floor is the latency of handing each new vector to every block,
// not arithmetic: at d = 1024, K = 4 a term is 33.5 MFLOP, 0.5 us of the
// card.  The grid-barrier kernel spent 6.9 us a term on two grid barriers,
// a restage of the whole vector into shared memory behind each, owner-only
// values round-tripped through L2, and rows of Hn formed on the critical
// path.  The design:
//
//   - PERSISTENT AND CO-RESIDENT: one CTA per SM (a cooperative launch,
//     refused if the grid cannot be resident), CTA b owning rows
//     [b rows, (b + 1) rows) of Hn, rows = ceil(d / SMs) <= 8;
//   - ROWS FORMED OFF THE CRITICAL PATH: a ninth warp forms the next
//     step's rows from the T + 1 planes (in L2) into the second of two
//     shared buffers, in split real / imaginary planes, while the eight
//     compute warps run the current step's terms; two mbarrier pairs
//     (full, empty) hand the buffers over.  Forming depends on the
//     coefficients only, never on the state;
//   - OWNER-ONLY VALUES ON CHIP: the slab's acc, phi_{m-1} and phi_{m-2}
//     live in shared memory, read and written only by the lane that owns
//     the entry; only the new phi_m slab leaves the CTA;
//   - EXCHANGE WITHOUT A BARRIER: every vector of the series gets a
//     sequence number e (step s, term m: e = s (n_cheby - 1) + m; the
//     state entering step s + 1 is its term 0).  The owner writes its slab
//     of vector e into ring slot e % 2 and then releases its flag
//     (st.release.gpu) with a count that covers e; each flag has a
//     128-byte line of its own (flags packed into a few lines made every
//     poll queue behind the others).  A consumer warp polls
//     (ld.acquire.gpu) only the flags of the blocks whose columns it
//     reads, shares them through __syncwarp, and loads those columns from
//     L2 (ld.global.cg) once they are there.
//     Two slots are enough: a block writes vector e + 2 into slot e % 2
//     only after it has read vector e + 1 from EVERY block, and a block
//     publishes e + 1 only after its loads of vector e are done (the
//     values went into e + 1); so no reader of vector e is left when the
//     slot is overwritten.  With K in chunks, the same holds per chunk;
//   - REUSE: a warp owns a tile of TR rows x TK trajectories and a range
//     of the columns; each lane keeps TR x TK complex sums in registers,
//     every h it loads from shared memory serves TK products and every
//     phi it loads from L2 serves TR.  The sums are folded across the
//     lanes by recursive halving (each level halves the values a lane
//     holds) and, where the columns are split over WJ warps, across those
//     through shared memory behind one named barrier of the WJ warps.
//     There is no restage of phi and no CTA-wide barrier inside a step.
//
// Full float32 FMAs, no tensor cores: the recursion compounds over
// n_cheby * N_T dependent products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sync.cuh"
#include "flag_ring.cuh"
#include "phase_clock.cuh"

namespace grape {
namespace cring {

constexpr int kComputeWarps = 8;
constexpr int kComputeThreads = 32 * kComputeWarps;
constexpr int kThreads = kComputeThreads + 32;  // + the row-forming warp
constexpr int kFormUnroll = 8;  // columns a forming lane has in flight
using exch::fold;
using exch::kFlagStride;
using exch::named_sync;
using exch::st_release;
using exch::wait_flag;
using exch::wait_phase;

GRAPE_CLOCK_TABLE(g_clock_cring)

struct Args {
    const float2* planes;  // (T + 1, d, d)
    const float* coeffs;   // (N_T, T)
    const float2* tab;     // (N_T, n_cheby)
    const float2* ph;      // (N_T,)
    const float2* psi0;    // (K, d)
    float2* ring;          // (2, K, d)
    unsigned* flags;       // (blocks, wk), zero at launch
    float2* out;           // (N_T, K, d)
    float shift, inv_dE;
    int T, d, K, N_T, n_cheby, adjoint, rows, wk, chunks;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

template <int TR, int TK>
__global__ void __launch_bounds__(kThreads, 1) cheby_ring_kernel(Args a) {
    constexpr int C0 = TR * TK;                     // sums of a warp tile
    constexpr int CF = C0 >= 32 ? C0 / 32 : 1;      // sums a lane keeps
    constexpr int S = C0 >= 32 ? 1 : 32 / C0;       // lanes per sum
    constexpr int JU = TK >= 4 ? 4 : 8;  // columns in flight
    extern __shared__ __align__(128) unsigned char ring_smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);  // [2]
    uint64_t* empty = full + 2;                               // [2]
    const int d = a.d, K = a.K, N_T = a.N_T, nc = a.n_cheby;
    const int rows = a.rows, WK = a.wk, chunks = a.chunks;
    const int WJ = kComputeWarps / WK;
    // Hn rows, split planes: hs[((b * 2 + plane) * TR + r) * d + j]
    float* hs = reinterpret_cast<float*>(ring_smem + 128);
    float2* st_acc = reinterpret_cast<float2*>(hs + (size_t)4 * TR * d);
    float2* st_p1 = st_acc + (size_t)K * rows;   // phi_{m-1} (term 0: psi)
    float2* st_p2 = st_p1 + (size_t)K * rows;    // phi_{m-2}
    float2* red = st_p2 + (size_t)K * rows;      // [2][warps][C0]

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int r0 = blockIdx.x * rows;
    const int nrows = min(rows, d - r0);  // >= 1 by the grid size
    const size_t Kd = (size_t)K * d;
    const size_t dd = (size_t)d * d;
    GRAPE_CLOCK_START

    // ---- set-up: barriers, the padded rows of both buffers, the slab ----
    if (tid == 0) {
        mbar_init(&full[0], 32);
        mbar_init(&full[1], 32);
        mbar_init(&empty[0], kComputeThreads);
        mbar_init(&empty[1], kComputeThreads);
    }
    for (int e = tid; e < 4 * (TR - nrows) * d; e += kThreads) {
        const int plane = e / ((TR - nrows) * d);  // (buffer, re / im)
        const int rest = e % ((TR - nrows) * d);
        hs[((size_t)plane * TR + nrows) * d + rest] = 0.f;
    }
    {
        const int n0 = a.adjoint ? N_T - 1 : 0;
        const float2 t0 = __ldg(a.tab + (size_t)n0 * nc);
        for (int e = tid; e < K * nrows; e += kThreads) {
            const int k = e / nrows, r = e % nrows;
            const size_t g = (size_t)k * d + r0 + r;
            const float2 p = __ldg(a.psi0 + g);
            st_p1[(size_t)k * rows + r] = p;
            st_acc[(size_t)k * rows + r] = cmul(t0, p);
            // chis[N_T - 1] = chi(T), the state entering the last step
            if (a.adjoint) a.out[(size_t)(N_T - 1) * Kd + g] = p;
        }
    }
    __syncthreads();

    if (warp == kComputeWarps) {
        // ---- the row-forming warp ------------------------------------------
        for (int s = 0; s < N_T; ++s) {
            const int b = s & 1;
            if (s >= 2) wait_phase(&empty[b], ((s >> 1) - 1) & 1);
            if (lane == 0) GRAPE_CLOCK_MARK(4)
            const int n = a.adjoint ? N_T - 1 - s : s;
            const float* c = a.coeffs + (size_t)n * a.T;
            float* hre = hs + (size_t)(b * 2) * TR * d;
            float* him = hre + (size_t)TR * d;
            for (int r = 0; r < nrows; ++r) {
                const int i = r0 + r;
                const float2* p0 = a.planes + (size_t)i * d;
                for (int j0 = lane; j0 < d; j0 += 32 * kFormUnroll) {
                    float2 h[kFormUnroll];
#pragma unroll
                    for (int u = 0; u < kFormUnroll; ++u) {
                        const int j = j0 + 32 * u;
                        h[u] = j < d ? __ldg(p0 + j) : make_float2(0.f, 0.f);
                    }
                    for (int t = 0; t < a.T; ++t) {
                        const float ct = __ldg(c + t);
                        const float2* pt = p0 + (size_t)(t + 1) * dd;
#pragma unroll
                        for (int u = 0; u < kFormUnroll; ++u) {
                            const int j = j0 + 32 * u;
                            if (j < d) {
                                const float2 o = __ldg(pt + j);
                                h[u].x = fmaf(ct, o.x, h[u].x);
                                h[u].y = fmaf(ct, o.y, h[u].y);
                            }
                        }
                    }
#pragma unroll
                    for (int u = 0; u < kFormUnroll; ++u) {
                        const int j = j0 + 32 * u;
                        if (j < d) {
                            float hr = 2.0f * h[u].x;
                            if (i == j) hr -= a.shift;
                            hre[(size_t)r * d + j] = hr * a.inv_dE;
                            him[(size_t)r * d + j] = 2.0f * h[u].y * a.inv_dE;
                        }
                    }
                }
            }
            mbar_arrive(&full[b]);
            if (lane == 0) GRAPE_CLOCK_MARK(6)
        }
        if (lane == 0) GRAPE_CLOCK_FLUSH(g_clock_cring)
        return;
    }

    // ---- the compute warps ------------------------------------------------
    const int wk = warp / WJ;        // k-group
    const int wj = warp % WJ;        // column range
    const int per = (d + WJ - 1) / WJ;
    const int ja = min(d, wj * per);
    const int jb = min(d, ja + per);
    const int p_lo = ja / rows;
    const int p_hi = jb > ja ? (jb - 1) / rows : p_lo - 1;
    const int n_iter = (jb - ja + 31) / 32;
    const bool owner_warp = wj == 0;
    const bool owner_lane = lane % S == 0;
    unsigned* my_flag =
        a.flags + ((size_t)blockIdx.x * WK + wk) * kFlagStride;
    unsigned q = 0;  // reductions so far (parity of the fold buffer)

    // the sums of JU columns of this lane into the warp's tile
    auto accumulate = [&](int it0, const float2 (&f)[JU][TK], float* vr,
                          float* vi, const float* hre, const float* him) {
#pragma unroll
        for (int u = 0; u < JU; ++u) {
            const int j = ja + lane + 32 * (it0 + u);
            if (j < jb) {
#pragma unroll
                for (int r = 0; r < TR; ++r) {
                    const float hr = hre[(size_t)r * d + j];
                    const float hi = him[(size_t)r * d + j];
#pragma unroll
                    for (int kk = 0; kk < TK; ++kk) {
                        const int i = r * TK + kk;
                        vr[i] = fmaf(hr, f[u][kk].x, vr[i]);
                        vr[i] = fmaf(-hi, f[u][kk].y, vr[i]);
                        vi[i] = fmaf(hr, f[u][kk].y, vi[i]);
                        vi[i] = fmaf(hi, f[u][kk].x, vi[i]);
                    }
                }
            }
        }
    };

    for (int s = 0; s < N_T; ++s) {
        const int b = s & 1;
        const int n = a.adjoint ? N_T - 1 - s : s;
        wait_phase(&full[b], (s >> 1) & 1);
        const float* hre = hs + (size_t)(b * 2) * TR * d;
        const float* him = hre + (size_t)TR * d;
        for (int m = 1; m < nc; ++m) {
            const unsigned e = (unsigned)s * (nc - 1) + (m - 1);  // source
            const bool from_psi0 = s == 0 && m == 1;
            const float2* src = from_psi0 ? a.psi0 : a.ring + (e & 1) * Kd;
            const bool last = m == nc - 1;
            const bool publish = !(last && s == N_T - 1);
            for (int x = 0; x < chunks; ++x, ++q) {
                const int kb = (x * WK + wk) * TK;
                if (tid == 0) GRAPE_CLOCK_MARK(5)
                if (!from_psi0) {
                    const unsigned target = e * chunks + x + 1;
                    for (int p = p_lo + lane; p <= p_hi; p += 32) {
                        wait_flag(a.flags + ((size_t)p * WK + wk) * kFlagStride,
                                  target);
                    }
                    __syncwarp();
                }
                if (tid == 0) GRAPE_CLOCK_MARK(0)
                float vr[C0], vi[C0];
#pragma unroll
                for (int i = 0; i < C0; ++i) vr[i] = vi[i] = 0.f;
                for (int it0 = 0; it0 < n_iter; it0 += JU) {
                    float2 f[JU][TK];
#pragma unroll
                    for (int u = 0; u < JU; ++u) {
                        const int j = ja + lane + 32 * (it0 + u);
#pragma unroll
                        for (int kk = 0; kk < TK; ++kk) {
                            f[u][kk] = (j < jb && kb + kk < K)
                                ? __ldcg(src + (size_t)(kb + kk) * d + j)
                                : make_float2(0.f, 0.f);
                        }
                    }
                    accumulate(it0, f, vr, vi, hre, him);
                }
                if (tid == 0) GRAPE_CLOCK_MARK(1)
                fold<C0>(vr, vi, lane);
                // the fold buffer of this k-group's WJ warps
                float2* rb = red + ((size_t)(q & 1) * kComputeWarps + wk * WJ) * C0;
                if (WJ > 1) {
                    if (owner_lane) {
#pragma unroll
                        for (int i = 0; i < CF; ++i) {
                            const int idx = i + CF * (lane / S);
                            rb[(size_t)wj * C0 + idx] = make_float2(vr[i], vi[i]);
                        }
                    }
                    named_sync(1 + wk, 32 * WJ);
                    if (owner_warp && owner_lane) {
#pragma unroll
                        for (int i = 0; i < CF; ++i) {
                            const int idx = i + CF * (lane / S);
                            float2 t = rb[idx];
                            for (int w = 1; w < WJ; ++w) {
                                const float2 o = rb[(size_t)w * C0 + idx];
                                t.x += o.x;
                                t.y += o.y;
                            }
                            vr[i] = t.x;
                            vi[i] = t.y;
                        }
                    }
                }
                if (tid == 0) GRAPE_CLOCK_MARK(2)
                if (owner_warp) {
                    if (owner_lane) {
                        const float2 cm = __ldg(a.tab + (size_t)n * nc + m);
                        float2* slot = a.ring + ((e + 1) & 1) * Kd;
#pragma unroll
                        for (int i = 0; i < CF; ++i) {
                            const int idx = i + CF * (lane / S);
                            const int r = idx / TK;
                            const int k = kb + idx % TK;
                            if (r >= nrows || k >= K) continue;
                            const size_t o = (size_t)k * rows + r;
                            const size_t g = (size_t)k * d + r0 + r;
                            float2 y = make_float2(vr[i], vi[i]);
                            if (m >= 2) {
                                const float2 p2 = st_p2[o];
                                y.x = 2.0f * y.x - p2.x;
                                y.y = 2.0f * y.y - p2.y;
                            }
                            float2 ac = st_acc[o];
                            ac.x = fmaf(cm.x, y.x, fmaf(-cm.y, y.y, ac.x));
                            ac.y = fmaf(cm.x, y.y, fmaf(cm.y, y.x, ac.y));
                            float2 pub = y;
                            if (!last) {
                                st_p2[o] = st_p1[o];
                                st_p1[o] = y;
                                st_acc[o] = ac;
                            } else {
                                // the step's new state
                                const float2 psi = cmul(__ldg(a.ph + n), ac);
                                if (!a.adjoint) {
                                    a.out[(size_t)n * Kd + g] = psi;
                                } else if (n > 0) {
                                    a.out[(size_t)(n - 1) * Kd + g] = psi;
                                }
                                if (!publish) continue;
                                const int n1 = a.adjoint ? n - 1 : n + 1;
                                const float2 t0 =
                                    __ldg(a.tab + (size_t)n1 * nc);
                                st_p1[o] = psi;
                                st_acc[o] = cmul(t0, psi);
                                pub = psi;
                            }
                            slot[g] = pub;
                        }
                    }
                    __syncwarp();
                    if (publish && lane == 0) {
                        st_release(my_flag, (e + 1) * chunks + x + 1);
                    }
                }
                if (tid == 0) GRAPE_CLOCK_MARK(3)
            }
        }
        mbar_arrive(&empty[b]);  // this step's rows are no longer read
    }
    if (tid == 0) GRAPE_CLOCK_FLUSH(g_clock_cring)
}

// shared bytes of the layout: barriers, two buffers of TR rows in split
// planes, the slab's three (K, rows) state arrays, two fold buffers of a
// warp tile per compute warp
static size_t ring_smem_bytes(int d, int K, int rows, int tr, int tk) {
    return 128 + (size_t)16 * tr * d + (size_t)24 * K * rows +
           (size_t)16 * kComputeWarps * tr * tk;
}

typedef void (*RingKernel)(Args);

static RingKernel ring_kernel(int tr, int tk) {
#define GRAPE_RING_CASE(R, C) \
    if (tr == R && tk == C) return cheby_ring_kernel<R, C>;
    GRAPE_RING_CASE(2, 1)
    GRAPE_RING_CASE(2, 4)
    GRAPE_RING_CASE(4, 1)
    GRAPE_RING_CASE(4, 4)
    GRAPE_RING_CASE(8, 1)
    GRAPE_RING_CASE(8, 4)
#undef GRAPE_RING_CASE
    return nullptr;
}

}  // namespace cring
}  // namespace grape

extern "C" {

// planes (T + 1, d, d): [H0, Op_1..Op_T] (forward) or their conjugate
// transposes (adjoint); coeffs (N_T, T) float; tab (N_T, n_cheby) and
// ph (N_T,) complex; psi0 (K, d); ring (2, K, d) complex; flags
// (blocks, wk, 32) unsigned, zero; out (N_T, K, d) complex.  The layout
// (rows per CTA, the warp tile tr x tk, wk k-groups, chunks of K, shared
// bytes) is hopper_cheby.cheby_route's;
// it is checked here, and a grid that cannot be co-resident gives
// cudaErrorCooperativeLaunchTooLarge.
int grape_cheby_ring(const void* planes, const void* coeffs, const void* tab,
                     const void* ph, float shift, float inv_dE,
                     const void* psi0, int T, int d, int K, int N_T,
                     int n_cheby, int adjoint, int rows, int tr, int tk,
                     int wk, int chunks, int smem, void* ring, void* flags,
                     void* out, void* stream) {
    using namespace grape::cring;
    cudaGetLastError();
    RingKernel kernel = ring_kernel(tr, tk);
    if (kernel == nullptr || N_T < 1 || n_cheby < 2 || T < 0 || d < 1 ||
        K < 1 || rows < 1 || rows > tr ||
        (wk != 1 && wk != 2 && wk != 4 && wk != 8) || chunks < 1 ||
        (long long)chunks * tk * wk < K ||
        (size_t)smem != ring_smem_bytes(d, K, rows, tr, tk)) {
        return (int)cudaErrorInvalidValue;
    }
    const int blocks = (d + rows - 1) / rows;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if ((long long)per_sm * sms < blocks) {
        return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    Args args;
    args.planes = (const float2*)planes;
    args.coeffs = (const float*)coeffs;
    args.tab = (const float2*)tab;
    args.ph = (const float2*)ph;
    args.psi0 = (const float2*)psi0;
    args.ring = (float2*)ring;
    args.flags = (unsigned*)flags;
    args.out = (float2*)out;
    args.shift = shift;
    args.inv_dE = inv_dE;
    args.T = T;
    args.d = d;
    args.K = K;
    args.N_T = N_T;
    args.n_cheby = n_cheby;
    args.adjoint = adjoint;
    args.rows = rows;
    args.wk = wk;
    args.chunks = chunks;
    void* params[] = {(void*)&args};
    err = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks),
                                      dim3(kThreads), params, (size_t)smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"

GRAPE_CLOCK_READER(grape_cheby_ring_clock, grape::cring::g_clock_cring)
