// The state-chain scans for Hopper: one design run in both directions,
//
//   forward:  psi <- psi U_ng^T,     emitting storage[n] = psi(t_n)
//   co-state: chi <- chi conj(U_ng), emitting chis[n] = chi(t_{n+1})
//
// over stored propagators U (N_T, G, d, d), K = G * gs trajectories in G
// groups of gs.  Replaces forward_apply_kernel and chi_scan_kernel of
// prop_scan.cu, i.e. the apply half of forward_scan_pallas_shared,
// forward_scan_pallas_grouped and forward_scan_pallas (grape_tpu/ops/
// pallas_prop.py:373, :494, :144) and chi_scan_pallas_shared (:607) with
// its grouped and windowed (recompute) uses.  The co-state contract is
// chi_scan_kernel's: chis[n] is chi BEFORE the update by U_n; with x_out
// the update by U_0 is applied too and its result written there, the
// co-state carried out of a window of steps.
//
// What bounds it: each step reads U_n once (8 d^2 bytes) and does 8 K d^2
// operations, so the byte bound is small (50 us for the CZ's 2000 steps);
// the real limit is the latency of N_T dependent steps.  One block per
// chain chunk, as before, pulls the whole 80 KB of U_n through one SM each
// step.  Here:
//
// - A chunk (<= KB trajectories of one group, KB = 1, 2 or 4 by the group
//   size, so that gs = 1 carries one state) runs on a CLUSTER of C CTAs.
//   CTA j owns the output entries o0..o1 of the state (rows of U forward,
//   columns of U for the co-state; pairs of entries where d is even) and
//   streams only its slab of U_n: at the CZ's shape C = 16 SMs load 5-6 KB
//   each per step.
// - U does not depend on the state, so a service warp keeps the slabs of
//   the next steps in flight into a shared-memory ring (up to 8 stages,
//   a full and an empty mbarrier per slot): one TMA tensor copy per step
//   (a box of the slab's rows or columns, cp.async.bulk.tensor) where d is
//   even and at most 256, element copies (cp.async) otherwise.
// - Each group of eight lanes of a compute warp forms one output entry, in
//   the summation order of the one-block scans (the same bits on the same
//   propagators), and pushes it into every CTA's next state buffer by
//   st.async, which completes on that CTA's mbarrier of the buffer.  With three state buffers no barrier is needed between steps:
//   a CTA waits only until every entry of its next state has landed, and
//   a buffer is rewritten only after every CTA has read the state in it.
//   The warps write the emitted states from their registers.
// - The cluster size is chosen by ops/hopper_prop.py scan_route from the
//   number of chunks and the SM count (16 for one chunk, 1 where the
//   chunks alone fill the card), and grown where a slab ring of two
//   stages would not fit; the ring depth by the shared memory left.
//
// Float32 FMAs in the 4-product complex form (the chains compound over N_T
// steps: no reduced precision).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sync.cuh"
#include "phase_clock.cuh"

namespace cg = cooperative_groups;

namespace grape {
namespace ssc {

constexpr int kComputeWarps = 8;
constexpr int kThreads = 32 * (kComputeWarps + 1);  // + the service warp
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSmem = 232448;
// mbarriers: ring full and empty per slot, one per state buffer (padded)
constexpr int kHeadBytes = 256;
constexpr int kMaxTmaBox = 256;

// this CTA's first output entry: pairs of entries where d is even (so that
// every slab row or column segment is a whole number of 16-byte units)
__host__ __device__ inline int entry0(int d, int cluster, int rank) {
    if (d % 2 == 0) return 2 * (int)((long long)rank * (d / 2) / cluster);
    return (int)((long long)rank * d / cluster);
}

// most entries one CTA owns
__host__ __device__ inline int max_entries(int d, int cluster) {
    if (d % 2 == 0) return 2 * ((d / 2 + cluster - 1) / cluster);
    return (d + cluster - 1) / cluster;
}

// pitch (float2) of a co-state slab row: >= max_entries and = 2 mod 4, so
// that sixteen lanes reading one column meet at most two to a bank
__host__ __device__ inline int chi_pitch(int d, int cluster) {
    const int n = max_entries(d, cluster);
    return n + ((2 - n % 4) + 4) % 4;
}

// float2 per ring slot, a multiple of 16 (TMA writes 128-byte aligned)
__host__ __device__ inline size_t slot_elems(int d, int cluster) {
    const size_t n = (size_t)d * chi_pitch(d, cluster);
    return (n + 15) / 16 * 16;
}

// float2 from the state buffers' start to the ring (128-byte aligned)
__host__ __device__ inline size_t ring_offset(int d, int kb) {
    return ((size_t)3 * kb * d + 15) / 16 * 16;
}

// mbarriers, three state buffers, the ring; mirrored by ops/hopper_prop.py
// _scan_smem
__host__ __device__ inline size_t smem_bytes(int d, int kb, int cluster,
                                             int stages) {
    return kHeadBytes +
           8 * (ring_offset(d, kb) + (size_t)stages * slot_elems(d, cluster));
}

// phases per step (thread 0, a compute thread): 0 waits for the state and
// the slot, 3 products and reduction, 4 pushes, 1 emission and release of
// the slot
GRAPE_CLOCK_TABLE(g_clock_ssc)

// TMA copy of the box at (x, y, z) of a 3-d tensor map into this CTA's
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, int z, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
            smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
        "r"(smem_addr(bar))
        : "memory");
}

// an entry's KB values (the state is stored [entry][KB]) into a
// cluster shared-memory address, 16 bytes a store
template <int KB>
__device__ __forceinline__ void push_entry(unsigned addr,
                                           const float2 (&a)[KB],
                                           unsigned bar) {
    if (KB == 1) {
        st_async(addr, a[0], bar);
    } else {
#pragma unroll
        for (int k = 0; k + 1 < KB; k += 2) {
            st_async(addr + 8 * k,
                     make_float4(a[k].x, a[k].y, a[k + 1].x, a[k + 1].y),
                     bar);
        }
    }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
            smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ float2 cmul_acc(float2 acc, float2 u, float2 v) {
    acc.x = fmaf(u.x, v.x, acc.x);
    acc.x = fmaf(-u.y, v.y, acc.x);
    acc.y = fmaf(u.x, v.y, acc.y);
    acc.y = fmaf(u.y, v.x, acc.y);
    return acc;
}

// The new value of output entry o of the state (valid: o is one of the
// CTA's entries; every lane calls, for the shuffles), computed by one group
// of eight lanes in the summation order of the one-block scans of
// prop_scan.cu, so that both routes give the same bits on the same
// propagators: lane s sums the terms i = s, s + 8, ... in order, then the
// forward scan adds the eight partial sums as a tree (xor 4, 2, 1) and the
// co-state scan adds them in lane order from zero.  Every lane of the
// group ends with the sum.
template <bool CHI, int KB>
__device__ __forceinline__ void entry_dot(const float2* S, const float2* cur,
                                          int d, int pitch, int o, bool valid,
                                          int lane, float2 (&acc)[KB]) {
    const int s = lane & 7;
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[k] = make_float2(0.f, 0.f);
    if (valid) {
#pragma unroll 4
        for (int i = s; i < d; i += 8) {
            float2 v[KB];
            if (KB == 1) {
                v[0] = cur[i];
            } else {
#pragma unroll
                for (int k = 0; k + 1 < KB; k += 2) {
                    const float4 p =
                        *reinterpret_cast<const float4*>(cur + i * KB + k);
                    v[k] = make_float2(p.x, p.y);
                    v[k + 1] = make_float2(p.z, p.w);
                }
            }
            if (CHI) {
                float2 u = S[(size_t)i * pitch + o];
                u.y = -u.y;  // conj(U)
#pragma unroll
                for (int k = 0; k < KB; ++k) acc[k] = cmul_acc(acc[k], v[k], u);
            } else {
                const float2 u = S[(size_t)o * d + i];
#pragma unroll
                for (int k = 0; k < KB; ++k) acc[k] = cmul_acc(acc[k], u, v[k]);
            }
        }
    }
    if (!CHI) {
#pragma unroll
        for (int k = 0; k < KB; ++k) {
#pragma unroll
            for (int off = 4; off > 0; off >>= 1) {
                acc[k].x += __shfl_xor_sync(0xffffffffu, acc[k].x, off);
                acc[k].y += __shfl_xor_sync(0xffffffffu, acc[k].y, off);
            }
        }
    } else {
        const int base = lane & ~7;
#pragma unroll
        for (int k = 0; k < KB; ++k) {
            float2 sum = make_float2(0.f, 0.f);
#pragma unroll
            for (int g = 0; g < 8; ++g) {
                sum.x += __shfl_sync(0xffffffffu, acc[k].x, base + g);
                sum.y += __shfl_sync(0xffffffffu, acc[k].y, base + g);
            }
            acc[k] = sum;
        }
    }
}

template <bool CHI, int KB>
__global__ void __launch_bounds__(kThreads, 1)
state_scan_kernel(const __grid_constant__ CUtensorMap umap, int use_tma,
                  const float2* __restrict__ U,
                  const float2* __restrict__ x0, float2* __restrict__ out,
                  float2* __restrict__ x_out, int N_T, int K, int d, int G,
                  int gs, int stages) {
    extern __shared__ __align__(128) float4 smem4[];
    uint64_t* ring_full = reinterpret_cast<uint64_t*>(smem4);
    uint64_t* ring_empty = ring_full + kMaxStages;
    uint64_t* state_full = ring_empty + kMaxStages;  // one per state buffer
    float2* st = reinterpret_cast<float2*>(
        reinterpret_cast<char*>(smem4) + kHeadBytes);  // 3 state buffers
    float2* ring = st + ring_offset(d, KB);
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // the chunk: KB (or fewer) trajectories of one group
    const int chunk = blockIdx.x / C;
    const int per_group = (gs + KB - 1) / KB;
    const int g = chunk / per_group;
    const int j0 = (chunk - g * per_group) * KB;
    const int k0 = g * gs + j0;
    const int kn = min(KB, gs - j0);
    // this CTA's output entries o0 .. o0 + no - 1
    const int o0 = entry0(d, C, rank);
    const int no = entry0(d, C, rank + 1) - o0;
    const int busy_warps = min(kComputeWarps, (no + 3) / 4);
    const int pitch = chi_pitch(d, C);
    const size_t slot = slot_elems(d, C);
    const size_t dd = (size_t)d * d;
    const size_t state = (size_t)KB * d;  // float2 per state buffer
    // TMA box: rows o0.. (max_entries of them) of all d columns, or
    // columns o0.. (pitch of them) of all d rows; the box's bytes
    const unsigned box_bytes =
        (unsigned)(8 * (size_t)d * (CHI ? pitch : max_entries(d, C)));
    // updates (U_0 .. U_{N_T-1} forward; U_{N_T-1} .. U_1, and U_0 with
    // x_out, for the co-state) and emitted states (state m is storage[m]
    // forward, chis[N_T-1-m] for the co-state)
    const int n_upd = CHI ? (x_out != nullptr ? N_T : N_T - 1) : N_T;
    const int n_emit = CHI ? N_T : N_T + 1;
    auto out_row = [&](int m) -> float2* {
        return out + ((size_t)(CHI ? N_T - 1 - m : m) * K + k0) * d + o0;
    };

    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(ring_full + i, use_tma ? 1 : 32);
            mbar_init(ring_empty + i, max(1, busy_warps));
        }
        for (int b = 0; b < 3; ++b) mbar_init(state_full + b, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // state 0 into buffer 0 (stored [entry][KB]); its own entries emitted
    for (int idx = tid; idx < KB * d; idx += blockDim.x) {
        const int k = idx / d;
        const int i = idx - k * d;
        st[i * KB + k] = (k < kn) ? x0[(size_t)k0 * d + idx]
                                  : make_float2(0.f, 0.f);
    }
    for (int e = tid; e < kn * no; e += blockDim.x) {
        const int k = e / no;
        const int o = e - k * no;
        out_row(0)[(size_t)k * d + o] = x0[(size_t)(k0 + k) * d + o0 + o];
    }
    cluster.sync();  // every CTA's mbarriers ready before any push
    GRAPE_CLOCK_START

    if (warp == kComputeWarps) {
        // the service warp: CTA's slab of each step's propagator into the
        // ring, up to `stages` steps ahead (rows o0.. stored [o][i], pitch
        // d, or columns o0.. stored [i][o], pitch `pitch`)
        for (int j = 0; no > 0 && j < n_upd; ++j) {
            if (use_tma && lane != 0) break;
            const int sl = j % stages;
            if (j >= stages) {
                mbar_wait(ring_empty + sl, (unsigned)((j / stages - 1) & 1));
            }
            const int n = CHI ? N_T - 1 - j : j;
            float2* dst = ring + (size_t)sl * slot;
            if (use_tma) {
                mbar_arrive_tx(ring_full + sl, box_bytes);
                if (CHI) {
                    tma_box(dst, &umap, o0, 0, n * G + g, ring_full + sl);
                } else {
                    tma_box(dst, &umap, 0, o0, n * G + g, ring_full + sl);
                }
            } else {
                const float2* Un = U + ((size_t)n * G + g) * dd;
                for (int e = lane; e < no * d; e += 32) {
                    if (!CHI) {
                        cp_async8(dst + e, Un + (size_t)o0 * d + e);
                    } else {
                        const int i = e / no;
                        const int o = e - i * no;
                        cp_async8(dst + (size_t)i * pitch + o,
                                  Un + (size_t)i * d + o0 + o);
                    }
                }
                cp_async_arrive(ring_full + sl);
            }
        }
    } else if (warp < busy_warps) {
        // a compute warp: four entries at a time, one per group of eight
        // lanes (entries 4 warp + q, + 32, ...); lane s of a group pushes
        // the group's new entry into CTAs s and s + 8 (st.async into their
        // next state buffer, completing on their mbarrier of it)
        const int q = lane >> 3;
        const int s = lane & 7;
        unsigned peer_st[2] = {0u, 0u}, peer_bar[2] = {0u, 0u};
        bool pusher[2] = {false, false};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int t = s + 8 * h;
            pusher[h] = t < C && entry0(d, C, t + 1) > entry0(d, C, t);
            if (pusher[h]) {
                peer_st[h] = cluster_addr(smem_addr(st), t);
                peer_bar[h] = cluster_addr(smem_addr(state_full), t);
            }
        }
        for (int j = 0; j < n_upd; ++j) {
            const int m = j + 1;  // the state this step forms
            const bool push = m < n_upd;
            if (j > 0) {
                mbar_wait(state_full + j % 3, (unsigned)(((j - 1) / 3) & 1));
            }
            if (tid == 0 && push) {
                mbar_arrive_tx(state_full + m % 3, (unsigned)(8 * state));
            }
            mbar_wait(ring_full + j % stages, (unsigned)((j / stages) & 1));
            GRAPE_CLOCK_MARK(0)
            const float2* cur = st + (size_t)(j % 3) * state;
            const float2* S = ring + (size_t)(j % stages) * slot;
            // lane k of a group emits trajectory k's entry of state m, or
            // hands the co-state carried out of the window back
            float2* dst = nullptr;
            if (m < n_emit) {
                dst = out_row(m);
            } else if (CHI && x_out != nullptr) {
                dst = x_out + (size_t)k0 * d + o0;
            }
            for (int b = 4 * warp; b < no; b += 4 * kComputeWarps) {
                const int o = b + q;
                const bool valid = o < no;
                float2 acc[KB];
                entry_dot<CHI, KB>(S, cur, d, pitch, o, valid, lane, acc);
                GRAPE_CLOCK_MARK(3)
                if (valid && push) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        if (pusher[h]) {
                            push_entry<KB>(peer_st[h] + (unsigned)(8 * (
                                               (m % 3) * state +
                                               KB * (o0 + o))),
                                           acc,
                                           peer_bar[h] + (unsigned)(8 * (m % 3)));
                        }
                    }
                }
                GRAPE_CLOCK_MARK(4)
                if (valid && dst != nullptr) {
#pragma unroll
                    for (int k = 0; k < KB; ++k) {
                        if (s == k && k < kn) dst[(size_t)k * d + o] = acc[k];
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(ring_empty + j % stages);
            GRAPE_CLOCK_MARK(1)
        }
    }
    cluster.sync();  // no CTA leaves while a push into it may be in flight
    if (tid == 0) GRAPE_CLOCK_FLUSH(g_clock_ssc)
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The tensor map of U (N_T * G items of d x d complex, 8-byte elements)
// with this CTA's box; false where TMA does not apply (odd d, d > 256,
// U not 16-byte aligned) and the element copies run instead.
static bool encode_map(CUtensorMap* map, bool chi, const void* U, int items,
                       int d, int cluster) {
    if (d % 2 != 0 || d > kMaxTmaBox ||
        (reinterpret_cast<uintptr_t>(U) & 15) != 0 || U == nullptr) {
        return false;
    }
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                    cudaEnableDefault, &q) != cudaSuccess ||
            q != cudaDriverEntryPointSuccess || fn == nullptr) {
            return false;
        }
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)d,
                                (cuuint64_t)items};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 8,
                                   (cuuint64_t)d * d * 8};
    const cuuint32_t box[3] = {
        chi ? (cuuint32_t)chi_pitch(d, cluster) : (cuuint32_t)d,
        chi ? (cuuint32_t)d : (cuuint32_t)max_entries(d, cluster), 1};
    const cuuint32_t ones[3] = {1, 1, 1};
    if (box[0] > kMaxTmaBox) return false;
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3,
                  const_cast<void*>(U), dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool CHI, int KB>
static cudaError_t launch(const void* U, const void* x0, void* out,
                          void* x_out, int N_T, int K, int d, int G, int gs,
                          int cluster, int stages, cudaStream_t stream,
                          int* resident) {
    auto kernel = state_scan_kernel<CHI, KB>;
    const size_t smem = smem_bytes(d, KB, cluster, stages);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (cluster > 8) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    const int chunks = G * ((gs + KB - 1) / KB);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(chunks * cluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (resident != nullptr) {
        return cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
    }
    CUtensorMap map = {};
    const int use_tma = encode_map(&map, CHI, U, N_T * G, d, cluster);
    return cudaLaunchKernelEx(&cfg, kernel, map, use_tma, (const float2*)U,
                              (const float2*)x0, (float2*)out,
                              (float2*)x_out, N_T, K, d, G, gs, stages);
}

static cudaError_t dispatch(int chi, int kb, const void* U, const void* x0,
                            void* out, void* x_out, int N_T, int K, int d,
                            int G, int gs, int cluster, int stages,
                            cudaStream_t stream, int* resident) {
#define GRAPE_SSC(C_, KB_)                                                  \
    return launch<C_, KB_>(U, x0, out, x_out, N_T, K, d, G, gs, cluster,   \
                           stages, stream, resident)
    if (chi) {
        if (kb == 1) GRAPE_SSC(true, 1);
        if (kb == 2) GRAPE_SSC(true, 2);
        GRAPE_SSC(true, 4);
    }
    if (kb == 1) GRAPE_SSC(false, 1);
    if (kb == 2) GRAPE_SSC(false, 2);
    GRAPE_SSC(false, 4);
#undef GRAPE_SSC
}

static bool valid(int K, int d, int G, int gs, int kb, int cluster,
                  int stages) {
    return G >= 1 && gs >= 1 && G * gs == K && d >= 1 &&
           (kb == 1 || kb == 2 || kb == 4) && cluster >= 1 &&
           cluster <= kMaxCluster && cluster <= d && stages >= 2 &&
           stages <= kMaxStages &&
           smem_bytes(d, kb, cluster, stages) <= kMaxSmem;
}

}  // namespace ssc
}  // namespace grape

GRAPE_CLOCK_READER(grape_state_scan_clock, grape::ssc::g_clock_ssc)

extern "C" {

// Clusters of this plan the card holds at once (0 if none), or a negative
// CUDA error code.
int grape_state_scan_resident(int chi, int d, int G, int gs, int kb,
                              int cluster, int stages) {
    if (!grape::ssc::valid(G * gs, d, G, gs, kb, cluster, stages)) {
        return -(int)cudaErrorInvalidValue;
    }
    int n = 0;
    cudaError_t err = grape::ssc::dispatch(
        chi, kb, nullptr, nullptr, nullptr, nullptr, 1, G * gs, d, G, gs,
        cluster, stages, nullptr, &n);
    return err == cudaSuccess ? n : -(int)err;
}

// chi == 0: storage (N_T+1, K, d) from psi0 = x0 (K, d); chi != 0: chis
// (N_T, K, d) from chi_hat = x0, and with x_out (K, d) the co-state carried
// out of the window (null: not wanted).  U (N_T, G, d, d).  kb, cluster
// and stages as ops/hopper_prop.py scan_route gives them.
int grape_state_scan(const void* U, const void* x0, void* out, void* x_out,
                     int chi, int N_T, int K, int d, int G, int gs, int kb,
                     int cluster, int stages, void* stream) {
    cudaGetLastError();
    if (N_T < 1 || !grape::ssc::valid(K, d, G, gs, kb, cluster, stages)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = grape::ssc::dispatch(
        chi, kb, U, x0, out, x_out, N_T, K, d, G, gs, cluster, stages,
        (cudaStream_t)stream, nullptr);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
