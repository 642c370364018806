// The state chains past the cluster scan's ring: one design run in both
// directions over stored propagators U (N_T, G, d, d), K = G * gs
// trajectories in G groups of gs,
//
//   forward:  psi <- psi U_ng^T,     emitting storage[n] = psi(t_n)
//   co-state: chi <- chi conj(U_ng), emitting chis[n] = chi(t_{n+1})
//
// with the contract of state_scan.cu (chis[n] is chi BEFORE the update by
// U_n; with x_out the update by U_0 is applied too and its result written
// there).  Replaces, where not even a ring of two slabs of the cluster scan
// fits shared memory (ops/hopper_prop.py scan_route: from d = 417 at one
// group of 4 on 132 SMs), the one-block scans of prop_scan.cu: the apply
// half of forward_scan_pallas_shared, _grouped and forward_scan_pallas
// (grape_tpu/ops/pallas_prop.py:373, :494, :144) and chi_scan_pallas_shared
// (:607).
//
// What bounds it: each step reads U_n once, 8 d^2 bytes (8.4 MB at
// d = 1024: 2.5 us from device memory), and does 8 kb d^2 operations; the
// steps depend on each other, so the latency of handing the new state to
// every SM adds to each.  One block per chunk pulled all of U_n through one
// SM (about 230 us a step at d = 1024).  Here:
//
//   - A CO-RESIDENT GRID, one CTA per SM (a cooperative launch, refused
//     where the grid cannot be resident).  The chunks (up to kb = 1, 2 or
//     4 states of one group) are dealt to teams of CTAs, in rounds where
//     there are more chunks than teams; CTA r of a team owns the output
//     entries [r E, (r + 1) E): rows of U_n forward, COLUMNS of U_n for the
//     co-state, read in place (no adjoint copy);
//   - U AHEAD OF THE CHAIN: the propagators do not depend on the state, so a
//     producer warp streams the CTA's slab of every step by TMA (a box of 8
//     entries x 256 reduction indices, a piece) into a ring of pieces in
//     shared memory behind full and empty mbarriers, as deep as shared
//     memory allows;
//   - EXCHANGE WITHOUT A BARRIER, as in cheby_ring.cu: the owner writes its
//     entries of the new state into one of two global slots and releases
//     its flag (a 128-byte line of its own) with the number of states it
//     has published; before a step a CTA acquires exactly the flags of the
//     owners, one thread each, and copies the state into shared memory.
//     Two slots suffice: a CTA publishes state q + 1 only after it has
//     copied state q, and writes state q + 2 over slot q % 2 only after
//     every owner has published q + 1;
//   - the eight compute warps split the reduction index of a piece, one
//     index a lane; each lane keeps 8 entries x kb sums, folded across the
//     lanes by recursive halving and across the warps in warp order, so
//     every entry is summed in one fixed order (runs are deterministic).
//
// Full float32 FMAs in the 4-product complex form (the chains compound
// over N_T steps: no reduced precision).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sync.cuh"
#include "flag_ring.cuh"

namespace grape {
namespace sgrid {

using exch::fold;
using exch::kFlagStride;
using exch::named_sync;
using exch::st_release;
using exch::wait_flag;
using exch::wait_phase;

constexpr int kComputeWarps = 8;
constexpr int kComputeThreads = 32 * kComputeWarps;
constexpr int kThreads = kComputeThreads + 32;  // + the producer warp
constexpr int kGroup = 8;        // entries of a piece
constexpr int kPiece = 256;      // reduction indices of a piece (TMA box)
constexpr int kChiPitch = 10;    // float2 per row of a co-state piece
constexpr int kMaxStages = 16;
constexpr int kHeadBytes = 512;  // full and empty mbarrier per stage
constexpr size_t kRedElems = 2 * kComputeWarps * 32;  // two fold buffers
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int piece_width(int d) {
    return d < kPiece ? d : kPiece;
}

// float2 per ring stage: the co-state piece (the larger), 128-byte units
__host__ __device__ inline size_t stage_elems(int d) {
    return ((size_t)piece_width(d) * kChiPitch + 15) / 16 * 16;
}

__host__ __device__ inline size_t state_elems(int d, int kb) {
    return ((size_t)d * kb + 15) / 16 * 16;
}

// mbarriers, the state, the fold buffers, the ring; mirrored by
// ops/hopper_prop.py _grid_smem
__host__ __device__ inline size_t smem_bytes(int d, int kb, int stages) {
    return kHeadBytes +
           8 * (state_elems(d, kb) + kRedElems + (size_t)stages * stage_elems(d));
}

struct Args {
    const float2* U;     // (N_T, G, d, d)
    const float2* x0;    // (K, d)
    float2* out;         // (N_T + 1, K, d) forward, (N_T, K, d) co-state
    float2* x_out;       // (K, d) or null
    float2* ring;        // (teams, 2, d, kb)
    unsigned* flags;     // (teams * ctas, kFlagStride), zero at launch
    int chi, use_tma, N_T, K, d, G, gs, teams, ctas, entries, used, stages;
};

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

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
            smem_addr(bar))
        : "memory");
}

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
state_grid_kernel(const __grid_constant__ CUtensorMap umap, const Args a) {
    constexpr int C0 = kGroup * KB;           // sums of a lane
    constexpr int S = 32 / C0;                // lanes per folded sum
    extern __shared__ __align__(128) unsigned char gsm[];
    uint64_t* full = reinterpret_cast<uint64_t*>(gsm);
    uint64_t* empty = full + kMaxStages;
    const int d = a.d, N_T = a.N_T, G = a.G, gs = a.gs;
    float2* xs = reinterpret_cast<float2*>(gsm + kHeadBytes);  // [i][KB]
    float2* red = xs + state_elems(d, KB);
    float2* ring = red + kRedElems;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int team = blockIdx.x / a.ctas;
    const int rank = blockIdx.x % a.ctas;
    if (rank >= a.used) return;  // owns no entry (no flag of it is read)
    const int o0 = rank * a.entries;
    const int no = min(a.entries, d - o0);
    const int groups = (no + kGroup - 1) / kGroup;  // no box wholly past d
    const int pw = piece_width(d);
    const int np = (d + pw - 1) / pw;
    const size_t se = stage_elems(d);
    const size_t dd = (size_t)d * d;
    const int per_group = (gs + KB - 1) / KB;
    const int chunks = G * per_group;
    const int rounds = (chunks - team + a.teams - 1) / a.teams;
    const int stages = a.stages;
    // updates (U_0 .. U_{N_T-1} forward; U_{N_T-1} .. U_1, and U_0 with
    // x_out, for the co-state)
    const int n_upd = a.chi ? (a.x_out != nullptr ? N_T : N_T - 1) : N_T;
    unsigned* flags = a.flags + (size_t)team * a.ctas * kFlagStride;
    float2* slots = a.ring + (size_t)team * 2 * d * KB;

    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(full + i, a.use_tma ? 1 : 32);
            mbar_init(empty + i, kComputeWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == kComputeWarps) {
        // ---- the producer: every piece of the CTA's slabs, in order -------
        if (a.use_tma && lane != 0) return;
        const unsigned box_bytes = (unsigned)(8 * pw * (a.chi ? kChiPitch : kGroup));
        unsigned u = 0;
        for (int r = 0; r < rounds; ++r) {
            const int g = (team + r * a.teams) / per_group;
            for (int j = 0; j < n_upd; ++j) {
                const int n = a.chi ? N_T - 1 - j : j;
                const int item = n * G + g;
                const float2* Un = a.U + (size_t)item * dd;
                for (int grp = 0; grp < groups; ++grp) {
                    const int e0 = o0 + grp * kGroup;
                    for (int p = 0; p < np; ++p, ++u) {
                        const int sl = u % stages;
                        if (u >= (unsigned)stages) {
                            wait_phase(empty + sl, ((u / stages) - 1) & 1);
                        }
                        float2* dst = ring + sl * se;
                        if (a.use_tma) {
                            mbar_arrive_tx(full + sl, box_bytes);
                            if (a.chi) {
                                tma_box(dst, &umap, e0, p * pw, item, full + sl);
                            } else {
                                tma_box(dst, &umap, p * pw, e0, item, full + sl);
                            }
                            continue;
                        }
                        for (int e = lane; e < kGroup * pw; e += 32) {
                            if (!a.chi) {  // [entry][index]
                                const int o = e / pw, il = e % pw;
                                const int row = e0 + o, col = p * pw + il;
                                if (row < d && col < d) {
                                    cp_async8(dst + o * pw + il,
                                              Un + (size_t)row * d + col);
                                }
                            } else {       // [index][entry]
                                const int il = e / kGroup, o = e % kGroup;
                                const int row = p * pw + il, col = e0 + o;
                                if (row < d && col < d) {
                                    cp_async8(dst + il * kChiPitch + o,
                                              Un + (size_t)row * d + col);
                                }
                            }
                        }
                        cp_async_arrive(full + sl);
                    }
                }
            }
        }
        return;
    }

    // ---- the compute warps ------------------------------------------------
    const int il = warp * 32 + lane;  // this lane's index within a piece
    unsigned u = 0;   // pieces consumed
    unsigned qf = 0;  // folds (parity of the fold buffer)
    for (int r = 0; r < rounds; ++r) {
        const int c = team + r * a.teams;
        const int g = c / per_group;
        const int j0 = (c - g * per_group) * KB;
        const int k0 = g * gs + j0;
        const int kn = min(KB, gs - j0);
        const unsigned base = (unsigned)r * (unsigned)n_upd;
        // the row of state m in the output (null: not emitted)
        auto out_row = [&](int m) -> float2* {
            if (!a.chi) return a.out + ((size_t)m * a.K + k0) * d;
            if (m < N_T) return a.out + ((size_t)(N_T - 1 - m) * a.K + k0) * d;
            return a.x_out != nullptr ? a.x_out + (size_t)k0 * d : nullptr;
        };
        // state 0 from x0, once every owner has published the previous
        // round's last state (so no slot of it is still read)
        if (r > 0 && tid < a.used) wait_flag(flags + tid * kFlagStride, base);
        for (int e = tid; e < d * KB; e += kComputeThreads) {
            const int i = e / KB, k = e % KB;
            xs[e] = k < kn ? a.x0[(size_t)(k0 + k) * d + i]
                           : make_float2(0.f, 0.f);
        }
        float2* row0 = out_row(0);
        for (int e = tid; e < kn * no; e += kComputeThreads) {
            const int k = e / no, o = e % no;
            row0[(size_t)k * d + o0 + o] = a.x0[(size_t)(k0 + k) * d + o0 + o];
        }
        named_sync(1, kComputeThreads);

        for (int m = 0; m < n_upd; ++m) {
            const unsigned q = base + m + 1;  // the state this step publishes
            float2* slot = slots + (size_t)(q & 1) * d * KB;
            float2* dst = out_row(m + 1);
            for (int grp = 0; grp < groups; ++grp) {
                float vr[C0], vi[C0];
#pragma unroll
                for (int v = 0; v < C0; ++v) vr[v] = vi[v] = 0.f;
                for (int p = 0; p < np; ++p, ++u) {
                    const int sl = u % stages;
                    wait_phase(full + sl, (u / stages) & 1);
                    const float2* Sp = ring + sl * se;
                    const int i = p * pw + il;
                    if (il < pw && i < d) {
                        float2 x[KB];
#pragma unroll
                        for (int k = 0; k < KB; ++k) x[k] = xs[i * KB + k];
                        if (!a.chi) {
#pragma unroll
                            for (int o = 0; o < kGroup; ++o) {
                                const float2 s = Sp[o * pw + il];
#pragma unroll
                                for (int k = 0; k < KB; ++k) {
                                    float& xr = vr[o * KB + k];
                                    float& xi = vi[o * KB + k];
                                    xr = fmaf(s.x, x[k].x, xr);
                                    xr = fmaf(-s.y, x[k].y, xr);
                                    xi = fmaf(s.x, x[k].y, xi);
                                    xi = fmaf(s.y, x[k].x, xi);
                                }
                            }
                        } else {
                            const float4* row = reinterpret_cast<const float4*>(
                                Sp + il * kChiPitch);
#pragma unroll
                            for (int h = 0; h < kGroup / 2; ++h) {
                                const float4 s2 = row[h];
                                const float2 s[2] = {make_float2(s2.x, -s2.y),
                                                     make_float2(s2.z, -s2.w)};
#pragma unroll
                                for (int t = 0; t < 2; ++t) {
                                    const int o = 2 * h + t;
#pragma unroll
                                    for (int k = 0; k < KB; ++k) {
                                        float& xr = vr[o * KB + k];
                                        float& xi = vi[o * KB + k];
                                        xr = fmaf(x[k].x, s[t].x, xr);
                                        xr = fmaf(-x[k].y, s[t].y, xr);
                                        xi = fmaf(x[k].x, s[t].y, xi);
                                        xi = fmaf(x[k].y, s[t].x, xi);
                                    }
                                }
                            }
                        }
                    }
                    __syncwarp();
                    if (lane == 0) mbar_arrive(empty + sl);
                }
                fold<C0>(vr, vi, lane);
                float2* rb = red + (size_t)(qf & 1) * kComputeWarps * 32;
                if (lane % S == 0) rb[warp * 32 + lane / S] = make_float2(vr[0], vi[0]);
                named_sync(1, kComputeThreads);
                if (warp == 0 && lane < C0) {
                    float2 t = rb[lane];
                    for (int w = 1; w < kComputeWarps; ++w) {
                        const float2 o = rb[w * 32 + lane];
                        t.x += o.x;
                        t.y += o.y;
                    }
                    const int e = grp * kGroup + lane / KB;
                    const int k = lane % KB;
                    if (e < no) {
                        slot[(size_t)(o0 + e) * KB + k] = t;
                        if (dst != nullptr && k < kn) dst[(size_t)k * d + o0 + e] = t;
                    }
                }
                ++qf;
            }
            if (warp == 0) {
                __syncwarp();
                if (lane == 0) {
                    __threadfence();
                    st_release(flags + rank * kFlagStride, q);
                }
            }
            if (m + 1 < n_upd) {
                // the next state: one thread acquires each owner's flag
                if (tid < a.used) wait_flag(flags + tid * kFlagStride, q);
                named_sync(1, kComputeThreads);
                const int n2 = d * KB;
                if (n2 % 2 == 0) {  // both slots 16-byte aligned
                    const float4* s4 = reinterpret_cast<const float4*>(slot);
                    float4* x4 = reinterpret_cast<float4*>(xs);
#pragma unroll 8
                    for (int e = tid; e < n2 / 2; e += kComputeThreads) {
                        x4[e] = __ldcg(s4 + e);
                    }
                } else {
#pragma unroll 8
                    for (int e = tid; e < n2; e += kComputeThreads) {
                        xs[e] = __ldcg(slot + e);
                    }
                }
                named_sync(1, kComputeThreads);
            }
        }
    }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The tensor map of U (items of d x d complex, 8-byte elements) with the
// piece's box; false where TMA does not apply (odd d, U not 16-byte
// aligned) and the element copies run instead.
static bool encode_map(CUtensorMap* map, bool chi, const void* U, int items,
                       int d) {
    if (d % 2 != 0 || U == nullptr ||
        (reinterpret_cast<uintptr_t>(U) & 15) != 0) {
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
    const int pw = piece_width(d);
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)d,
                                (cuuint64_t)items};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 8,
                                   (cuuint64_t)d * d * 8};
    const cuuint32_t box[3] = {chi ? (cuuint32_t)kChiPitch : (cuuint32_t)pw,
                               chi ? (cuuint32_t)pw : (cuuint32_t)kGroup, 1};
    const cuuint32_t ones[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3,
                  const_cast<void*>(U), dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KB>
static cudaError_t launch(Args a, size_t smem, cudaStream_t stream) {
    auto kernel = state_grid_kernel<KB>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    const int blocks = a.teams * a.ctas;
    if ((long long)per_sm * sms < blocks) {
        return cudaErrorCooperativeLaunchTooLarge;
    }
    CUtensorMap map = {};
    a.use_tma = encode_map(&map, a.chi != 0, a.U, a.N_T * a.G, a.d);
    void* params[] = {(void*)&map, (void*)&a};
    return cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks),
                                       dim3(kThreads), params, smem, stream);
}

}  // namespace sgrid
}  // namespace grape

extern "C" {

// chi == 0: storage (N_T+1, K, d) from psi0 = x0 (K, d); chi != 0: chis
// (N_T, K, d) from chi_hat = x0, and with x_out (K, d) the co-state carried
// out of the window (null: not wanted).  U (N_T, G, d, d).  kb, teams,
// ctas (per team), entries (per CTA; even where d is even, so that a box
// of columns starts on 16 bytes) and stages as ops/hopper_prop.py
// scan_route gives them; ring (teams, 2, d, kb) complex; flags
// (teams * ctas * 32) unsigned, zero.  A grid that cannot be co-resident
// gives cudaErrorCooperativeLaunchTooLarge.
int grape_state_grid(const void* U, const void* x0, void* out, void* x_out,
                     int chi, int N_T, int K, int d, int G, int gs, int kb,
                     int teams, int ctas, int entries, int stages, void* ring,
                     void* flags, void* stream) {
    using namespace grape::sgrid;
    cudaGetLastError();
    const int per_group = (gs + kb - 1) / (kb > 0 ? kb : 1);
    if (N_T < 1 || d < 1 || G < 1 || gs < 1 || G * gs != K ||
        (kb != 1 && kb != 2 && kb != 4) || teams < 1 ||
        teams > G * per_group || ctas < 1 || entries < 1 ||
        (long long)entries * ctas < d || (d % 2 == 0 && entries % 2 != 0) ||
        (d + entries - 1) / entries > kComputeThreads || stages < 2 ||
        stages > kMaxStages || smem_bytes(d, kb, stages) > kMaxSmem ||
        ring == nullptr || flags == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    Args a = {};
    a.U = (const float2*)U;
    a.x0 = (const float2*)x0;
    a.out = (float2*)out;
    a.x_out = (float2*)x_out;
    a.ring = (float2*)ring;
    a.flags = (unsigned*)flags;
    a.chi = chi;
    a.N_T = N_T;
    a.K = K;
    a.d = d;
    a.G = G;
    a.gs = gs;
    a.teams = teams;
    a.ctas = ctas;
    a.entries = entries;
    a.used = (d + entries - 1) / entries;
    a.stages = stages;
    const size_t smem = smem_bytes(d, kb, stages);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = kb == 1   ? launch<1>(a, smem, st)
                      : kb == 2 ? launch<2>(a, smem, st)
                                : launch<4>(a, smem, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
