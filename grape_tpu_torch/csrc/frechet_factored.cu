// Rank-factored Frechet-trace gradient kernel, one generator per GROUP of
// gs contiguous trajectories (K = G * gs).
//
// Replaces, beside the dense kernel of frechet_trace.cu (the wrapper in
// ops/hopper_frechet.py takes whichever of the two needs fewer operations
// for (d, T, gs, s)), the TPU Pallas kernels frechet_trace_pallas_shared
// (G = 1) and frechet_trace_pallas_pertraj (one generator per trajectory or
// per group) of grape_tpu/ops/pallas_frechet.py:
//
//   trj[n, k, t] = tr(Op_gt L_s),   g = k / gs,
//
// L_0 = dT[A](R), the Frechet derivative of the degree-16 Taylor polynomial
// T at A = -i dt_n 2^-s H_ng in the direction R = 2^-s psi_nk chi_nk^dagger,
// then s pair doublings (E, L) <- (E^2, E L + L E) with E = T(A).  R has
// rank one, so with c_k = 1/k!
//
//   L_0 = sum_{i+j<=15} c_{i+j+1} A^i R A^j = sum_{i<16} u_i y_i^dagger,
//   u_i = A^i 2^-s psi,  v_j = (A^dagger)^j chi,  y_i = sum_j c_{i+j+1} v_j,
//
//   L_s = sum_{p < 2^s} E^p L_0 E^{2^s-1-p}
//       = sum_{p, i} (E^p u_i) ((E^dagger)^{2^s-1-p} y_i)^dagger,
//
// a sum of 16 * 2^s outer products.  Per item (step n, group g) the kernel
// builds A once; for each chunk of up to four of the group's directions it
// runs the two Krylov sets with the chunk's directions side by side, folds
// v into y, forms the doubling's blocks and reduces
//   tr(Op_t L_s) = sum_{a,b} Op_t[a, b] Z[b, a],   Z = sum_r x_r w_r^dagger
// tile by tile, without storing Z.  The blocks, by s:
//
//   s = 0   none: 15 + 15 matrix-vector products, the fold;
//   s = 1   E is a polynomial in A, so E u_i = sum_{k<=16} c_k u_{i+k} and
//           E^dagger y_i = sum_m D[i, m] v_m with D[i, m] = sum_{j+k=m}
//           c_{i+j+1} c_k (a constant 16 x 32 table): both sets carried on
//           to degree 31 (31 + 31 products) and folded, E never formed;
//   s >= 2  E formed once per item by six dense products, then both sets
//           extended by it, 32 (2^s - 1) products (carrying the sets to
//           degree 16 2^s - 1 would grow them as ||A||^j).
//
// Bound on this card: float32 FMA operations.  Per direction
// (30 + 32 (2^s - 1) + 16 * 2^s + T) d^2 complex multiply-adds, plus six
// d^3 products per item for s >= 2, against a few KB of input per item (the
// bytes are about 0.03 ms for the robust ensemble); at s = 0 a thirteenth
// of the dense algorithm's count.  Full float32 FMAs, no tensor cores.
// Design: the matrix of the products (A, then E) lives in shared memory as
// split real and imaginary planes with an odd row pitch, so that a warp
// reading a column (A^dagger v) or a row (A u) hits 32 banks; the two sets
// (complex vectors) live beside it, and every product reads the matrix once
// per chunk of directions, each thread one row for all of the chunk's
// directions (no predicates: the chunk width is a template argument).  The
// Op_t, shared by all items of a group, are read from L2 in the trace
// epilogue.  Nothing of the working set depends on the launch
// length.  Where the matrix and the sets do not fit the 227 KB of one block
// (large d or s), the chunk shrinks first, then the matrix and then the
// sets move to a per-block global scratch (the same code, through generic
// pointers); where both fit, a second instance of the code addresses them
// as shared memory (at d = 100 a fifth less time: generic loads of shared
// data cost more).  The products and the traces are unrolled so that the
// loads of the next terms are in flight while the FMAs of this one run: at
// d = 100 one block of 8 warps is resident on an SM, too few to hide
// shared-memory latency otherwise.  A profile build (-DGRAPE_PHASE_CLOCK)
// adds block 0's SM cycles per phase of an item to a table
// (phase_clock.cuh).

#include "cmat.cuh"
#include "phase_clock.cuh"

namespace grape {

constexpr int kSet = 16;      // vectors per Krylov set: degree 16
constexpr int kMaxChunk = 4;  // directions side by side
constexpr int kWarps = kThreads / 32;
// the doublings whose blocks come from the Krylov sets carried to degree
// 2 * kSet - 1 (the Krylov extension) instead of from E
constexpr int kExtS = 1;

GRAPE_CLOCK_TABLE(g_clock_frf)

// D[i][m] = sum_{j+k=m, j<=15-i, k<=16} c_{i+j+1} c_k, so that
// E^dagger y_i = sum_m D[i][m] v_m; zero for m > 31 - i.  Summed in double
// at compile time and rounded once.
struct FrExtTable {
    float d[kSet][2 * kSet];
};

constexpr FrExtTable fr_ext_table() {
    double c[kSet + 1] = {};
    c[0] = 1.0;
    for (int k = 1; k <= kSet; ++k) c[k] = c[k - 1] / k;
    FrExtTable t = {};
    for (int i = 0; i < kSet; ++i) {
        for (int m = 0; m < 2 * kSet; ++m) {
            double acc = 0.0;
            for (int j = 0; j + i < kSet && j <= m; ++j) {
                if (m - j <= kSet) acc += c[i + j + 1] * c[m - j];
            }
            t.d[i][m] = (float)acc;
        }
    }
    return t;
}

static __constant__ FrExtTable c_ext = fr_ext_table();

// row pitch of the matrix planes, odd: conflict-free rows and columns
__host__ __device__ inline int fr_pitch(int d) { return d | 1; }

__host__ __device__ inline long long fr_matrix_floats(int d) {
    return 2LL * d * fr_pitch(d);
}

// x and w sets, complex: 2 * 16 * 2^s * chunk vectors of d float2 (at
// s = kExtS the Krylov vectors u_0..u_31 and v_0..v_31 before the fold)
__host__ __device__ inline long long fr_set_floats(int d, int s, int chunk) {
    return 4LL * kSet * (1LL << s) * chunk * d;
}

// per-warp partial traces, (warp, direction, t) complex, rounded to 16 B
__host__ __device__ inline long long fr_red_floats(int T, int chunk) {
    return (2LL * kWarps * chunk * T + 3) / 4 * 4;
}

struct FrView {
    float* Mr;  // matrix planes, pitch fr_pitch(d)
    float* Mi;
    float2* x;  // x set: vector slot c at c * d
    float2* w;  // w set
};

// Copy an interleaved d x d matrix (global scratch) into the planes.
__device__ __forceinline__ void fr_load_planes(const FrView& v,
                                               const float2* src, int d) {
    const int P = fr_pitch(d);
    for (int idx = threadIdx.x; idx < d * d; idx += kThreads) {
        const int r = idx / d;
        const int c = idx - r * d;
        const float2 a = src[idx];
        v.Mr[r * P + c] = a.x;
        v.Mi[r * P + c] = a.y;
    }
    __syncthreads();
}

// The planes of A = -i f (H0 + sum_t c_t Op_t), f = dt 2^-s, summed in the
// order of build_generator: Ar = f Hi, Ai = -f Hr.
__device__ __forceinline__ void fr_build_planes(const FrView& v,
                                const float2* __restrict__ H0,
                                const float2* __restrict__ ops,
                                const float* __restrict__ coeffs_n, float f,
                                int T, int d) {
    const int P = fr_pitch(d);
    const int n = d * d;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
        float2 h = H0[idx];
        for (int t = 0; t < T; ++t) {
            const float c = coeffs_n[t];
            const float2 o = ops[t * n + idx];
            h.x += c * o.x;
            h.y += c * o.y;
        }
        const int r = idx / d;
        const int c = idx - r * d;
        v.Mr[r * P + c] = f * h.y;
        v.Mi[r * P + c] = -f * h.x;
    }
    __syncthreads();
}

// x[dst + c] = M x[src + c] and w[dst + c] = M^dagger w[src + c] for the nc
// vector slots c = 0..nc-1 (slot indices count vectors of length d; nc a
// multiple of NC).  One task per (side, row, group of NC slots),
// neighbouring threads on neighbouring rows; the NC slots' entries are
// broadcast reads.
template <int NC>
__device__ __forceinline__ void fr_apply(const FrView& v, int d, int src,
                                         int dst, int nc) {
    const int P = fr_pitch(d);
    const int ncg = nc / NC;
    const int n_tasks = 2 * d * ncg;
    for (int task = threadIdx.x; task < n_tasks; task += kThreads) {
        const int row = task % d;
        const int rest = task / d;
        const int cg = rest % ncg;
        const int side = rest / ncg;
        const int c0 = NC * cg;
        const float2* in = (side ? v.w : v.x) + (size_t)(src + c0) * d;
        float2* out = (side ? v.w : v.x) + (size_t)(dst + c0) * d;
        // side 0: M[row][k]; side 1: conj(M[k][row])
        const int mbase = side ? row : row * P;
        const int mstep = side ? P : 1;
        const float sgn = side ? -1.f : 1.f;
        const float* mrp = v.Mr + mbase;
        const float* mip = v.Mi + mbase;
        float ar[NC];
        float ai[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            ar[c] = 0.f;
            ai[c] = 0.f;
        }
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
            const float mr = mrp[k * mstep];
            const float mi = sgn * mip[k * mstep];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float2 b = in[c * d + k];
                ar[c] = fmaf(mr, b.x, ar[c]);
                ar[c] = fmaf(-mi, b.y, ar[c]);
                ai[c] = fmaf(mr, b.y, ai[c]);
                ai[c] = fmaf(mi, b.x, ai[c]);
            }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            out[c * d + row] = make_float2(ar[c], ai[c]);
        }
    }
    __syncthreads();
}

// The chain step over the chunk's slots src.. (all chunk of them: unused
// directions hold zeros).
__device__ __forceinline__ void fr_chain_step(const FrView& v, int d,
                                              int src, int dst, int chunk) {
    switch (chunk) {
        case 1: fr_apply<1>(v, d, src, dst, 1); break;
        case 2: fr_apply<2>(v, d, src, dst, 2); break;
        case 3: fr_apply<3>(v, d, src, dst, 3); break;
        default: fr_apply<4>(v, d, src, dst, 4); break;
    }
}

// y_i = sum_{j <= 15 - i} c_{i+j+1} v_j in place in the w slots i * chunk + g
// of the chunk's first ng directions (j ascending).
__device__ __forceinline__ void fr_fold(const FrView& v, int d, int chunk,
                                        int ng) {
    for (int idx = threadIdx.x; idx < ng * d; idx += kThreads) {
        const int g = idx / d;
        const int k = idx - g * d;
        float2 vj[kSet];
#pragma unroll
        for (int j = 0; j < kSet; ++j) {
            vj[j] = v.w[((size_t)j * chunk + g) * d + k];
        }
#pragma unroll
        for (int i = 0; i < kSet; ++i) {
            float yr = 0.f;
            float yi = 0.f;
#pragma unroll
            for (int j = 0; j + i < kSet; ++j) {
                yr = fmaf(c_fact_inv[i + j + 1], vj[j].x, yr);
                yi = fmaf(c_fact_inv[i + j + 1], vj[j].y, yi);
            }
            v.w[((size_t)i * chunk + g) * d + k] = make_float2(yr, yi);
        }
    }
    __syncthreads();
}

// s = kExtS: the doubling's blocks from the sets carried to degree 31, in
// place in the slots j * chunk + g of the chunk's first ng directions:
// x slot 16 + i <- E u_i = sum_{k<=16} c_k u_{i+k}; w slot i <- y_i (as
// fr_fold) and w slot 16 + i <- E^dagger y_i = sum_m D[i][m] v_m (k and m
// descending: the small terms first).  One task per (side, direction,
// entry); the 32 entries of a task are read before any is written.
__device__ __forceinline__ void fr_fold_ext(const FrView& v, int d,
                                            int chunk, int ng) {
    const int per_side = ng * d;
    const size_t step = (size_t)chunk * d;
    for (int idx = threadIdx.x; idx < 2 * per_side; idx += kThreads) {
        const int side = idx / per_side;
        const int rest = idx - side * per_side;
        const int g = rest / d;
        const int k = rest - g * d;
        float2* base = (side ? v.w : v.x) + (size_t)g * d + k;
        float2 e[2 * kSet];
#pragma unroll
        for (int j = 0; j < 2 * kSet; ++j) e[j] = base[j * step];
        if (side == 0) {
#pragma unroll
            for (int i = 0; i < kSet; ++i) {
                float xr = 0.f;
                float xi = 0.f;
#pragma unroll
                for (int q = kSet; q >= 0; --q) {
                    xr = fmaf(c_fact_inv[q], e[i + q].x, xr);
                    xi = fmaf(c_fact_inv[q], e[i + q].y, xi);
                }
                base[(kSet + i) * step] = make_float2(xr, xi);
            }
        } else {
#pragma unroll
            for (int i = 0; i < kSet; ++i) {
                float yr = 0.f;
                float yi = 0.f;
#pragma unroll
                for (int j = 0; j + i < kSet; ++j) {
                    yr = fmaf(c_fact_inv[i + j + 1], e[j].x, yr);
                    yi = fmaf(c_fact_inv[i + j + 1], e[j].y, yi);
                }
                float zr = 0.f;
                float zi = 0.f;
#pragma unroll
                for (int m = 2 * kSet - 1 - i; m >= 0; --m) {
                    zr = fmaf(c_ext.d[i][m], e[m].x, zr);
                    zi = fmaf(c_ext.d[i][m], e[m].y, zi);
                }
                base[i * step] = make_float2(yr, yi);
                base[(kSet + i) * step] = make_float2(zr, zi);
            }
        }
    }
    __syncthreads();
}

// Op_t[a, b] for this thread's 4 x 4 entries of the tile (zero outside).
__device__ __forceinline__ void fr_op_tile(float2 (&op)[4][4],
                                           const float2* __restrict__ Op,
                                           int d, int a0, int b0) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int a = a0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int b = b0 + tx + 16 * j;
            op[i][j] = (a < d && b < d) ? Op[(size_t)a * d + b]
                                        : make_float2(0.f, 0.f);
        }
    }
}

// red[(warp, g, t)] = this warp's share of tr(Op_t Z_g) for the chunk's ng
// directions, Z_g[b, a] = sum_{p, i} x_{p,i}[b] conj(w_{Q-p,i}[a]) with
// Q = 2^s - 1.  64 x 64 tiles of (a, b), 4 x 4 entries a thread (b along
// the lanes: the Op_t rows are read coalesced, Op_0's while Z accumulates,
// Op_{t+1}'s while the sum of Op_t is reduced); each lane's sum is reduced
// over its warp and added by lane 0 to the warp's own slot, tile after
// tile, so the order of every sum is fixed.
__device__ __forceinline__ void fr_traces(const FrView& v, float* red,
                                          int d, int chunk, int ng, int nb,
                                          const float2* __restrict__ ops_g,
                                          int T) {
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t dd = (size_t)d * d;
    for (int g = 0; g < ng; ++g) {
        for (int a0 = 0; a0 < d; a0 += kTile) {
            for (int b0 = 0; b0 < d; b0 += kTile) {
                float2 op[4][4];
                fr_op_tile(op, ops_g, d, a0, b0);
                float zr[4][4];
                float zi[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        zr[i][j] = 0.f;
                        zi[i][j] = 0.f;
                    }
                }
                for (int p = 0; p < nb; ++p) {
                    const int q = nb - 1 - p;
#pragma unroll 2
                    for (int r = 0; r < kSet; ++r) {
                        const float2* xs =
                            v.x + ((size_t)(p * kSet + r) * chunk + g) * d;
                        const float2* ws =
                            v.w + ((size_t)(q * kSet + r) * chunk + g) * d;
                        float2 xb[4];
                        float2 wa[4];
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const int b = b0 + tx + 16 * j;
                            xb[j] = b < d ? xs[b] : make_float2(0.f, 0.f);
                        }
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int a = a0 + ty + 16 * i;
                            wa[i] = a < d ? ws[a] : make_float2(0.f, 0.f);
                        }
                        // Z[b, a] += x[b] conj(w[a])
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
#pragma unroll
                            for (int j = 0; j < 4; ++j) {
                                zr[i][j] = fmaf(xb[j].x, wa[i].x, zr[i][j]);
                                zr[i][j] = fmaf(xb[j].y, wa[i].y, zr[i][j]);
                                zi[i][j] = fmaf(xb[j].y, wa[i].x, zi[i][j]);
                                zi[i][j] = fmaf(-xb[j].x, wa[i].y, zi[i][j]);
                            }
                        }
                    }
                }
                for (int t = 0; t < T; ++t) {
                    float sr = 0.f;
                    float si = 0.f;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            sr += op[i][j].x * zr[i][j] - op[i][j].y * zi[i][j];
                            si += op[i][j].x * zi[i][j] + op[i][j].y * zr[i][j];
                        }
                    }
                    if (t + 1 < T) {
                        fr_op_tile(op, ops_g + (size_t)(t + 1) * dd, d, a0,
                                   b0);
                    }
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1) {
                        sr += __shfl_xor_sync(0xffffffffu, sr, off);
                        si += __shfl_xor_sync(0xffffffffu, si, off);
                    }
                    if (lane == 0) {
                        float* slot = red + 2 * ((warp * chunk + g) * T + t);
                        slot[0] += sr;
                        slot[1] += si;
                    }
                }
            }
        }
    }
    __syncthreads();
}

// The kernel's work for one layout.  kShared: the matrix and the sets are
// both in shared memory (then every access to them is a shared-memory load;
// through pointers that may also point to global scratch it is a generic
// one).
template <bool kShared>
__device__ __forceinline__ void fr_items(
    float* smem, const float2* __restrict__ H0,
    const float2* __restrict__ ops, const float* __restrict__ coeffs,
    const float* __restrict__ dts, const float2* __restrict__ psis,
    const float2* __restrict__ chis, int T, int d, int N_T, int K, int G,
    int gs, size_t coeff_group_stride, int s, int chunk, int m_shared,
    int sets_shared, float* scratch, long long scratch_floats,
    float2* trj) {
    const int tid = threadIdx.x;
    const size_t dd = (size_t)d * d;
    const int nb = 1 << s;
    const float scale = exp2f(-(float)s);

    // ---- carve the working set: shared first, the rest global ----------
    float* red = smem;
    const long long n_red = fr_red_floats(T, chunk);
    float* sp = smem + n_red;
    float* gp = scratch + (size_t)blockIdx.x * scratch_floats;
    // the dense products of E (s > kExtS) stage their tiles where the
    // planes and the sets go: E is formed before either is filled
    const bool dense_e = s > kExtS;
    GemmSmem& gsm = *reinterpret_cast<GemmSmem*>(sp);
    float2* Aint = reinterpret_cast<float2*>(gp);  // A, A2, A3, A4, Ea, Eb
    if (dense_e) gp += 12 * dd;
    FrView v;
    float* mb = kShared || m_shared ? sp : gp;
    v.Mr = mb;
    v.Mi = mb + (size_t)d * fr_pitch(d);
    if (m_shared) {
        sp += fr_matrix_floats(d);
    } else {
        gp += fr_matrix_floats(d);
    }
    const size_t set = (size_t)kSet * nb * chunk * d;
    float* sb = kShared || sets_shared ? sp : gp;
    v.x = reinterpret_cast<float2*>(sb);
    v.w = reinterpret_cast<float2*>(sb + 2 * set);
    // products of each Krylov chain: to degree 15, or 31 for the extension
    const int n_chain = s == kExtS ? 2 * kSet - 1 : kSet - 1;

    GRAPE_CLOCK_START
    const size_t n_items = (size_t)N_T * G;
    for (size_t item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int n = (int)(item / G);
        const int g = (int)(item % G);
        const float2* ops_g = ops + (size_t)g * T * dd;
        const float* co = coeffs + (size_t)g * coeff_group_stride +
                          (size_t)n * T;
        const float2* Eint = nullptr;
        if (!dense_e) {
            fr_build_planes(v, H0 + (size_t)g * dd, ops_g, co, dts[n] * scale,
                            T, d);
        } else {
            // E = T(A) by Paterson-Stockmeyer in A^4, Horner as the dense
            // kernel's E history: blk3 (+ c16 A^4), then blk_b + A^4 E
            float2* A = Aint;
            float2* A2 = A + dd;
            float2* A3 = A + 2 * dd;
            float2* A4 = A + 3 * dd;
            float2* Ea = A + 4 * dd;
            float2* Eb = A + 5 * dd;
            build_generator(A, H0 + (size_t)g * dd, ops_g, co, dts[n], scale,
                            T, d);
            powers(A, A2, A3, A4, d, gsm);
            ps_block(Ea, 3, A, A2, A3, A4, d);
            ps_block(Eb, 2, A, A2, A3, nullptr, d);
            cgemm(Eb, A4, Ea, d, true, gsm);
            ps_block(Ea, 1, A, A2, A3, nullptr, d);
            cgemm(Ea, A4, Eb, d, true, gsm);
            ps_block(Eb, 0, A, A2, A3, nullptr, d);
            cgemm(Eb, A4, Ea, d, true, gsm);
            Eint = Eb;
        }
        if (tid == 0) GRAPE_CLOCK_MARK(0)
        const int k_end = (g + 1) * gs;
        for (int k0 = g * gs; k0 < k_end; k0 += chunk) {
            const int ng = min(chunk, k_end - k0);
            if (dense_e) fr_load_planes(v, Aint, d);
            // ---- u_0 = 2^-s psi, v_0 = chi; zero for unused slots -------
            for (int idx = tid; idx < chunk * d; idx += kThreads) {
                const int j = idx / d;
                const int k = idx - j * d;
                float2 p = make_float2(0.f, 0.f);
                float2 c = make_float2(0.f, 0.f);
                if (j < ng) {
                    p = psis[((size_t)n * K + k0 + j) * d + k];
                    c = chis[((size_t)n * K + k0 + j) * d + k];
                }
                v.x[idx] = make_float2(scale * p.x, scale * p.y);
                v.w[idx] = c;
            }
            for (int idx = tid; idx < 2 * kWarps * chunk * T; idx += kThreads)
                red[idx] = 0.f;
            __syncthreads();
            if (tid == 0) GRAPE_CLOCK_MARK(1)
            // ---- the Krylov sets u_i = A u_{i-1}, v_i = A^dagger v_{i-1} -
            for (int i = 1; i <= n_chain; ++i) {
                fr_chain_step(v, d, (i - 1) * chunk, i * chunk, chunk);
            }
            if (tid == 0) GRAPE_CLOCK_MARK(2)
            if (s == kExtS) {
                fr_fold_ext(v, d, chunk, ng);
            } else {
                fr_fold(v, d, chunk, ng);
            }
            if (tid == 0) GRAPE_CLOCK_MARK(3)
            // ---- s > kExtS, the doublings: E^p u_i and (E^dagger)^q y_i -
            if (dense_e) {
                fr_load_planes(v, Eint, d);
                const int blk = kSet * chunk;
                for (int p = 1; p < nb; ++p) {
                    fr_apply<4>(v, d, (p - 1) * blk, p * blk, blk);
                }
            }
            if (tid == 0) GRAPE_CLOCK_MARK(4)
            fr_traces(v, red, d, chunk, ng, nb, ops_g, T);
            if (tid == 0) GRAPE_CLOCK_MARK(5)
            // ---- sum the warps' shares in a fixed order ------------------
            for (int idx = tid; idx < ng * T; idx += kThreads) {
                const int j = idx / T;
                const int t = idx - j * T;
                float sr = 0.f;
                float si = 0.f;
                for (int w = 0; w < kWarps; ++w) {
                    const float* slot = red + 2 * ((w * chunk + j) * T + t);
                    sr += slot[0];
                    si += slot[1];
                }
                trj[((size_t)n * K + k0 + j) * T + t] = make_float2(sr, si);
            }
            __syncthreads();
            if (tid == 0) GRAPE_CLOCK_MARK(6)
        }
    }
    if (tid == 0) GRAPE_CLOCK_FLUSH(g_clock_frf)
}

__global__ void __launch_bounds__(kThreads, 2)
frechet_factored_kernel(const float2* __restrict__ H0,
                        const float2* __restrict__ ops,
                        const float* __restrict__ coeffs,
                        const float* __restrict__ dts,
                        const float2* __restrict__ psis,
                        const float2* __restrict__ chis, int T, int d,
                        int N_T, int K, int G, int gs,
                        size_t coeff_group_stride, int s, int chunk,
                        int m_shared, int sets_shared, float* scratch,
                        long long scratch_floats, float2* trj) {
    extern __shared__ float4 fr_smem4[];
    float* smem = reinterpret_cast<float*>(fr_smem4);
    if (m_shared && sets_shared) {
        fr_items<true>(smem, H0, ops, coeffs, dts, psis, chis, T, d, N_T, K,
                       G, gs, coeff_group_stride, s, chunk, m_shared,
                       sets_shared, scratch, scratch_floats, trj);
    } else {
        fr_items<false>(smem, H0, ops, coeffs, dts, psis, chis, T, d, N_T,
                        K, G, gs, coeff_group_stride, s, chunk, m_shared,
                        sets_shared, scratch, scratch_floats, trj);
    }
}

struct FrLayout {
    int chunk;
    int m_shared;
    int sets_shared;
    long long smem_bytes;
    long long scratch_floats;
};

// Shared memory first: the matrix and the sets at the largest chunk that
// fits, else the sets alone (the matrix global), else the matrix alone,
// else neither.  E's dense products (s > kExtS) stage their tiles in the
// same space.
static FrLayout fr_layout(int d, int T, int gs, int s, long long max_smem) {
    const int c0 = gs < kMaxChunk ? gs : kMaxChunk;
    const long long m = fr_matrix_floats(d);
    const long long gemm =
        s > kExtS ? (long long)(sizeof(GemmSmem) + 3) / 4 : 0;
    auto bytes = [&](int chunk, long long shared) {
        const long long f = fr_red_floats(T, chunk) +
                            (shared > gemm ? shared : gemm);
        return 4 * f;
    };
    FrLayout L = {c0, 0, 0, bytes(c0, 0), 0};
    bool done = false;
    for (int c = c0; c >= 1 && !done; --c) {
        if (bytes(c, m + fr_set_floats(d, s, c)) <= max_smem) {
            L = {c, 1, 1, bytes(c, m + fr_set_floats(d, s, c)), 0};
            done = true;
        }
    }
    for (int c = c0; c >= 1 && !done; --c) {
        if (bytes(c, fr_set_floats(d, s, c)) <= max_smem) {
            L = {c, 0, 1, bytes(c, fr_set_floats(d, s, c)), 0};
            done = true;
        }
    }
    if (!done && bytes(c0, m) <= max_smem) {
        L = {c0, 1, 0, bytes(c0, m), 0};
    }
    long long g = s > kExtS ? 12LL * d * d : 0;
    if (!L.m_shared) g += m;
    if (!L.sets_shared) g += fr_set_floats(d, s, L.chunk);
    L.scratch_floats = (g + 3) / 4 * 4;
    return L;
}

}  // namespace grape

GRAPE_CLOCK_READER(grape_frechet_factored_clock, grape::g_clock_frf)

extern "C" {

// The layout of one call of grape_frechet_factored: out[0] the chunk of
// directions, out[1] / out[2] whether the matrix / the sets are in shared
// memory, out[3] the dynamic shared memory in bytes, out[4] the grid (the
// blocks that are resident at once, at most n_items), and *scratch_floats
// the global scratch per block in floats.  Also raises the kernel's
// dynamic shared memory limit to out[3].
int grape_frechet_factored_plan(int d, int T, int gs, int s,
                                long long n_items, int* out,
                                long long* scratch_floats) {
    cudaGetLastError();
    if (d < 1 || T < 0 || gs < 1 || s < 0 || s > 16 || n_items < 1)
        return (int)cudaErrorInvalidValue;
    int dev = 0;
    int max_smem = 0;
    int sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const grape::FrLayout L = grape::fr_layout(d, T, gs, s, max_smem);
    if (L.smem_bytes > max_smem) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(grape::frechet_factored_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)L.smem_bytes);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grape::frechet_factored_kernel, grape::kThreads,
        (size_t)L.smem_bytes);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long blocks = (long long)sms * per_sm;
    if (blocks > n_items) blocks = n_items;
    out[0] = L.chunk;
    out[1] = L.m_shared;
    out[2] = L.sets_shared;
    out[3] = (int)L.smem_bytes;
    out[4] = (int)blocks;
    *scratch_floats = L.scratch_floats;
    return 0;
}

// trj (N_T, K, T) complex64 with H0 (G, d, d), ops (G, T, d, d), K = G * gs
// and the coefficient row of (n, g) at coeffs[g * coeff_group_stride +
// n * T], with the layout values of grape_frechet_factored_plan; `scratch`
// holds n_blocks * scratch_floats floats.
int grape_frechet_factored(const void* H0, const void* ops,
                           const void* coeffs, const void* dts,
                           const void* psis, const void* chis, int T, int d,
                           int N_T, int K, int G, int gs,
                           long long coeff_group_stride, int s, int chunk,
                           int m_shared, int sets_shared, int smem_bytes,
                           void* scratch, long long scratch_floats,
                           int n_blocks, void* trj, void* stream) {
    cudaGetLastError();
    if (G < 1 || gs < 1 || G * gs != K || chunk < 1 ||
        chunk > grape::kMaxChunk || n_blocks < 1)
        return (int)cudaErrorInvalidValue;
    grape::frechet_factored_kernel<<<n_blocks, grape::kThreads, smem_bytes,
                                     (cudaStream_t)stream>>>(
        (const float2*)H0, (const float2*)ops, (const float*)coeffs,
        (const float*)dts, (const float2*)psis, (const float2*)chis, T, d,
        N_T, K, G, gs, (size_t)coeff_group_stride, s, chunk, m_shared,
        sets_shared, (float*)scratch, scratch_floats, (float2*)trj);
    return (int)cudaGetLastError();
}

}  // extern "C"
