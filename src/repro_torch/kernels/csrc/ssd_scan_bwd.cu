// Mamba2 SSD chunked scan, backward: the gradients of the scan of
// csrc/ssd_scan.cu (the function of src/repro/models/ssm.py::ssd_chunked,
// from a state h0, at any sequence length) with respect to x, dt, a_log, B,
// C and h0, given the gradients dy on y and dh_final on the final state.
//
// Replaces: no TPU kernel.  The JAX package trains through the jnp
// `ssd_chunked` and XLA's autodiff (src/repro/kernels/ssd_scan/ops.py:1-3);
// the plain version of this file is kernels/ssd_scan/ref.py::ssd_scan_bwd_ref,
// whose docstring states the formulas.  Per (batch, head) and 64-row chunk,
// with A = -exp(a_log), cum_i the in-chunk cumsum of dt A, u_j = dt_j x_j,
// w_j = exp(cum_last - cum_j), H the state entering the chunk and G the
// gradient on the state leaving it:
//   dH   = exp(cum_last) G + sum_i exp(cum_i) dy_i C_i^T   (reverse chain)
//   du_j = sum_{i >= j} exp(cum_i - cum_j) (C_i . B_j) dy_i + w_j G B_j
//   dx = dt du;  ddt = du . x + A sum_{i >= k} dcum_i;  dB, dC summed over
//   the heads;  da_log = sum dt A sum_{i >= k} dcum_i.
//
// Bound on an H100: at the mamba2-130m train shape (8 x 2048 tokens, 24
// heads, P 64, N 128) ~0.22 GB must move (x, dx, dy, B, C, dB, dC, dt, ddt:
// 0.066 ms at 3.35 TB/s) and ~52 GFLOP of products must run (five L P N and
// four L L P or L L N products per (batch, head, chunk)); this design runs
// them on the CUDA cores in fp32 (0.77 ms at 67 TFLOP/s): operations bound.
//
// Design (simple and deterministic; no float atomics, every sum in a fixed
// order, so the same inputs give the same bits):
// * ssd_bwd_states_kernel, one block a (chunk, head, batch): the chunk's
//   state update sum_j w_j u_j B_j^T and its share of the reverse chain
//   sum_i exp(cum_i) dy_i C_i^T, both [P, N] fp32, to a workspace, and the
//   chunk's decay exp(cum_last).  Register tiles of 4 x 8 over shared
//   memory.
// * ssd_bwd_chain_kernel, one thread a state element (p, n) of a (batch,
//   head): runs the chunks forward from h0 and leaves in place the state
//   entering each chunk, then backward from dh_final and leaves the
//   gradient on the state leaving each chunk; what is left at chunk 0 is
//   dh0.  The states are recomputed here, not saved by the forward, which
//   stays as it is.  It moves 4 workspace bytes a state element a chunk;
//   loads go 16 chunks at a time, or each chunk waits a DRAM round trip.
// * ssd_bwd_grads_kernel, one block a (chunk, head, batch): C B^T and
//   dy u^T (4 x 4 register tiles), the masked decays, then the per-head dB
//   and dC (4 x 8 tiles) to a workspace, then du, dx and the direct part of
//   ddt, and the gradient on each exponent (dcum); one thread runs the
//   reverse cumsum for ddt and the chunk's share of da_log.  B and C stay
//   bf16 in shared memory (they are bf16 inputs), and G's transposed copy
//   for du takes the place of C and E (dy . u) once dB and dC are done:
//   106 KB at P 64, N 128, two blocks an SM (PERF.md: 2.73 ms a call at
//   the train shape, against 3.11 ms with fp32 tiles at one block an SM).
// * ssd_bwd_reduce_kernel: dB and dC summed over the heads in head order
//   (bf16 out), da_log over (batch, chunk) in order.
// Workspace (the wrapper allocates it): the entering states and the chain's
// gradients, [B, H, NC, P, N] fp32 each, the per-head dB and dC, [B, H, NC
// 64, N] fp32 each, the decays and da_log's shares.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int L = 64;           // rows per chunk
constexpr int LDL = L + 1;      // row pitch of the [L, L] tiles (odd: no bank conflicts)
constexpr int kThreads = 256;

struct Params {
    const bf16* x;              // [batch, S, H, P], strides xs0..2, last dim contiguous
    const float* dt;            // [batch, S, H]
    const float* a_log;         // [H]
    const bf16* B;              // [batch, S, N], strides bs0, bs1
    const bf16* C;              // [batch, S, N], strides cs0, cs1
    const float* h0;            // [batch, H, P, N] or null (zeros)
    const float* dy;            // [batch, S, H, P]
    const float* dhf;           // [batch, H, P, N] or null (zeros)
    bf16* dx;                   // [batch, S, H, P]
    float* ddt;                 // [batch, S, H]
    float* da_log;              // [H]
    bf16* dB;                   // [batch, S, N]
    bf16* dC;                   // [batch, S, N]
    float* dh0;                 // [batch, H, P, N] or null (not wanted)
    float* hst;                 // [batch, H, NC, P, N]: state updates, then entering states
    float* gst;                 // [batch, H, NC, P, N]: chain shares, then leaving gradients
    float* dBp;                 // [batch, H, NC * L, N]: dB of each head
    float* dCp;                 // [batch, H, NC * L, N]: dC of each head
    float* dec;                 // [batch, H, NC]: exp(cum_last)
    float* da_part;             // [batch, NC, H]
    int64_t xs0, xs1, xs2, bs0, bs1, cs0, cs1;
    int batch, S, H, NC;
};

// The output tiles of an [R, CC] product: thread t < COUNT owns rows
// ra + RT a (a < TA) and columns cb + CT b (b < TB), ra = t / CT, cb = t % CT,
// so neighbouring threads own neighbouring columns.
template <int R, int CC, int TA, int TB>
struct Tiles {
    static constexpr int RT = R / TA, CT = CC / TB, COUNT = RT * CT;
    static_assert(COUNT <= kThreads, "one tile a thread");
};

// acc[a][b] += sum_k X(a, k) Y(k, b), k in order
template <int TA, int TB, int K, class FX, class FY>
__device__ __forceinline__ void tile_mac(float (&acc)[TA][TB], FX X, FY Y) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        float xa[TA], yb[TB];
#pragma unroll
        for (int a = 0; a < TA; ++a) xa[a] = X(a, k);
#pragma unroll
        for (int b = 0; b < TB; ++b) yb[b] = Y(k, b);
#pragma unroll
        for (int a = 0; a < TA; ++a)
#pragma unroll
            for (int b = 0; b < TB; ++b) acc[a][b] = fmaf(xa[a], yb[b], acc[a][b]);
    }
}

// the sum over the CT neighbouring lanes that share a row tile
template <int CT>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
    for (int off = CT / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// dt of the chunk's rows (0 past S), its in-chunk cumsum of dt A (one
// thread, in order), w = exp(cum_last - cum) and exp(cum); ends synced
__device__ __forceinline__ void row_factors(const Params& p, int bb, int hh, int s0, float A,
                                            float* dtv, float* cum, float* w, float* ec) {
    const int tid = threadIdx.x;
    if (tid < L) {
        const int r = s0 + tid;
        dtv[tid] = r < p.S ? p.dt[(int64_t(bb) * p.S + r) * p.H + hh] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
        float acc = 0.f;
        for (int i = 0; i < L; ++i) {
            acc += dtv[i] * A;
            cum[i] = acc;
        }
    }
    __syncthreads();
    if (tid < L) {
        w[tid] = expf(cum[L - 1] - cum[tid]);
        ec[tid] = expf(cum[tid]);
    }
    __syncthreads();
}

// B and C rows of the chunk as [L, LD] tiles of fp32 or (exact) bf16, 0
// past S
template <int N, int LD, class T>
__device__ __forceinline__ void load_bc(const Params& p, int bb, int s0, T* Bs, T* Cs) {
    for (int e = threadIdx.x; e < L * N; e += kThreads) {
        const int j = e / N, n = e % N, r = s0 + j;
        bf16 bv = __float2bfloat16(0.f), cv = bv;
        if (r < p.S) {
            bv = p.B[bb * p.bs0 + r * p.bs1 + n];
            cv = p.C[bb * p.cs0 + r * p.cs1 + n];
        }
        Bs[j * LD + n] = static_cast<T>(bv);
        Cs[j * LD + n] = static_cast<T>(cv);
    }
}

template <int P, int N>
struct StatesSmem {
    static constexpr int floats = 2 * L * (P + 1) + 2 * L * (N + 1) + 4 * L;
    static constexpr size_t bytes = floats * sizeof(float);
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_states_kernel(const Params p) {
    constexpr int LDP = P + 1, LDN = N + 1;
    extern __shared__ float sm[];
    float* wu = sm;                     // [L, P + 1]: w_j u_j
    float* ey = wu + L * LDP;           // [L, P + 1]: exp(cum_i) dy_i
    float* Bs = ey + L * LDP;           // [L, N + 1]
    float* Cs = Bs + L * LDN;           // [L, N + 1]
    float* dtv = Cs + L * LDN;
    float* cum = dtv + L;
    float* w = cum + L;
    float* ec = w + L;
    const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z, tid = threadIdx.x;
    const int s0 = c * L;
    const float A = -expf(p.a_log[hh]);
    row_factors(p, bb, hh, s0, A, dtv, cum, w, ec);
    for (int e = tid; e < L * P; e += kThreads) {
        const int j = e / P, q = e % P, r = s0 + j;
        float xv = 0.f, dyv = 0.f;
        if (r < p.S) {
            xv = __bfloat162float(p.x[bb * p.xs0 + r * p.xs1 + hh * p.xs2 + q]);
            dyv = p.dy[((int64_t(bb) * p.S + r) * p.H + hh) * P + q];
        }
        wu[j * LDP + q] = w[j] * dtv[j] * xv;
        ey[j * LDP + q] = ec[j] * dyv;
    }
    load_bc<N, LDN>(p, bb, s0, Bs, Cs);
    __syncthreads();
    const int64_t blk = ((int64_t(bb) * p.H + hh) * p.NC + c) * P * N;
    if (tid == 0) p.dec[(int64_t(bb) * p.H + hh) * p.NC + c] = expf(cum[L - 1]);
    using T = Tiles<P, N, 4, 8>;
    for (int t = tid; t < T::COUNT; t += kThreads) {
        const int ra = t / T::CT, cb = t % T::CT;
        float hs[4][8] = {}, gs[4][8] = {};
        tile_mac<4, 8, L>(hs, [&](int a, int k) { return wu[k * LDP + ra + T::RT * a]; },
                          [&](int k, int b) { return Bs[k * LDN + cb + T::CT * b]; });
        tile_mac<4, 8, L>(gs, [&](int a, int k) { return ey[k * LDP + ra + T::RT * a]; },
                          [&](int k, int b) { return Cs[k * LDN + cb + T::CT * b]; });
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const int64_t o = blk + (ra + T::RT * a) * N + cb + T::CT * b;
                p.hst[o] = hs[a][b];
                p.gst[o] = gs[a][b];
            }
    }
}

// one thread a state element: the forward chain from h0, then the reverse
// chain from dh_final.  The chunks' values are loaded kChain at a time
// before any is overwritten, so a thread keeps kChain loads in flight
// instead of waiting on one load a chunk.
constexpr int kChain = 16;

__global__ void __launch_bounds__(kThreads) ssd_bwd_chain_kernel(const Params p, int PN) {
    const int e = blockIdx.x * kThreads + threadIdx.x;
    if (e >= PN) return;
    const int hh = blockIdx.y, bb = blockIdx.z;
    const int64_t bh = int64_t(bb) * p.H + hh;
    const float* dec = p.dec + bh * p.NC;
    float* hs = p.hst + bh * p.NC * PN + e;
    float* gs = p.gst + bh * p.NC * PN + e;
    float h = p.h0 ? p.h0[bh * PN + e] : 0.f;
    for (int c0 = 0; c0 < p.NC; c0 += kChain) {
        float v[kChain], d[kChain];
#pragma unroll
        for (int k = 0; k < kChain; ++k)
            if (c0 + k < p.NC) {
                v[k] = hs[int64_t(c0 + k) * PN];
                d[k] = dec[c0 + k];
            }
#pragma unroll
        for (int k = 0; k < kChain; ++k)
            if (c0 + k < p.NC) {
                hs[int64_t(c0 + k) * PN] = h;
                h = d[k] * h + v[k];
            }
    }
    float g = p.dhf ? p.dhf[bh * PN + e] : 0.f;
    for (int c0 = p.NC - 1; c0 >= 0; c0 -= kChain) {
        float v[kChain], d[kChain];
#pragma unroll
        for (int k = 0; k < kChain; ++k)
            if (c0 - k >= 0) {
                v[k] = gs[int64_t(c0 - k) * PN];
                d[k] = dec[c0 - k];
            }
#pragma unroll
        for (int k = 0; k < kChain; ++k)
            if (c0 - k >= 0) {
                gs[int64_t(c0 - k) * PN] = g;
                g = d[k] * g + v[k];
            }
    }
    if (p.dh0) p.dh0[bh * PN + e] = g;
}

template <int P, int N>
struct GradsSmem {
    // bf16 [L, N + 2] B and C tiles (N + 2: an odd number of 4-byte words a
    // row), fp32 [L, L + 1] att and E (dy . u) tiles, fp32 [L, P + 1] u and
    // dy tiles, M's column partials [16, L], the row factors.  C and the
    // E (dy . u) tile, adjacent, later hold G transposed ([N, P + 1] fp32).
    static constexpr int LDB = N + 2;
    static constexpr size_t bc = size_t(L) * LDB * 2, tile = size_t(L) * LDL * 4;
    static constexpr size_t ud = size_t(L) * (P + 1) * 4;
    static_assert(bc % 16 == 0 && ud % 16 == 0 && tile % 4 == 0, "aligned regions");
    static_assert(bc + tile >= size_t(N) * (P + 1) * 4, "G^T fits over C and E (dy . u)");
    static constexpr size_t bytes = 2 * bc + 2 * tile + 2 * ud + (16 * L + 8 * L + 32) * 4;
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_grads_kernel(const Params p) {
    using M = GradsSmem<P, N>;
    constexpr int LDP = P + 1, LDB = M::LDB;
    extern __shared__ float sm[];
    unsigned char* base = reinterpret_cast<unsigned char*>(sm);
    bf16* Bs = reinterpret_cast<bf16*>(base);                   // [L, N + 2]
    bf16* Cs = reinterpret_cast<bf16*>(base + M::bc);           // [L, N + 2]
    float* T2 = reinterpret_cast<float*>(base + 2 * M::bc);     // [L, L + 1]: E_ij (dy_i . u_j)
    float* GT = reinterpret_cast<float*>(Cs);                   // [N, P + 1], over Cs and T2
    float* T1 = T2 + L * LDL;           // [L, L + 1]: att_ij = E_ij (C_i . B_j)
    float* us = T1 + L * LDL;           // [L, P + 1]: u = dt x
    float* dys = us + L * LDP;          // [L, P + 1]
    float* colm = dys + L * LDP;        // [16, L]: M's column sums over each row tile
    float* dtv = colm + 16 * L;
    float* cum = dtv + L;
    float* w = cum + L;
    float* ec = w + L;
    float* dcum = ec + L;               // the intra-chunk part of d loss / d cum
    float* dci = dcum + L;              // exp(cum_i) part
    float* ddtd = dci + L;              // du . x
    float* st = ddtd + L;               // u . du_state
    float* red = st + L;                // [32]
    const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z, tid = threadIdx.x;
    const int s0 = c * L;
    const float A = -expf(p.a_log[hh]);
    const int64_t blk = ((int64_t(bb) * p.H + hh) * p.NC + c) * P * N;
    const float* G = p.gst + blk;       // gradient on the state leaving the chunk
    const float* Hin = p.hst + blk;     // the state entering it
    row_factors(p, bb, hh, s0, A, dtv, cum, w, ec);
    for (int e = tid; e < L * P; e += kThreads) {
        const int j = e / P, q = e % P, r = s0 + j;
        float xv = 0.f, dyv = 0.f;
        if (r < p.S) {
            xv = __bfloat162float(p.x[bb * p.xs0 + r * p.xs1 + hh * p.xs2 + q]);
            dyv = p.dy[((int64_t(bb) * p.S + r) * p.H + hh) * P + q];
        }
        us[j * LDP + q] = dtv[j] * xv;
        dys[j * LDP + q] = dyv;
    }
    load_bc<N, LDB>(p, bb, s0, Bs, Cs);
    __syncthreads();

    // C B^T and dy u^T; E_ij = exp(cum_i - cum_j) for j <= i, 0 above (the
    // exponent is never formed above the diagonal); M = att (dy . u), the
    // gradient on cum_i - cum_j, summed by rows (lane shuffles) and by
    // columns (each row tile's partial, then in order)
    {
        using T = Tiles<L, L, 4, 4>;
        static_assert(T::RT == 16 && T::COUNT == kThreads, "colm holds 16 row tiles");
        const int ra = tid / T::CT, cb = tid % T::CT;
        float cbv[4][4] = {}, dv[4][4] = {};
        tile_mac<4, 4, N>(cbv,
                          [&](int a, int k) { return __bfloat162float(Cs[(ra + T::RT * a) * LDB + k]); },
                          [&](int k, int b) { return __bfloat162float(Bs[(cb + T::CT * b) * LDB + k]); });
        tile_mac<4, 4, P>(dv, [&](int a, int k) { return dys[(ra + T::RT * a) * LDP + k]; },
                          [&](int k, int b) { return us[(cb + T::CT * b) * LDP + k]; });
        float colp[4] = {};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int i = ra + T::RT * a;
            float rowp = 0.f;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int j = cb + T::CT * b;
                const float e = j <= i ? expf(cum[i] - cum[j]) : 0.f;
                const float at = e * cbv[a][b], m = at * dv[a][b];
                T1[i * LDL + j] = at;
                T2[i * LDL + j] = e * dv[a][b];
                rowp += m;
                colp[b] += m;
            }
            rowp = row_sum<T::CT>(rowp);
            if (cb == 0) dcum[i] = rowp;
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) colm[ra * L + cb + T::CT * b] = colp[b];
    }
    __syncthreads();
    if (tid < L) {
        float cs = 0.f;
        for (int r = 0; r < 16; ++r) cs += colm[r * L + tid];
        dcum[tid] -= cs;
    }

    // this head's dB_j = w_j sum_p u_j[p] G[p] + sum_i E_ij (dy_i . u_j) C_i
    {
        using T = Tiles<L, N, 4, 8>;
        if (tid < T::COUNT) {
            const int ra = tid / T::CT, cb = tid % T::CT;
            float acc[4][8] = {};
            tile_mac<4, 8, P>(acc, [&](int a, int k) { return us[(ra + T::RT * a) * LDP + k]; },
                              [&](int k, int b) { return G[k * N + cb + T::CT * b]; });
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b) acc[a][b] *= w[ra + T::RT * a];
            tile_mac<4, 8, L>(acc, [&](int a, int k) { return T2[k * LDL + ra + T::RT * a]; },
                              [&](int k, int b) {
                                  return __bfloat162float(Cs[k * LDB + cb + T::CT * b]);
                              });
            float* out = p.dBp + ((int64_t(bb) * p.H + hh) * p.NC * L + s0) * N;
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    out[(ra + T::RT * a) * N + cb + T::CT * b] = acc[a][b];
        }
    }

    // this head's dC_i = exp(cum_i) H^T dy_i + sum_j E_ij (dy_i . u_j) B_j,
    // and the gradient on exp(cum_i): C_i . (exp(cum_i) H^T dy_i)
    {
        using T = Tiles<L, N, 4, 8>;
        if (tid < T::COUNT) {
            const int ra = tid / T::CT, cb = tid % T::CT;
            float acc[4][8] = {};
            tile_mac<4, 8, P>(acc, [&](int a, int k) { return dys[(ra + T::RT * a) * LDP + k]; },
                              [&](int k, int b) { return Hin[k * N + cb + T::CT * b]; });
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int i = ra + T::RT * a;
                float sc = 0.f;
#pragma unroll
                for (int b = 0; b < 8; ++b) {
                    acc[a][b] *= ec[i];
                    sc += __bfloat162float(Cs[i * LDB + cb + T::CT * b]) * acc[a][b];
                }
                sc = row_sum<T::CT>(sc);
                if (cb == 0) dci[i] = sc;
            }
            tile_mac<4, 8, L>(acc, [&](int a, int k) { return T2[(ra + T::RT * a) * LDL + k]; },
                              [&](int k, int b) {
                                  return __bfloat162float(Bs[k * LDB + cb + T::CT * b]);
                              });
            float* out = p.dCp + ((int64_t(bb) * p.H + hh) * p.NC * L + s0) * N;
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    out[(ra + T::RT * a) * N + cb + T::CT * b] = acc[a][b];
        }
    }
    __syncthreads();            // C and E (dy . u) are read: G^T goes over them
    for (int e = tid; e < P * N; e += kThreads) GT[(e % N) * LDP + e / N] = G[e];
    __syncthreads();

    // du_j = sum_i att_ij dy_i + w_j G B_j; dx = dt du; du . x; u . (w G B)
    {
        using T = Tiles<L, P, 4, 4>;
        if (tid < T::COUNT) {
            const int ra = tid / T::CT, cb = tid % T::CT;
            float acc[4][4] = {}, gb[4][4] = {};
            tile_mac<4, 4, L>(acc, [&](int a, int k) { return T1[k * LDL + ra + T::RT * a]; },
                              [&](int k, int b) { return dys[k * LDP + cb + T::CT * b]; });
            tile_mac<4, 4, N>(gb,
                              [&](int a, int k) {
                                  return __bfloat162float(Bs[(ra + T::RT * a) * LDB + k]);
                              },
                              [&](int k, int b) { return GT[k * LDP + cb + T::CT * b]; });
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int j = ra + T::RT * a, r = s0 + j;
                float sx = 0.f, sst = 0.f;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const int q = cb + T::CT * b;
                    const float dus = w[j] * gb[a][b], du = acc[a][b] + dus;
                    if (r < p.S) {
                        const int64_t o = ((int64_t(bb) * p.S + r) * p.H + hh) * P + q;
                        p.dx[o] = __float2bfloat16(dtv[j] * du);
                        sx += du * __bfloat162float(p.x[bb * p.xs0 + r * p.xs1 + hh * p.xs2 + q]);
                    }
                    sst += us[j * LDP + q] * dus;
                }
                sx = row_sum<T::CT>(sx);
                sst = row_sum<T::CT>(sst);
                if (cb == 0) {
                    ddtd[j] = sx;
                    st[j] = sst;
                }
            }
        }
    }

    // <G, H>: the gradient on the chunk's decay exp(cum_last), in order
    float gh = 0.f;
    for (int e = tid; e < P * N; e += kThreads) gh += G[e] * Hin[e];
    gh = row_sum<32>(gh);
    if (tid % 32 == 0) red[tid / 32] = gh;
    __syncthreads();
    if (tid == 0) {
        float ghs = 0.f, sts = 0.f;
        for (int i = 0; i < kThreads / 32; ++i) ghs += red[i];
        for (int j = 0; j < L; ++j) sts += st[j];
        float R = 0.f, da = 0.f;
        for (int j = L - 1; j >= 0; --j) {          // sum_{i >= j} dcum_i
            float d = dcum[j] + dci[j] - st[j];
            if (j == L - 1) d += sts + expf(cum[L - 1]) * ghs;
            R += d;
            const int r = s0 + j;
            if (r < p.S) p.ddt[(int64_t(bb) * p.S + r) * p.H + hh] = ddtd[j] + A * R;
            da += dtv[j] * A * R;
        }
        p.da_part[(int64_t(bb) * p.NC + c) * p.H + hh] = da;
    }
}

// dB and dC summed over the heads in order; da_log over (batch, chunk)
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(const Params p, int N) {
    const int64_t e = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t per = int64_t(p.S) * N, rows = int64_t(p.NC) * L * N;
    if (e < p.batch * per) {
        const int64_t bb = e / per, rem = e % per;
        float sb = 0.f, sc = 0.f;
        for (int hh = 0; hh < p.H; ++hh) {
            const int64_t o = (bb * p.H + hh) * rows + rem;
            sb += p.dBp[o];
            sc += p.dCp[o];
        }
        p.dB[e] = __float2bfloat16(sb);
        p.dC[e] = __float2bfloat16(sc);
    }
    if (blockIdx.x == 0) {
        for (int hh = threadIdx.x; hh < p.H; hh += kThreads) {
            float s = 0.f;
            for (int64_t k = 0; k < int64_t(p.batch) * p.NC; ++k) s += p.da_part[k * p.H + hh];
            p.da_log[hh] = s;
        }
    }
}

// dynamic shared memory up to `bytes`, with the carveout that leaves the
// most of it, so that two blocks fit an SM
template <class K>
cudaError_t set_smem(K* kernel, size_t bytes) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

template <int P, int N>
int launch(const Params& p, cudaStream_t stream) {
    const dim3 chunks(p.NC, p.H, p.batch);
    cudaError_t e = set_smem(ssd_bwd_states_kernel<P, N>, StatesSmem<P, N>::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = set_smem(ssd_bwd_grads_kernel<P, N>, GradsSmem<P, N>::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_states_kernel<P, N><<<chunks, kThreads, StatesSmem<P, N>::bytes, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_chain_kernel<<<dim3((P * N + kThreads - 1) / kThreads, p.H, p.batch), kThreads, 0,
                           stream>>>(p, P * N);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_grads_kernel<P, N><<<chunks, kThreads, GradsSmem<P, N>::bytes, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    const int64_t total = int64_t(p.batch) * p.S * N;
    ssd_bwd_reduce_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                            stream>>>(p, N);
    return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(const Params& p, int N, cudaStream_t stream) {
    switch (N) {
        case 16: return launch<P, 16>(p, stream);
        case 32: return launch<P, 32>(p, stream);
        case 64: return launch<P, 64>(p, stream);
        case 128: return launch<P, 128>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// x [batch, S, H, P] bf16 and B, C [batch, S, N] bf16 with the given strides
// (in elements, last dims contiguous); dt [batch, S, H], a_log [H], dy
// [batch, S, H, P] fp32; h0 and dh_final [batch, H, P, N] fp32 or null
// (zeros).  Writes dx [batch, S, H, P] bf16, ddt [batch, S, H] fp32, da_log
// [H] fp32, dB, dC [batch, S, N] bf16 and, when dh0 is not null, dh0 [batch,
// H, P, N] fp32, all contiguous.  `ws` holds 2 batch H NC (P N + 64 N + 1)
// floats, NC = ceil(S / 64).  strides: x0, x1, x2, b0, b1, c0, c1.  P one
// of 16, 32, 64; N one of 16, 32, 64, 128; S >= 1 (the wrapper checks all
// of it).  Four launches on `stream`: states, chain, grads, reduce.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a_log, const void* B,
                            const void* C, const void* h0, const void* dy, const void* dh_final,
                            void* dx, void* ddt, void* da_log, void* dB, void* dC, void* dh0,
                            void* ws, const int64_t* strides, int batch, int S, int H, int P,
                            int N, void* stream) {
    if ((P != 16 && P != 32 && P != 64) || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.x = static_cast<const bf16*>(x);
    p.dt = static_cast<const float*>(dt);
    p.a_log = static_cast<const float*>(a_log);
    p.B = static_cast<const bf16*>(B);
    p.C = static_cast<const bf16*>(C);
    p.h0 = static_cast<const float*>(h0);
    p.dy = static_cast<const float*>(dy);
    p.dhf = static_cast<const float*>(dh_final);
    p.dx = static_cast<bf16*>(dx);
    p.ddt = static_cast<float*>(ddt);
    p.da_log = static_cast<float*>(da_log);
    p.dB = static_cast<bf16*>(dB);
    p.dC = static_cast<bf16*>(dC);
    p.dh0 = static_cast<float*>(dh0);
    p.xs0 = strides[0];
    p.xs1 = strides[1];
    p.xs2 = strides[2];
    p.bs0 = strides[3];
    p.bs1 = strides[4];
    p.cs0 = strides[5];
    p.cs1 = strides[6];
    p.batch = batch;
    p.S = S;
    p.H = H;
    p.NC = (S + L - 1) / L;
    const int64_t states = int64_t(batch) * H * p.NC * P * N;
    const int64_t rows = int64_t(batch) * H * p.NC * L * N;
    p.hst = static_cast<float*>(ws);
    p.gst = p.hst + states;
    p.dBp = p.gst + states;
    p.dCp = p.dBp + rows;
    p.dec = p.dCp + rows;
    p.da_part = p.dec + int64_t(batch) * H * p.NC;
    if (batch == 0 || H == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (P) {
        case 16: return launch_n<16>(p, N, s);
        case 32: return launch_n<32>(p, N, s);
        default: return launch_n<64>(p, N, s);
    }
}

