// Flash attention backward (causal or full, GQA) for bf16 q/k/v/out/dO: the
// dq pass and the dk/dv pass.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels behind `flash_attention_bwd`),
// with delta = rowsum(out * dO) (kernel.py:214) fused into the dq pass.
//
// Bound on an H100: tensor-core operations at the train step's shapes
// (S = 512, head dim 128).  Both passes recompute S = Q K^T and
// dP = dO V^T from the saved lse; with dQ, dK and dV that is 7 products of
// 2*D operations for each unmasked (row, col) pair, against about 10*D that
// the gradient needs at least.  The bytes are one read of q, k, v, out, dO
// and lse and one write of dq, dk, dv: the [S, T] probabilities never
// reach device memory.
//
// Design:
// * The TPU grid carries dq (or dk, dv) across a sequential grid axis in
//   VMEM.  Here each becomes a loop inside one block, so the accumulator
//   stays in registers:
//   - dq pass: one block (4 warps) per (64-row q tile, head, batch), looping
//     over 64-row kv tiles up to the causal limit of its last row;
//   - dk/dv pass: one block per (64-row kv tile, kv head, batch), looping
//     over the rep query heads of its GQA group and, for each, over the
//     64-row q tiles from the diagonal down.  dk and dv are summed over the
//     group in registers (JAX writes them per query head and sums after,
//     kernel.py:255-264), so no per-head buffer and no atomics: the result
//     does not depend on the order blocks run in.
// * All five products run on the tensor cores with mma.sync m16n8k16 (bf16
//   in, fp32 accumulate), operands fetched from shared memory with ldmatrix
//   (mma_sm90.cuh).  Each warp owns 16 rows of the block's tile, so each
//   thread holds two rows of every score fragment; P and dS are rounded to
//   bf16 in registers and reused as A operands, as in the forward kernel.
//   The dk/dv pass computes the transposed scores (kv rows x q columns)
//   directly, so lse and delta are read per column from shared memory.
// * The tiles the loop walks over are double-buffered with cp.async: the
//   next K/V (dq pass) or Q/dO/lse/delta (dk/dv pass) tile is fetched while
//   the current one is computed.  Rows past the end are zero-filled, so
//   every product stays finite.
// * The mask is explicit: q row i (absolute position q_offset + i, i < S)
//   sees kv column j when j < kv_len and, for causal, j <= q_offset + i.
//   Rows past S and columns past kv_len get zero gradients, so S and kv_len
//   need not be multiples of the tile (the Pallas grid drops such tails).
// * Inputs are strided views with a contiguous last dim, as in the forward.
//   The 1/sqrt(D) scale of dS is applied once, to dq and dk at the store.
//   wgmma, TMA and a split of the GQA group over more blocks (the dk/dv pass
//   has B * Hkv * T / 64 blocks, 128 at the train shape) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using mma_sm90::bf16;

namespace {

using namespace mma_sm90;

constexpr int BM = 64;              // rows of the block's own tile
constexpr int BN = 64;              // rows of each tile the loop walks over
constexpr int kWarps = BM / 16;     // each warp owns 16 rows
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const bf16* o;
    const bf16* dout;
    const float* lse;           // [B, H, S] contiguous
    float* delta;               // [B, H, S] contiguous: written by dq, read by dkv
    bf16* dq;
    bf16* dk;
    bf16* dv;
    int H, rep, S, T, kv_len, q_offset, causal;
    float scale, scale_log2;
    int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
    int64_t do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

template <int D>
struct Smem {
    static constexpr int LD = D + 8;     // bf16 rows padded by 16 B
    // two own tiles + two double-buffered walked tiles, and 4 x 64 floats
    static constexpr size_t bytes = size_t(2 * BM + 4 * BN) * LD * 2 + 4 * BN * 4;
};

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
    constexpr int LD = Smem<D>::LD;
    constexpr int VPR = D / 8;  // 16-byte vectors per row
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* q_sh = reinterpret_cast<bf16*>(smem);    // [BM][LD]
    bf16* do_sh = q_sh + BM * LD;                  // [BM][LD]
    bf16* k_sh = do_sh + BM * LD;                  // [2][BN][LD]
    bf16* v_sh = k_sh + 2 * BN * LD;               // [2][BN][LD]
    float* delta_sh = reinterpret_cast<float*>(v_sh + 2 * BN * LD);   // [BM]

    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * BM;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* og = p.o + b * p.o_sb + h * p.o_sh;
    const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh;
    const bf16* kg = p.k + b * p.k_sb + (h / p.rep) * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + (h / p.rep) * p.v_sh;
    const int64_t row_base = (int64_t(b) * p.H + h) * p.S;

    int kv_end = p.kv_len;
    if (p.causal) kv_end = min(kv_end, p.q_offset + min(q0 + BM, p.S));
    const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

    auto load_kv = [&](int tile, int buf) {
        const int n0 = tile * BN;
        for (int i = tid; i < BN * VPR; i += kThreads) {
            const int r = i / VPR, col = (i % VPR) * 8;
            const bool ok = n0 + r < p.kv_len;
            cp_async16(k_sh + (buf * BN + r) * LD + col, ok ? kg + (n0 + r) * p.k_ss + col : kg, ok);
            cp_async16(v_sh + (buf * BN + r) * LD + col, ok ? vg + (n0 + r) * p.v_ss + col : vg, ok);
        }
    };
    for (int i = tid; i < BM * VPR; i += kThreads) {
        const int r = i / VPR, col = (i % VPR) * 8;
        const bool ok = q0 + r < p.S;
        cp_async16(q_sh + r * LD + col, ok ? qg + (q0 + r) * p.q_ss + col : qg, ok);
        cp_async16(do_sh + r * LD + col, ok ? dog + (q0 + r) * p.do_ss + col : dog, ok);
    }
    if (n_tiles > 0) load_kv(0, 0);
    cp_async_commit();

    // delta = rowsum(out * dO) in fp32: two threads per row, half a row each
    {
        const int r = tid / 2, half = tid % 2;
        float acc = 0.f;
        if (q0 + r < p.S) {
            const bf16* orow = og + (q0 + r) * p.o_ss + half * (D / 2);
            const bf16* drow = dog + (q0 + r) * p.do_ss + half * (D / 2);
#pragma unroll
            for (int i = 0; i < D / 2; i += 8) {
                const uint4 ou = *reinterpret_cast<const uint4*>(orow + i);
                const uint4 du = *reinterpret_cast<const uint4*>(drow + i);
                const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ou);
                const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float2 of = __bfloat1622float2(oh[j]), df = __bfloat1622float2(dh[j]);
                    acc += of.x * df.x + of.y * df.y;
                }
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (half == 0) {
            delta_sh[r] = acc;
            if (q0 + r < p.S) p.delta[row_base + q0 + r] = acc;
        }
    }
    __syncthreads();

    // rows g and g+8 of this warp's 16: column limit, lse (base 2), delta
    int lim[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int rr = warp * 16 + g + 8 * hr, row = q0 + rr;
        const bool ok = row < p.S;
        lim[hr] = !ok ? 0 : p.causal ? min(p.kv_len, p.q_offset + row + 1) : p.kv_len;
        lse2[hr] = ok ? p.lse[row_base + row] * kLog2e : 0.f;
        dlt[hr] = delta_sh[rr];
    }
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            load_kv(t + 1, (t + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* kb = k_sh + (t & 1) * BN * LD;
        const bf16* vb = v_sh + (t & 1) * BN * LD;

        // S = Q K^T and dP = dO V^T: 16 rows x BN columns each
        float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qf[4], df[4];
            ldmatrix_x4(qf, frag_a(q_sh, LD, warp * 16, kk * 16, lane));
            ldmatrix_x4(df, frag_a(do_sh, LD, warp * 16, kk * 16, lane));
#pragma unroll
            for (int jj = 0; jj < BN / 16; ++jj) {
                uint32_t kf[4], vf[4];
                ldmatrix_x4(kf, frag_bt(kb, LD, jj * 16, kk * 16, lane));
                ldmatrix_x4(vf, frag_bt(vb, LD, jj * 16, kk * 16, lane));
                mma_bf16(s[2 * jj], qf, kf[0], kf[1]);
                mma_bf16(s[2 * jj + 1], qf, kf[2], kf[3]);
                mma_bf16(dp[2 * jj], df, vf[0], vf[1]);
                mma_bf16(dp[2 * jj + 1], df, vf[2], vf[3]);
            }
        }

        // P = exp(S * scale - lse) on unmasked entries, dS = P (dP - delta)
        const int n0 = t * BN;
        uint32_t dsf[BN / 16][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                float ds[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + j * 8 + 2 * c + e;
                    const float pv = col < lim[hr]
                        ? exp2f(s[j][2 * hr + e] * p.scale_log2 - lse2[hr]) : 0.f;
                    ds[e] = pv * (dp[j][2 * hr + e] - dlt[hr]);
                }
                dsf[j / 2][(j % 2) * 2 + hr] = pack_bf16(ds[0], ds[1]);
            }
        }

        // dQ += dS K
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int dd = 0; dd < D / 16; ++dd) {
                uint32_t kf[4];
                ldmatrix_x4_trans(kf, frag_b(kb, LD, kk * 16, dd * 16, lane));
                mma_bf16(acc[2 * dd], dsf[kk], kf[0], kf[1]);
                mma_bf16(acc[2 * dd + 1], dsf[kk], kf[2], kf[3]);
            }
        }
        __syncthreads();  // the next iteration refills this tile's buffer
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + warp * 16 + g + 8 * hr;
        if (row >= p.S) continue;
        bf16* drow = p.dq + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss + 2 * c;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
            *reinterpret_cast<__nv_bfloat162*>(drow + dt * 8) = __floats2bfloat162_rn(
                acc[dt][2 * hr] * p.scale, acc[dt][2 * hr + 1] * p.scale);
    }
}

// ---------------------------------------------------------------------------
// dk/dv pass
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdParams p) {
    constexpr int LD = Smem<D>::LD;
    constexpr int VPR = D / 8;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* k_sh = reinterpret_cast<bf16*>(smem);    // [BM][LD]  this block's kv rows
    bf16* v_sh = k_sh + BM * LD;                   // [BM][LD]
    bf16* q_sh = v_sh + BM * LD;                   // [2][BN][LD]
    bf16* do_sh = q_sh + 2 * BN * LD;              // [2][BN][LD]
    float* lse_sh = reinterpret_cast<float*>(do_sh + 2 * BN * LD);   // [2][BN], base 2
    float* dlt_sh = lse_sh + 2 * BN;                                 // [2][BN]

    const int hk = blockIdx.y, b = blockIdx.z;
    const int k0 = blockIdx.x * BM;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;

    // q tiles that can see row k0: causal needs q_offset + i >= k0
    const int n_q = (p.S + BN - 1) / BN;
    const int qt0 = p.causal ? min(n_q, max(0, k0 - p.q_offset) / BN) : 0;
    const int per_head = n_q - qt0;
    const int n_items = k0 < p.kv_len ? p.rep * per_head : 0;

    for (int i = tid; i < BM * VPR; i += kThreads) {
        const int r = i / VPR, col = (i % VPR) * 8;
        const bool ok = k0 + r < p.kv_len;
        cp_async16(k_sh + r * LD + col, ok ? kg + (k0 + r) * p.k_ss + col : kg, ok);
        cp_async16(v_sh + r * LD + col, ok ? vg + (k0 + r) * p.v_ss + col : vg, ok);
    }
    // item = (query head of the group, q tile); loads its Q, dO, lse, delta
    auto load_q = [&](int item, int buf) {
        const int h = hk * p.rep + item / per_head;
        const int n0 = (qt0 + item % per_head) * BN;
        const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
        const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh;
        for (int i = tid; i < BN * VPR; i += kThreads) {
            const int r = i / VPR, col = (i % VPR) * 8;
            const bool ok = n0 + r < p.S;
            cp_async16(q_sh + (buf * BN + r) * LD + col, ok ? qg + (n0 + r) * p.q_ss + col : qg, ok);
            cp_async16(do_sh + (buf * BN + r) * LD + col, ok ? dog + (n0 + r) * p.do_ss + col : dog, ok);
        }
        if (tid < BN) {
            const int64_t base = (int64_t(b) * p.H + h) * p.S;
            const bool ok = n0 + tid < p.S;
            lse_sh[buf * BN + tid] = ok ? p.lse[base + n0 + tid] * kLog2e : 0.f;
            dlt_sh[buf * BN + tid] = ok ? p.delta[base + n0 + tid] : 0.f;
        }
    };
    if (n_items > 0) load_q(0, 0);
    cp_async_commit();

    int krow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) krow[hr] = k0 + warp * 16 + g + 8 * hr;
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

    for (int it = 0; it < n_items; ++it) {
        if (it + 1 < n_items) {
            load_q(it + 1, (it + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int buf = it & 1;
        const bf16* qb = q_sh + buf * BN * LD;
        const bf16* dob = do_sh + buf * BN * LD;
        const float* lb = lse_sh + buf * BN;
        const float* db = dlt_sh + buf * BN;
        const int n0 = (qt0 + it % per_head) * BN;

        // S^T = K Q^T: 16 kv rows x BN q columns
        float st[BN / 8][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t kf[4];
            ldmatrix_x4(kf, frag_a(k_sh, LD, warp * 16, kk * 16, lane));
#pragma unroll
            for (int jj = 0; jj < BN / 16; ++jj) {
                uint32_t qf[4];
                ldmatrix_x4(qf, frag_bt(qb, LD, jj * 16, kk * 16, lane));
                mma_bf16(st[2 * jj], kf, qf[0], qf[1]);
                mma_bf16(st[2 * jj + 1], kf, qf[2], qf[3]);
            }
        }
        // P^T on unmasked entries (0 elsewhere), and its bf16 A fragments
        uint32_t pf[BN / 16][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int cc = j * 8 + 2 * c + e, qi = n0 + cc;
                    const bool ok = qi < p.S && krow[hr] < p.kv_len &&
                                    (!p.causal || krow[hr] <= p.q_offset + qi);
                    float& sv = st[j][2 * hr + e];
                    sv = ok ? exp2f(sv * p.scale_log2 - lb[cc]) : 0.f;
                }
                pf[j / 2][(j % 2) * 2 + hr] = pack_bf16(st[j][2 * hr], st[j][2 * hr + 1]);
            }
        }
        // dV += P^T dO
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int dd = 0; dd < D / 16; ++dd) {
                uint32_t f[4];
                ldmatrix_x4_trans(f, frag_b(dob, LD, kk * 16, dd * 16, lane));
                mma_bf16(dv[2 * dd], pf[kk], f[0], f[1]);
                mma_bf16(dv[2 * dd + 1], pf[kk], f[2], f[3]);
            }
        }
        // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in place
        float dpt[BN / 8][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t vf[4];
            ldmatrix_x4(vf, frag_a(v_sh, LD, warp * 16, kk * 16, lane));
#pragma unroll
            for (int jj = 0; jj < BN / 16; ++jj) {
                uint32_t f[4];
                ldmatrix_x4(f, frag_bt(dob, LD, jj * 16, kk * 16, lane));
                mma_bf16(dpt[2 * jj], vf, f[0], f[1]);
                mma_bf16(dpt[2 * jj + 1], vf, f[2], f[3]);
            }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const int cc = j * 8 + 2 * c;
                pf[j / 2][(j % 2) * 2 + hr] = pack_bf16(
                    st[j][2 * hr] * (dpt[j][2 * hr] - db[cc]),
                    st[j][2 * hr + 1] * (dpt[j][2 * hr + 1] - db[cc + 1]));
            }
        }
        // dK += dS^T Q
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int dd = 0; dd < D / 16; ++dd) {
                uint32_t f[4];
                ldmatrix_x4_trans(f, frag_b(qb, LD, kk * 16, dd * 16, lane));
                mma_bf16(dk[2 * dd], pf[kk], f[0], f[1]);
                mma_bf16(dk[2 * dd + 1], pf[kk], f[2], f[3]);
            }
        }
        __syncthreads();  // the next iteration refills this item's buffer
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = krow[hr];
        if (row >= p.T) continue;
        bf16* krw = p.dk + b * p.dk_sb + hk * p.dk_sh + row * p.dk_ss + 2 * c;
        bf16* vrw = p.dv + b * p.dv_sb + hk * p.dv_sh + row * p.dv_ss + 2 * c;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            *reinterpret_cast<__nv_bfloat162*>(krw + dt * 8) = __floats2bfloat162_rn(
                dk[dt][2 * hr] * p.scale, dk[dt][2 * hr + 1] * p.scale);
            *reinterpret_cast<__nv_bfloat162*>(vrw + dt * 8) =
                __floats2bfloat162_rn(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
        }
    }
}

template <int D>
int launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
    const int bytes = static_cast<int>(Smem<D>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((p.S + BM - 1) / BM, p.H, B);
    flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
    const int bytes = static_cast<int>(Smem<D>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((p.T + BM - 1) / BM, p.H / p.rep, B);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk,
                      void* dv, int H, int Hkv, int S, int T, int kv_len, int q_offset,
                      int causal, float scale, const int64_t* st) {
    BwdParams p;
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.o = static_cast<const bf16*>(out);
    p.dout = static_cast<const bf16*>(dout);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<float*>(delta);
    p.dq = static_cast<bf16*>(dq);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.H = H;
    p.rep = H / Hkv;
    p.S = S;
    p.T = T;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.causal = causal;
    p.scale = scale;
    p.scale_log2 = scale * kLog2e;
    p.q_sb = st[0];  p.q_sh = st[1];  p.q_ss = st[2];
    p.k_sb = st[3];  p.k_sh = st[4];  p.k_ss = st[5];
    p.v_sb = st[6];  p.v_sh = st[7];  p.v_ss = st[8];
    p.o_sb = st[9];  p.o_sh = st[10]; p.o_ss = st[11];
    p.do_sb = st[12]; p.do_sh = st[13]; p.do_ss = st[14];
    p.dq_sb = st[15]; p.dq_sh = st[16]; p.dq_ss = st[17];
    p.dk_sb = st[18]; p.dk_sh = st[19]; p.dk_ss = st[20];
    p.dv_sb = st[21]; p.dv_sh = st[22]; p.dv_ss = st[23];
    return p;
}

}  // namespace

// Shared layout of both entry points: q, out, dO, dq [B,H,S,D] and k, v, dk,
// dv [B,Hkv,T,D] as strided bf16 views whose last dim is contiguous; lse and
// delta [B,H,S] contiguous fp32.  strides holds the (batch, head, row)
// element strides of q, k, v, out, dO, dq, dk, dv in that order.  A pointer
// the pass does not touch may be null.  The wrapper checks shapes, 16-byte
// alignment and D in {32, 64, 128}.

// dq pass: writes dq and delta = rowsum(out * dO).
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           void* delta, void* dq, int B, int H, int Hkv, int S,
                                           int T, int D, int kv_len, int q_offset, int causal,
                                           float scale, const int64_t* strides, void* stream) {
    const BwdParams p = make_params(q, k, v, out, dout, lse, delta, dq, nullptr, nullptr, H,
                                    Hkv, S, T, kv_len, q_offset, causal, scale, strides);
    if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dq<32>(p, B, st);
        case 64: return launch_dq<64>(p, B, st);
        case 128: return launch_dq<128>(p, B, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// dk/dv pass: reads the delta the dq pass wrote (same stream, launched after).
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int B, int H, int Hkv, int S,
                                            int T, int D, int kv_len, int q_offset, int causal,
                                            float scale, const int64_t* strides, void* stream) {
    const BwdParams p = make_params(q, k, v, nullptr, dout, lse, const_cast<void*>(delta),
                                    nullptr, dk, dv, H, Hkv, S, T, kv_len, q_offset, causal,
                                    scale, strides);
    if (B == 0 || T == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dkv<32>(p, B, st);
        case 64: return launch_dkv<64>(p, B, st);
        case 128: return launch_dkv<128>(p, B, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
