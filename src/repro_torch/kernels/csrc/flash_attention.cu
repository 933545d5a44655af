// Flash attention forward (causal or full, GQA) for bf16 q/k/v.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_fwd_kernel (the
// Pallas TPU kernel behind `flash_attention_fwd`).
//
// Bound on an H100: at the serve path's prefill shapes (S = 512, head dim
// 128) the bytes of q and out and the tensor-core operations are of the same
// size, about 10 us each; at longer S the operations (4*D per unmasked
// score) dominate.  The kernel never writes the [S, T] scores or
// probabilities to device memory, so bytes stay at one read of q, k, v and
// one write of out and lse.
//
// Design:
// * One block (4 warps) per (64-row q tile, head, batch).  The TPU grid's
//   sequential kv axis becomes a loop inside the block over 64-row kv tiles,
//   so the online-softmax state (m, l, acc) never leaves the SM.  The loop
//   stops at the causal limit of the tile's last row.
// * kv head = q head / rep: the group's K/V are read in place, never copied.
// * Both products run on the tensor cores with `mma.sync` m16n8k16 (bf16 in,
//   fp32 accumulate), operands fetched from shared memory with `ldmatrix`.
//   Each warp owns 16 q rows; its Q fragments, scores, probabilities and
//   output accumulator stay in registers, whose layout is fixed by the PTX
//   ISA, so the online softmax rescales rows in place (four lanes share a
//   row and reduce with shuffles).  P is rounded to bf16 for P V, as
//   FlashAttention does; the row sums use the rounded values.
// * K/V tiles are double-buffered: `cp.async` fetches tile t+1 while tile t
//   is computed.  Rows past the end are zero-filled by the copy.  Shared
//   rows are padded by 16 bytes so `ldmatrix` is free of bank conflicts.
// * The mask is explicit: col < kv_len, and for causal col <= q_offset + row.
//   Rows past S are computed on zeros and never stored, so S and kv_len need
//   not be multiples of the tile (the Pallas grid drops such tails).
// * Inputs are taken with strides (last dim contiguous), so [B, S, H, D]
//   views go in without a transpose copy.  lse is returned in fp32 for the
//   training slice's backward pass.  wgmma, TMA and warp specialisation are
//   later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using mma_sm90::bf16;

namespace {

using namespace mma_sm90;

constexpr int BM = 64;              // q rows per block
constexpr int BN = 64;              // kv rows per tile
constexpr int kWarps = BM / 16;     // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
    static constexpr int LD = D + 8;     // q, k, v rows (bf16), padded by 16 B
    static constexpr size_t bytes = size_t(BM + 4 * BN) * LD * 2;   // q + 2 x (k, v)
};

struct Params {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    bf16* o;
    float* lse;                 // [B, H, S] contiguous
    int H, rep, S, kv_len, q_offset, causal;
    float scale_log2;           // softmax scale * log2(e)
    int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
    constexpr int LD = Smem<D>::LD;
    constexpr int VPR = D / 8;  // 16-byte vectors per row
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* q_sh = reinterpret_cast<bf16*>(smem);    // [BM][LD]
    bf16* k_sh = q_sh + BM * LD;                   // [2][BN][LD]
    bf16* v_sh = k_sh + 2 * BN * LD;               // [2][BN][LD]

    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * BM;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;          // fragment row group, column pair
    const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* kg = p.k + b * p.k_sb + (h / p.rep) * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + (h / p.rep) * p.v_sh;

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
    }
    if (n_tiles > 0) load_kv(0, 0);
    cp_async_commit();

    // rows g and g+8 of this warp's 16: absolute positions and column limits
    int lim[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + warp * 16 + g + 8 * hr;
        lim[hr] = p.causal ? min(p.kv_len, p.q_offset + row + 1) : p.kv_len;
    }
    uint32_t qf[D / 16][4];
    float o[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};

    for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            load_kv(t + 1, (t + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (t == 0) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                ldmatrix_x4(qf[kk], q_sh + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
        }
        const bf16* kb = k_sh + (t & 1) * BN * LD;
        const bf16* vb = v_sh + (t & 1) * BN * LD;

        // S = Q K^T: 16 rows x BN columns in BN/8 fragments
        float s[BN / 8][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int jj = 0; jj < BN / 16; ++jj) {
                uint32_t kf[4];
                ldmatrix_x4(kf, kb + (jj * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                                    ((lane / 8) % 2) * 8);
                mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
                mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
            }
        }

        // mask, scale (base 2) and the online softmax for rows g and g+8
        const int n0 = t * BN;
        uint32_t pf[BN / 16][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + j * 8 + 2 * c + e;
                    float& sv = s[j][2 * hr + e];
                    sv = col < lim[hr] ? sv * p.scale_log2 : -INFINITY;
                    mx = fmaxf(mx, sv);
                }
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_i[hr], mx);
            const float m_use = (m_new == -INFINITY) ? 0.f : m_new;  // fully masked so far
            const float alpha = exp2f(m_i[hr] - m_use);
            float rsum = 0.f;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                float r0, r1;
                const uint32_t packed = pack_bf16(exp2f(s[j][2 * hr] - m_use),
                                                  exp2f(s[j][2 * hr + 1] - m_use), r0, r1);
                rsum += r0 + r1;
                // A fragment of P for k-step j/2: regs {0,1} from even tiles, {2,3} odd
                pf[j / 2][(j % 2) * 2 + hr] = packed;
            }
            rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
            rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
            l_i[hr] = l_i[hr] * alpha + rsum;
            m_i[hr] = m_new;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt) {
                o[dt][2 * hr] *= alpha;
                o[dt][2 * hr + 1] *= alpha;
            }
        }

        // O += P V
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int dd = 0; dd < D / 16; ++dd) {
                uint32_t vf[4];
                ldmatrix_x4_trans(vf, vb + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                          dd * 16 + (lane / 16) * 8);
                mma_bf16(o[2 * dd], pf[kk], vf[0], vf[1]);
                mma_bf16(o[2 * dd + 1], pf[kk], vf[2], vf[3]);
            }
        }
        __syncthreads();  // the next iteration refills this tile's buffer
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + warp * 16 + g + 8 * hr;
        if (row >= p.S) continue;
        const float inv = l_i[hr] > 0.f ? 1.f / l_i[hr] : 0.f;
        bf16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss + 2 * c;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
            *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
                __floats2bfloat162_rn(o[dt][2 * hr] * inv, o[dt][2 * hr + 1] * inv);
        if (c == 0)
            p.lse[(int64_t(b) * p.H + h) * p.S + row] =
                l_i[hr] > 0.f ? (m_i[hr] + log2f(l_i[hr])) * kLn2 : -INFINITY;
    }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
    const int bytes = static_cast<int>(Smem<D>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((p.S + BM - 1) / BM, p.H, B);
    flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,H,S,D], k/v [B,Hkv,T,D], out [B,H,S,D] as strided bf16 views whose
// last dim is contiguous; lse [B,H,S] contiguous fp32.  strides holds the
// (batch, head, row) element strides of q, k, v, out in that order.  The
// wrapper checks shapes, 16-byte alignment and D in {32, 64, 128}.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* out, void* lse, int B, int H, int Hkv,
                                        int S, int D, int kv_len, int q_offset,
                                        int causal, float scale, const int64_t* strides,
                                        void* stream) {
    Params p;
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.o = static_cast<bf16*>(out);
    p.lse = static_cast<float*>(lse);
    p.H = H;
    p.rep = H / Hkv;
    p.S = S;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.causal = causal;
    p.scale_log2 = scale * 1.4426950408889634f;
    p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
    p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
    p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
    p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
    if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch<32>(p, B, st);
        case 64: return launch<64>(p, B, st);
        case 128: return launch<128>(p, B, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
