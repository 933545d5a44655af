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
// w_j = exp(cum_last - cum_j), ec_i = exp(cum_i), H the state entering the
// chunk and G the gradient on the state leaving it:
//   G    = exp(cum_last) G' + sum_i ec_i dy_i C_i^T over the next chunk (G')
//   du_j = sum_{i >= j} exp(cum_i - cum_j) (C_i . B_j) dy_i + w_j G B_j
//   dx = dt du;  ddt = du . x + A sum_{i >= k} dcum_i;  dB, dC summed over
//   the heads;  da_log = sum dt A sum_{i >= k} dcum_i.
//
// Bound on an H100: at the mamba2-130m train shape (8 x 2048 tokens, 24
// heads, P 64, N 128) ~0.22 GB of inputs and outputs (0.066 ms at 3.35
// TB/s) and ~92 GFLOP of bf16 tensor-core products over the causal pairs,
// with each fp32 operand split into bf16 hi + lo (chip_smoke.py's
// `ssd_bwd_work`: 0.093 ms at 989 TFLOP/s): operations bound.  What bounds
// this design is device memory: the walkers write the state, gradient and
// dy images (0.50 GB) that the gradient pass reads back, ~1.2 GB moved in
// all, 0.36 ms at 3.35 TB/s; measured (PERF.md, tools/kernel_ab.py) the
// walkers take ~0.31 ms and the gradient pass ~0.25 ms, each moving ~2.1-2.4
// TB/s.  The design keeps every per-head partial of dB and dC out of device
// memory, moves each image once each way, and writes the images in whole
// lines (stores scattered from the accumulator layout measured 0.49 ms of
// a 0.69 ms walk).
//
// Design (deterministic: no float atomics, every sum in a fixed order):
// * Products on the tensor cores, as the forward scan runs them: wgmma with
//   bf16 operands, each fp32 operand split into bf16 hi + lo; fp32 x fp32
//   is three products (lo x lo dropped, hi rounded), fp32 x bf16 two (hi
//   truncated), sums in fp32.  dcum (a difference of nearly equal sums)
//   is summed in fp32 on the CUDA cores from the products' fp32 results.
// * ssd_bwd_walk_kernel, one block a (head, batch, direction): a walker
//   carries the fp32 state [P, N] across the chunks in wgmma accumulators,
//   as the forward scan's state warpgroup: forward from h0 through
//   h = exp(cum_last) h + (x dt w)^T B, backward from dh_final through
//   g = exp(cum_last) g + (dy ec)^T C.  Before each chunk's update it
//   stages the state as a bf16 hi + lo image in shared memory (stmatrix, in
//   the swizzled layout of a wgmma operand, so the gradient pass copies it
//   in whole and splits nothing) and one thread writes it out with a bulk
//   copy; the backward walker also stages dy's hi + lo image.  What the
//   backward walker holds at the end is dh0.  A producer warp TMA-loads B
//   or C into a 2-stage ring and scans dt into the row factors; 101 KB, two
//   blocks an SM, the backward walks (the heavier) launched first.
// * ssd_bwd_grads_kernel, one block a (chunk, batch), the heads in order:
//   C B^T once (a warpgroup keeps it in registers), and dB, dC summed over
//   the heads in wgmma accumulators of two other warpgroups, so no
//   per-head partial reaches device memory.  A producer warpgroup (24
//   registers after setmaxnreg) TMA-loads each head's x tile and
//   bulk-copies its dy, G and H images, one head ahead (x, dy and G in two
//   stages; H in one, refilled once warpgroup 2 is done with it), and
//   scans dt.  Per head:
//     warpgroup 0: (u dy^T)^T, the masked decays E^T, att^T = E^T (C B^T)^T,
//       ed^T = E^T (u dy^T)^T (to shared memory) and the row and column sums
//       of m = att (dy . u); du = att^T dy + w (B G^T); dx, du . x, u . (w G B);
//     warpgroup 1: dB += (u w) G + ed^T C; the chunk's dcum, its reverse
//       cumsum, ddt and its share of da_log (one warp, shuffles);
//     warpgroup 2: C H^T and dC += (dy ec) H + ed B; dC's exponent term
//       ec dy . (C H^T); <G, H>.
//   206 KB, one block an SM, no instance spills.
// * ssd_bwd_da_kernel: da_log's shares over (batch, chunk), in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace hopper_sm90;
typedef __nv_bfloat16 bf16;

constexpr int L = 64;                   // rows per chunk
constexpr int PP = 64;                  // P padded: the rows of a walker's state
constexpr float kLog2e = 1.4426950408889634f;
// a chunk's row factors, [5][64] fp32: dt, cum (in log2 units), dt w, w, ec
constexpr int RF_DT = 0, RF_CUM = L, RF_DTW = 2 * L, RF_W = 3 * L, RF_EC = 4 * L;
constexpr int RF_BYTES = 2048;

constexpr int up1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// The bytes of one bf16 plane (hi or lo) of a state image [P x N] and of a
// dy image [64 x P]; an image is its hi plane, then its lo plane.
template <int P, int N>
struct Img {
    static constexpr int STATE = P * N * 2;
    static constexpr int DY = L * P * 2;
};

struct Params {
    const bf16* x;              // [batch, S, H, P], strides xs0..2, last dim contiguous
    const float* dt;            // [batch, S, H]
    const float* a_log;         // [H]
    const float* h0;            // [batch, H, P, N] or null (zeros)
    const float* dy;            // [batch, S, H, P]
    const float* dhf;           // [batch, H, P, N] or null (zeros)
    bf16* dx;                   // [batch, S, H, P]
    float* ddt;                 // [batch, S, H]
    float* da_log;              // [H]
    bf16* dB;                   // [batch, S, N]
    bf16* dC;                   // [batch, S, N]
    float* dh0;                 // [batch, H, P, N] or null (not wanted)
    unsigned char* himg;        // [batch, H, NC] images of the state entering each chunk
    unsigned char* gimg;        // [batch, H, NC] images of the gradient on the state leaving it
    unsigned char* dyimg;       // [batch, H, NC] images of the chunk's dy
    float* da_part;             // [batch, NC, H]
    int64_t xs0, xs1, xs2;
    int batch, S, H, NC;
};

// Rows lane and lane + 32 of the chunk at row s0, by one warp: dt (0 past
// S), cum = the in-chunk cumsum of dt A log2(e) (falling, so every exponent
// below is <= 0), dt 2^(last - cum), 2^(last - cum) and 2^cum.  The walkers
// and the gradient pass compute them alike, to the bit.
__device__ __forceinline__ void row_factors(const float* dtb, int H, int S, int s0, float a2,
                                            int lane, float* rf) {
    const float d0 = s0 + lane < S ? dtb[int64_t(s0 + lane) * H] : 0.f;
    const float d1 = s0 + lane + 32 < S ? dtb[int64_t(s0 + lane + 32) * H] : 0.f;
    float c0 = d0 * a2, c1 = d1 * a2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
        if (lane >= off) {
            c0 += u0;
            c1 += u1;
        }
    }
    c1 += __shfl_sync(0xffffffffu, c0, 31);
    const float last = __shfl_sync(0xffffffffu, c1, 31);
    const float w0 = exp2f(last - c0), w1 = exp2f(last - c1);
    rf[RF_DT + lane] = d0;
    rf[RF_DT + lane + 32] = d1;
    rf[RF_CUM + lane] = c0;
    rf[RF_CUM + lane + 32] = c1;
    rf[RF_DTW + lane] = d0 * w0;
    rf[RF_DTW + lane + 32] = d1 * w1;
    rf[RF_W + lane] = w0;
    rf[RF_W + lane + 32] = w1;
    rf[RF_EC + lane] = exp2f(c0);
    rf[RF_EC + lane + 32] = exp2f(c1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// the sum over the four lanes of a quad (the lanes that share accumulator rows)
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---------------------------------------------------------------------------
// the walkers
// ---------------------------------------------------------------------------
constexpr int kWalkStages = 2;
constexpr int kWalkThreads = 128 + 32;  // the state warpgroup + the producer warp

template <int P, int N>
struct WalkSmem {
    using I = Img<P, N>;
    static constexpr int BC = L * N * 2;                 // B or C [64 x N]
    static constexpr int STAGE = BC + RF_BYTES;          // and the row factors
    static constexpr int OP = L * PP * 2;                // one [64 x 64] bf16 operand
    static constexpr int op_off = kWalkStages * STAGE;   // the update's operand: hi, lo
    static constexpr int img_off = op_off + 2 * OP;      // the state's image: hi, lo
    static constexpr int dy_off = img_off + up1k(2 * I::STATE);   // dy's image: hi, lo
    static constexpr int bar_off = dy_off + up1k(2 * I::DY);
    static constexpr size_t bytes = bar_off + 2 * kWalkStages * 8 + 1024;   // + alignment
};

// The state (accumulator layout; rows p < P) as the hi and lo planes of its
// image: the swizzled [P x N] tile (swz_addr<N, P>) that the gradient pass
// copies in whole and reads as a wgmma operand, here in shared memory, four
// 8x8 blocks a stmatrix.  hi is rounded: lo x lo terms are dropped there.
template <int P, int N>
__device__ __forceinline__ void stage_state_image(const float (&h)[N / 2], uint32_t hi_tile,
                                                  uint32_t lo_tile, int warp, int lane) {
    if (16 * warp >= P) return;
    const int m = lane / 8;
    const int row = warp * 16 + lane % 8 + 8 * (m % 2);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int hr = q % 2, jj = j + q / 2;
            split_bf16x2<true>(h[4 * jj + 2 * hr], h[4 * jj + 2 * hr + 1], hi[q], lo[q]);
        }
        const uint32_t off = swz_addr<N, P>(0, row, 8 * (j + m / 2));
        stsm_x4(hi_tile + off, hi[0], hi[1], hi[2], hi[3]);
        stsm_x4(lo_tile + off, lo[0], lo[1], lo[2], lo[3]);
    }
}

template <int P, int N>
__global__ void __launch_bounds__(kWalkThreads, 2)
    ssd_bwd_walk_kernel(const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tc, const Params p) {
    using M = WalkSmem<P, N>;
    using I = Img<P, N>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + M::bar_off);    // [kWalkStages]
    uint64_t* empty = full + kWalkStages;                               // [kWalkStages]

    const int hh = blockIdx.x, bb = blockIdx.y;
    // the backward walker (G, then dh0), which also reads dy and stores its
    // image, is blockIdx.z 0, so that the heavier walks start first
    const bool rev = blockIdx.z == 0;
    const int tid = threadIdx.x, lane = tid % 32;
    if (tid == 0) {
        for (int s = 0; s < kWalkStages; ++s) {
            mbar_init(&full[s], 1 + 32);    // TMA's expect_tx and the 32 row-factor lanes
            mbar_init(&empty[s], 4);        // one arrival per warp of the warpgroup
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (tid >= 128) {               // producer warp: B (forward) or C (backward), row factors
        const float* dtb = p.dt + int64_t(bb) * p.S * p.H + hh;
        const float a2 = -expf(p.a_log[hh]) * kLog2e;
        for (int k = 0; k < p.NC; ++k) {
            const int ch = rev ? p.NC - 1 - k : k, s = k % kWalkStages;
            unsigned char* st = smem + s * M::STAGE;
            if (k >= kWalkStages) mbar_wait(&empty[s], (k / kWalkStages - 1) & 1);
            if (lane == 0) {
                mbar_expect_tx(&full[s], M::BC);
                tma_load_tile<N, L>(reinterpret_cast<bf16*>(st), rev ? &tc : &tb, &full[s], ch * L,
                                    bb, 0);
            }
            row_factors(dtb, p.H, p.S, ch * L, a2, lane, reinterpret_cast<float*>(st + M::BC));
            mbar_arrive(&full[s]);
        }
        __syncwarp();
        return;
    }

    // the state warpgroup: accumulator rows 16 warp + g (+ 8), columns 8 j + 2 c (+ 1)
    const int warp = tid / 32, g = lane / 4, c = lane % 4;
    const uint32_t op_hi = smem_u32(smem + M::op_off), op_lo = op_hi + M::OP;
    const uint32_t img_hi = smem_u32(smem + M::img_off), img_lo = img_hi + I::STATE;
    const uint32_t dy_hi = smem_u32(smem + M::dy_off), dy_lo = dy_hi + I::DY;
    // this warp writes columns 16 warp .. + 15 of rows lane and lane + 32 of the
    // operand (zeros past P) and of dy's image
    const bool cols = 16 * warp < P;
    const int64_t bh = int64_t(bb) * p.H + hh;
    const float* init = rev ? p.dhf : p.h0;
    float h[N / 2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = warp * 16 + g + 8 * hr;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            float2 v = make_float2(0.f, 0.f);
            if (init && row < P)
                v = *reinterpret_cast<const float2*>(init + (bh * P + row) * N + 8 * j + 2 * c);
            h[4 * j + 2 * hr] = v.x;
            h[4 * j + 2 * hr + 1] = v.y;
        }
    }
    unsigned char* img = (rev ? p.gimg : p.himg) + bh * p.NC * 2 * I::STATE;
    unsigned char* dimg = p.dyimg + bh * p.NC * 2 * I::DY;
    for (int k = 0; k < p.NC; ++k) {
        const int ch = rev ? p.NC - 1 - k : k, s = k % kWalkStages, s0 = ch * L;
        // this chunk's x (forward) or dy (backward): columns 16 warp .. + 15
        // of rows lane and lane + 32, 0 past S and past P
        float v[2][16];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = s0 + lane + 32 * half;
#pragma unroll
            for (int e = 0; e < 16; ++e) v[half][e] = 0.f;
            if (cols && r < p.S) {
                if (rev) {
                    const float4* src = reinterpret_cast<const float4*>(
                        p.dy + ((int64_t(bb) * p.S + r) * p.H + hh) * P + 16 * warp);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float4 f = src[e];
                        v[half][4 * e] = f.x;
                        v[half][4 * e + 1] = f.y;
                        v[half][4 * e + 2] = f.z;
                        v[half][4 * e + 3] = f.w;
                    }
                } else {
                    const uint4* src = reinterpret_cast<const uint4*>(
                        p.x + bb * p.xs0 + r * p.xs1 + hh * p.xs2 + 16 * warp);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const uint4 u = src[e];
                        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
                        for (int t = 0; t < 4; ++t) {
                            const float2 f = bf2_to_f2(w4[t]);
                            v[half][8 * e + 2 * t] = f.x;
                            v[half][8 * e + 2 * t + 1] = f.y;
                        }
                    }
                }
            }
        }
        // the chunk before's image stores have read their shared memory
        if (tid == 0) bulk_wait_read<0>();
        named_sync(1, 128);
        mbar_wait(&full[s], (k / kWalkStages) & 1);
        const unsigned char* st = smem + s * M::STAGE;
        const float* rf = reinterpret_cast<const float*>(st + M::BC);
        // the update's operand (x dt w or dy ec, as hi + lo: it meets B or C,
        // which are exact, so hi is truncated); the backward walker also
        // stages dy's image (hi rounded)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = lane + 32 * half;
            const float f = rf[(rev ? RF_EC : RF_DTW) + r];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                uint32_t hi[4], lo[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    split_bf16x2<false>(v[half][8 * q + 2 * e] * f, v[half][8 * q + 2 * e + 1] * f,
                                        hi[e], lo[e]);
                const uint32_t off = swz_addr<PP, L>(0, r, 16 * warp + 8 * q);
                sts_u4(op_hi + off, make_uint4(hi[0], hi[1], hi[2], hi[3]));
                sts_u4(op_lo + off, make_uint4(lo[0], lo[1], lo[2], lo[3]));
                if (rev && cols) {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        split_bf16x2<true>(v[half][8 * q + 2 * e], v[half][8 * q + 2 * e + 1], hi[e],
                                           lo[e]);
                    const uint32_t doff = swz_addr<P, L>(0, r, 16 * warp + 8 * q);
                    sts_u4(dy_hi + doff, make_uint4(hi[0], hi[1], hi[2], hi[3]));
                    sts_u4(dy_lo + doff, make_uint4(lo[0], lo[1], lo[2], lo[3]));
                }
            }
        }
        // the state entering chunk ch (forward), or the gradient on the state
        // leaving it (backward), before the chunk's update
        stage_state_image<P, N>(h, img_hi, img_lo, warp, lane);
        fence_proxy_async();
        named_sync(1, 128);
        if (tid == 0) {
            bulk_store(img + int64_t(ch) * 2 * I::STATE, smem + M::img_off, 2 * I::STATE);
            if (rev) bulk_store(dimg + int64_t(ch) * 2 * I::DY, smem + M::dy_off, 2 * I::DY);
            bulk_commit();
        }
        // h = 2^cum_last h + op^T (B or C)
        const float decay = rf[RF_EC + L - 1];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) h[i] *= decay;
        const uint32_t bc = smem_u32(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
            wgmma_ss<N, 1, 1>(h, desc_mn<PP, L>(op_hi, kk), desc_mn<N, L>(bc, kk), 1);
            wgmma_ss<N, 1, 1>(h, desc_mn<PP, L>(op_lo, kk), desc_mn<N, L>(bc, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(h);
        named_sync(1, 128);             // every read of the operand and the stage is done
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (tid == 0) bulk_wait<0>();       // the last images are written
    if (rev && p.dh0 && 16 * warp < P) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = warp * 16 + g + 8 * hr;
#pragma unroll
            for (int j = 0; j < N / 8; ++j)
                *reinterpret_cast<float2*>(p.dh0 + (bh * P + row) * N + 8 * j + 2 * c) =
                    make_float2(h[4 * j + 2 * hr], h[4 * j + 2 * hr + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// the gradient pass
// ---------------------------------------------------------------------------
constexpr int kGradThreads = 4 * 128;   // three consumer warpgroups + a producer warpgroup
// registers a thread after setmaxnreg, 128 x (24 + 176 + 136 + 176) = 65536:
// the split at which no instance spills
constexpr int kProducerRegs = 24, kPairsRegs = 176, kDbRegs = 136, kDcRegs = 176;

// a head's per-row sums, [ROWS] fp32: sum_i m_ij, warp w's share of
// sum_j m_ij, dC's exponent term, u . (w G B), du . x, <G, H> by warp
constexpr int R_MCOL = 0, R_MROW = L, R_DCI = 5 * L, R_ST = 6 * L, R_DDTD = 7 * L, R_GH = 8 * L;
constexpr int ROWS = 8 * L + 8;

template <int P, int N>
struct GradSmem {
    using I = Img<P, N>;
    static constexpr int BC = up1k(L * N * 2);           // B or C [64 x N]
    static constexpr int X = up1k(L * P * 2);            // x [64 x P]
    static constexpr int DY = up1k(2 * I::DY);           // dy hi, lo
    static constexpr int ST = up1k(2 * I::STATE);        // a state image: hi, lo
    static constexpr int STAGE = X + DY + ST;            // a head's x, dy and G
    static constexpr int stage_off = 2 * BC;
    static constexpr int h_off = stage_off + 2 * STAGE;  // the head's H
    static constexpr int ed_off = h_off + ST;            // ed^T hi, lo [64 x 64]
    static constexpr int rf_off = ed_off + 2 * L * L * 2;
    static constexpr int rows_off = rf_off + 2 * RF_BYTES;
    static constexpr int bar_off = rows_off + 2 * ROWS * 4;
    static constexpr size_t bytes = bar_off + 8 * 8 + 1024;   // + alignment
};

// The chunk's dcum (the gradient on each row's cum), its sums from the
// bottom, ddt and the head's share of da_log, by one warp: lane l owns rows
// 2 l and 2 l + 1.
__device__ __forceinline__ void chunk_tail(const Params& p, const float* rf, const float* rows,
                                           int bb, int ck, int hh, int lane) {
    const float A = -expf(p.a_log[hh]);
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int k = 2 * lane + e;
        const float mrow = rows[R_MROW + k] + rows[R_MROW + L + k] + rows[R_MROW + 2 * L + k] +
                           rows[R_MROW + 3 * L + k];
        d[e] = mrow - rows[R_MCOL + k] + rows[R_DCI + k] - rows[R_ST + k];
    }
    // the last row's exponent also carries the state's: sum_j u_j . (w_j G B_j)
    // and exp(cum_last) <G, H>
    const float sts = warp_sum(rows[R_ST + 2 * lane] + rows[R_ST + 2 * lane + 1]);
    if (lane == 31) {
        const float gh = rows[R_GH] + rows[R_GH + 1] + rows[R_GH + 2] + rows[R_GH + 3];
        d[1] += sts + rf[RF_EC + L - 1] * gh;
    }
    float t = d[0] + d[1];                          // sums over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, t, off);
        if (lane + off < 32) t += v;
    }
    float after = __shfl_down_sync(0xffffffffu, t, 1);
    if (lane == 31) after = 0.f;
    float r[2];
    r[1] = after + d[1];
    r[0] = r[1] + d[0];
    float da = 0.f;
    const int s0 = ck * L;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int k = 2 * lane + e;
        if (s0 + k < p.S) p.ddt[(int64_t(bb) * p.S + s0 + k) * p.H + hh] = rows[R_DDTD + k] + A * r[e];
        da += rf[RF_DT + k] * A * r[e];
    }
    da = warp_sum(da);
    if (lane == 0) p.da_part[(int64_t(bb) * p.NC + ck) * p.H + hh] = da;
}

template <int P, int N>
__global__ void __launch_bounds__(kGradThreads, 1)
    ssd_bwd_grads_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tb,
                         const __grid_constant__ CUtensorMap tc, const Params p) {
    using M = GradSmem<P, N>;
    using I = Img<P, N>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + M::bar_off);
    uint64_t* bc_full = bars;
    uint64_t* full = bars + 1;          // [2]: a head's x, dy, G and row factors
    uint64_t* empty = bars + 3;         // [2]
    uint64_t* h_full = bars + 5;        // the head's H
    uint64_t* h_empty = bars + 6;

    const int ck = blockIdx.x, bb = blockIdx.y, s0 = ck * L;
    const int tid = threadIdx.x, lane = tid % 32;
    if (tid == 0) {
        mbar_init(bc_full, 1);
        for (int s = 0; s < 2; ++s) {
            mbar_init(&full[s], 1 + 32);    // TMA's expect_tx and the 32 row-factor lanes
            mbar_init(&empty[s], 12);       // one arrival per consumer warp
        }
        mbar_init(h_full, 1);
        mbar_init(h_empty, 4);              // the warps of warpgroup 2
        mbar_fence_init();
    }
    __syncthreads();
    const uint32_t b_t = smem_u32(smem), c_t = b_t + M::BC;
    const uint32_t h_hi = smem_u32(smem + M::h_off), h_lo = h_hi + I::STATE;
    const uint32_t ed_hi = smem_u32(smem + M::ed_off), ed_lo = ed_hi + L * L * 2;

    if (tid >= 384) {               // producer warpgroup: its first warp loads
        setmaxnreg_dec<kProducerRegs>();
        if (tid >= 384 + 32) return;
        if (lane == 0) {
            mbar_expect_tx(bc_full, 2 * L * N * 2);
            tma_load_tile<N, L>(reinterpret_cast<bf16*>(smem), &tb, bc_full, s0, bb, 0);
            tma_load_tile<N, L>(reinterpret_cast<bf16*>(smem + M::BC), &tc, bc_full, s0, bb, 0);
        }
        for (int hh = 0; hh < p.H; ++hh) {
            const int s = hh & 1;
            unsigned char* st = smem + M::stage_off + s * M::STAGE;
            const int64_t blk = (int64_t(bb) * p.H + hh) * p.NC + ck;
            if (hh >= 2) mbar_wait(&empty[s], ((hh >> 1) - 1) & 1);
            if (lane == 0) {
                mbar_expect_tx(&full[s], L * P * 2 + 2 * I::DY + 2 * I::STATE);
                tma_load_4d(st, &tx, &full[s], 0, s0, hh, bb);
                bulk_load(st + M::X, p.dyimg + blk * 2 * I::DY, 2 * I::DY, &full[s]);
                bulk_load(st + M::X + M::DY, p.gimg + blk * 2 * I::STATE, 2 * I::STATE, &full[s]);
            }
            row_factors(p.dt + int64_t(bb) * p.S * p.H + hh, p.H, p.S, s0,
                        -expf(p.a_log[hh]) * kLog2e, lane,
                        reinterpret_cast<float*>(smem + M::rf_off + s * RF_BYTES));
            mbar_arrive(&full[s]);
            if (hh >= 1) mbar_wait(h_empty, (hh - 1) & 1);
            if (lane == 0) {
                mbar_expect_tx(h_full, 2 * I::STATE);
                bulk_load(smem + M::h_off, p.himg + blk * 2 * I::STATE, 2 * I::STATE, h_full);
            }
        }
        __syncwarp();
        return;
    }

    // consumer warpgroup wg; accumulator rows 16 warp + g (+ 8), columns
    // 8 j + 2 q (+ 1); a row's ldmatrix address: row 16 warp + lane % 16,
    // column 8 (lane / 16) of each 16-column step
    const int wg = tid / 128, warp = (tid % 128) / 32, g = lane / 4, q = lane % 4;
    const int j0 = 16 * warp + g;
    const int lrow = 16 * warp + lane % 16, lcol = 8 * (lane / 16);
    float* rows_base = reinterpret_cast<float*>(smem + M::rows_off);

    if (wg == 0) {
        setmaxnreg_inc<kPairsRegs>();
        // C B^T transposed, for the whole block: row j, column i: B_j . C_i
        float cbt[L / 2];
#pragma unroll
        for (int i = 0; i < L / 2; ++i) cbt[i] = 0.f;
        mbar_wait(bc_full, 0);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss<L, 0, 0>(cbt, desc_k<N, L>(b_t, 0, kk), desc_k<N, L>(c_t, 0, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(cbt);
        for (int hh = 0; hh < p.H; ++hh) {
            const int s = hh & 1;
            const uint32_t x_t = smem_u32(smem + M::stage_off + s * M::STAGE);
            const uint32_t dy_hi = x_t + M::X, dy_lo = dy_hi + I::DY;
            const uint32_t g_hi = dy_hi + M::DY, g_lo = g_hi + I::STATE;
            const float* rf = reinterpret_cast<const float*>(smem + M::rf_off + s * RF_BYTES);
            float* rows = rows_base + s * ROWS;
            mbar_wait(&full[s], (hh >> 1) & 1);

            // x dy^T transposed (row j, column i: x_j . dy_i), dy as hi + lo
            float dut[L / 2];
#pragma unroll
            for (int i = 0; i < L / 2; ++i) dut[i] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk) {
                wgmma_ss<L, 0, 0>(dut, desc_k<P, L>(x_t, 0, kk), desc_k<P, L>(dy_hi, 0, kk), 1);
                wgmma_ss<L, 0, 0>(dut, desc_k<P, L>(x_t, 0, kk), desc_k<P, L>(dy_lo, 0, kk), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dut);

            // E^T (row j, column i: exp(cum_i - cum_j) for i >= j, 0 below the
            // diagonal: the exponent is -inf by selection), att^T = E^T (C B^T)^T
            // (hi + lo A registers), ed^T = E^T (u dy^T)^T (hi + lo to shared
            // memory, four 8x8 blocks a stmatrix) and m = att (dy . u)
            uint32_t ahi[L / 16][4], alo[L / 16][4];
            float rsum[2] = {0.f, 0.f}, csum[L / 8][2];
#pragma unroll
            for (int jj = 0; jj < L / 8; ++jj) csum[jj][0] = csum[jj][1] = 0.f;
            const float cj[2] = {rf[RF_CUM + j0], rf[RF_CUM + j0 + 8]};
            const float dj[2] = {rf[RF_DT + j0], rf[RF_DT + j0 + 8]};
            const int m8 = lane / 8;
            const int srow = 16 * warp + lane % 8 + 8 * (m8 % 2);
#pragma unroll
            for (int jp = 0; jp < L / 8; jp += 2) {
                uint32_t ehi[4], elo[4];
#pragma unroll
                for (int qq = 0; qq < 4; ++qq) {
                    const int hr = qq % 2, jj = jp + qq / 2;
                    float at[2], ed[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int i = 8 * jj + 2 * q + e, k = 4 * jj + 2 * hr + e;
                        const float E =
                            exp2_approx(i >= j0 + 8 * hr ? rf[RF_CUM + i] - cj[hr] : -INFINITY);
                        const float du = dut[k] * dj[hr];
                        at[e] = E * cbt[k];
                        ed[e] = E * du;
                        const float m = at[e] * du;
                        rsum[hr] += m;
                        csum[jj][e] += m;
                    }
                    split_bf16x2<true>(at[0], at[1], ahi[jj / 2][(jj % 2) * 2 + hr],
                                       alo[jj / 2][(jj % 2) * 2 + hr]);
                    split_bf16x2<false>(ed[0], ed[1], ehi[qq], elo[qq]);
                }
                const uint32_t off = swz_addr<L, L>(0, srow, 8 * (jp + m8 / 2));
                stsm_x4(ed_hi + off, ehi[0], ehi[1], ehi[2], ehi[3]);
                stsm_x4(ed_lo + off, elo[0], elo[1], elo[2], elo[3]);
            }
            fence_proxy_async();
            named_arrive(1, 384);           // ed^T is there for warpgroups 1 and 2
            // sum_i m_ij (row j): over the quad; this warp's share of sum_j m_ij
            // (column i): over the 8 rows g
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const float v = quad_sum(rsum[hr]);
                if (q == 0) rows[R_MCOL + j0 + 8 * hr] = v;
            }
#pragma unroll
            for (int jj = 0; jj < L / 8; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float v = csum[jj][e];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (g == 0) rows[R_MROW + warp * L + 8 * jj + 2 * q + e] = v;
                }

            // du = att^T dy (att and dy as hi + lo) and B G^T (G as hi + lo)
            float du[P / 2], dus[P / 2];
#pragma unroll
            for (int i = 0; i < P / 2; ++i) du[i] = dus[i] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < L / 16; ++kk) {
                wgmma_rs<P>(du, ahi[kk], desc_mn<P, L>(dy_hi, kk), 1);
                wgmma_rs<P>(du, ahi[kk], desc_mn<P, L>(dy_lo, kk), 1);
                wgmma_rs<P>(du, alo[kk], desc_mn<P, L>(dy_hi, kk), 1);
            }
#pragma unroll
            for (int kk = 0; kk < N / 16; ++kk) {
                wgmma_ss<P, 0, 0>(dus, desc_k<N, L>(b_t, 0, kk), desc_k<N, P>(g_hi, 0, kk), 1);
                wgmma_ss<P, 0, 0>(dus, desc_k<N, L>(b_t, 0, kk), desc_k<N, P>(g_lo, 0, kk), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(du);
            fence_regs(dus);
            fence_regs(ahi);
            fence_regs(alo);

            // du_j = att^T dy + w_j (B G^T)_j; dx = dt du; du . x; u . (w G B)
            const float wj[2] = {rf[RF_W + j0], rf[RF_W + j0 + 8]};
            float sx[2] = {0.f, 0.f}, sst[2] = {0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk) {
                uint32_t xr[4];
                ldsm_x4(xr, swz_addr<P, L>(x_t, lrow, 16 * kk + lcol));
#pragma unroll
                for (int qq = 0; qq < 4; ++qq) {
                    const int hr = qq % 2, jj = 2 * kk + qq / 2, k = 4 * jj + 2 * hr;
                    const float2 xv = bf2_to_f2(xr[qq]);
                    const float u0 = du[k] + wj[hr] * dus[k], u1 = du[k + 1] + wj[hr] * dus[k + 1];
                    sx[hr] += u0 * xv.x + u1 * xv.y;
                    sst[hr] += xv.x * dus[k] + xv.y * dus[k + 1];
                    const int r = s0 + j0 + 8 * hr;
                    if (r < p.S)
                        *reinterpret_cast<__nv_bfloat162*>(
                            p.dx + ((int64_t(bb) * p.S + r) * p.H + hh) * P + 8 * jj + 2 * q) =
                            __floats2bfloat162_rn(dj[hr] * u0, dj[hr] * u1);
                }
            }
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const float vx = quad_sum(sx[hr]), vs = quad_sum(sst[hr]);
                if (q == 0) {
                    rows[R_DDTD + j0 + 8 * hr] = vx;
                    rows[R_ST + j0 + 8 * hr] = vs * rf[RF_DTW + j0 + 8 * hr];
                }
            }
            named_sync(2, 384);             // the head's rows are written
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
        }
        return;
    }

    const int nrow = s0 + j0;           // this thread's first output row
    if (wg == 1) {
        setmaxnreg_inc<kDbRegs>();
        float db[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) db[i] = 0.f;
        mbar_wait(bc_full, 0);
        for (int hh = 0; hh < p.H; ++hh) {
            const int s = hh & 1;
            const uint32_t x_t = smem_u32(smem + M::stage_off + s * M::STAGE);
            const uint32_t g_hi = x_t + M::X + M::DY, g_lo = g_hi + I::STATE;
            const float* rf = reinterpret_cast<const float*>(smem + M::rf_off + s * RF_BYTES);
            float* rows = rows_base + s * ROWS;
            mbar_wait(&full[s], (hh >> 1) & 1);
            // dB += (u w) G: u_j w_j = x_j dt_j w_j as hi + lo A registers
            uint32_t fhi[P / 16][4], flo[P / 16][4];
            const float f[2] = {rf[RF_DTW + j0], rf[RF_DTW + j0 + 8]};
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk) {
                uint32_t xr[4];
                ldsm_x4(xr, swz_addr<P, L>(x_t, lrow, 16 * kk + lcol));
#pragma unroll
                for (int qq = 0; qq < 4; ++qq) {
                    const float2 xv = bf2_to_f2(xr[qq]);
                    split_bf16x2<true>(xv.x * f[qq % 2], xv.y * f[qq % 2], fhi[kk][qq], flo[kk][qq]);
                }
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk) {
                wgmma_rs<N>(db, fhi[kk], desc_mn<N, P>(g_hi, kk), 1);
                wgmma_rs<N>(db, fhi[kk], desc_mn<N, P>(g_lo, kk), 1);
                wgmma_rs<N>(db, flo[kk], desc_mn<N, P>(g_hi, kk), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(db);
            fence_regs(fhi);
            fence_regs(flo);
            // dB += ed^T C, once warpgroup 0 has written ed^T
            named_sync(1, 384);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < L / 16; ++kk) {
                wgmma_ss<N, 0, 1>(db, desc_k<L, L>(ed_hi, 0, kk), desc_mn<N, L>(c_t, kk), 1);
                wgmma_ss<N, 0, 1>(db, desc_k<L, L>(ed_lo, 0, kk), desc_mn<N, L>(c_t, kk), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(db);
            named_sync(2, 384);             // the head's rows are written
            if (warp == 0) chunk_tail(p, rf, rows, bb, ck, hh, lane);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int r = nrow + 8 * hr;
            if (r >= p.S) continue;
#pragma unroll
            for (int j = 0; j < N / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(p.dB + (int64_t(bb) * p.S + r) * N + 8 * j + 2 * q) =
                    __floats2bfloat162_rn(db[4 * j + 2 * hr], db[4 * j + 2 * hr + 1]);
        }
        return;
    }

    // warpgroup 2: dC
    setmaxnreg_inc<kDcRegs>();
    float dc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dc[i] = 0.f;
    mbar_wait(bc_full, 0);
    for (int hh = 0; hh < p.H; ++hh) {
        const int s = hh & 1;
        const uint32_t dy_hi = smem_u32(smem + M::stage_off + s * M::STAGE) + M::X;
        const uint32_t dy_lo = dy_hi + I::DY, g_hi = dy_hi + M::DY, g_lo = g_hi + I::STATE;
        const float* rf = reinterpret_cast<const float*>(smem + M::rf_off + s * RF_BYTES);
        float* rows = rows_base + s * ROWS;
        mbar_wait(&full[s], (hh >> 1) & 1);
        mbar_wait(h_full, hh & 1);
        // C H^T (H as hi + lo): row i, column p
        float chp[P / 2];
#pragma unroll
        for (int i = 0; i < P / 2; ++i) chp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
            wgmma_ss<P, 0, 0>(chp, desc_k<N, L>(c_t, 0, kk), desc_k<N, P>(h_hi, 0, kk), 1);
            wgmma_ss<P, 0, 0>(chp, desc_k<N, L>(c_t, 0, kk), desc_k<N, P>(h_lo, 0, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(chp);
        // dy (hi + lo) at this thread's positions: dC's exponent term
        // ec_i dy_i . (C H^T)_i, and dy_i ec_i as hi + lo A registers
        const float eci[2] = {rf[RF_EC + j0], rf[RF_EC + j0 + 8]};
        float dci[2] = {0.f, 0.f};
        uint32_t fhi[P / 16][4], flo[P / 16][4];
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {
            uint32_t yh[4], yl[4];
            const uint32_t a = swz_addr<P, L>(0, lrow, 16 * kk + lcol);
            ldsm_x4(yh, dy_hi + a);
            ldsm_x4(yl, dy_lo + a);
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
                const int hr = qq % 2, k = 4 * (2 * kk + qq / 2) + 2 * hr;
                const float2 vh = bf2_to_f2(yh[qq]), vl = bf2_to_f2(yl[qq]);
                const float v0 = vh.x + vl.x, v1 = vh.y + vl.y;
                dci[hr] += v0 * chp[k] + v1 * chp[k + 1];
                split_bf16x2<true>(v0 * eci[hr], v1 * eci[hr], fhi[kk][qq], flo[kk][qq]);
            }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const float v = quad_sum(dci[hr]);
            if (q == 0) rows[R_DCI + j0 + 8 * hr] = v * eci[hr];
        }
        // dC += (dy ec) H
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {
            wgmma_rs<N>(dc, fhi[kk], desc_mn<N, P>(h_hi, kk), 1);
            wgmma_rs<N>(dc, fhi[kk], desc_mn<N, P>(h_lo, kk), 1);
            wgmma_rs<N>(dc, flo[kk], desc_mn<N, P>(h_hi, kk), 1);
        }
        wgmma_commit();
        // meanwhile <G, H> (each as hi + lo), this thread's 16-byte chunks in order
        float gh = 0.f;
        for (int e = (tid % 128) * 16; e < I::STATE; e += 128 * 16) {
            const uint4 a = lds_u4(g_hi + e), b = lds_u4(g_lo + e);
            const uint4 c = lds_u4(h_hi + e), d = lds_u4(h_lo + e);
            const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
            const uint32_t cv[4] = {c.x, c.y, c.z, c.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const float2 ga = bf2_to_f2(av[t]), gb = bf2_to_f2(bv[t]);
                const float2 ha = bf2_to_f2(cv[t]), hb = bf2_to_f2(dv[t]);
                gh += (ga.x + gb.x) * (ha.x + hb.x) + (ga.y + gb.y) * (ha.y + hb.y);
            }
        }
        gh = warp_sum(gh);
        if (lane == 0) rows[R_GH + warp] = gh;
        wgmma_wait<0>();
        fence_regs(dc);
        fence_regs(fhi);
        fence_regs(flo);
        __syncwarp();
        if (lane == 0) mbar_arrive(h_empty);
        // dC += ed B, once warpgroup 0 has written ed^T (read M-major)
        named_sync(1, 384);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
            wgmma_ss<N, 1, 1>(dc, desc_mn<L, L>(ed_hi, kk), desc_mn<N, L>(b_t, kk), 1);
            wgmma_ss<N, 1, 1>(dc, desc_mn<L, L>(ed_lo, kk), desc_mn<N, L>(b_t, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dc);
        named_sync(2, 384);                 // the head's rows are written
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int r = nrow + 8 * hr;
        if (r >= p.S) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(p.dC + (int64_t(bb) * p.S + r) * N + 8 * j + 2 * q) =
                __floats2bfloat162_rn(dc[4 * j + 2 * hr], dc[4 * j + 2 * hr + 1]);
    }
}

// da_log: each head's shares over (batch, chunk), one warp a head, in a
// fixed order (each lane's shares in turn, then the lanes by shuffles)
constexpr int kDaWarps = 8;

__global__ void __launch_bounds__(32 * kDaWarps) ssd_bwd_da_kernel(const Params p) {
    const int hh = blockIdx.x * kDaWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (hh >= p.H) return;
    float s = 0.f;
    for (int64_t k = lane; k < int64_t(p.batch) * p.NC; k += 32) s += p.da_part[k * p.H + hh];
    s = warp_sum(s);
    if (lane == 0) p.da_log[hh] = s;
}

// dynamic shared memory up to `bytes`, with the carveout that leaves the
// most of it, so that three walker blocks fit an SM
template <class K>
cudaError_t set_smem(K* kernel, size_t bytes) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

template <int P, int N>
int launch(const void* x, const void* B, const void* C, const Params& p, const int64_t* st,
           cudaStream_t stream) {
    // x [batch, S, H, P] as (P, S, H, batch), one chunk a box, in the swizzled
    // layout of a K-major wgmma operand; B and C [batch, S, N] as (N, S,
    // batch, 1), as the forward scan reads them
    CUtensorMap tx, tb, tc;
    const cuuint64_t xd[4] = {cuuint64_t(P), cuuint64_t(p.S), cuuint64_t(p.H),
                              cuuint64_t(p.batch)};
    const int64_t xs[3] = {st[1], st[2], st[0]};
    int rc = encode_tiled(&tx, x, xd, xs, P, L, Swz<P>::TMA);
    const cuuint64_t bd[4] = {cuuint64_t(N), cuuint64_t(p.S), cuuint64_t(p.batch), 1};
    const int64_t bs[3] = {st[4], st[3], st[3]};
    const int64_t cs[3] = {st[6], st[5], st[5]};
    if (!rc) rc = encode_tiled(&tb, B, bd, bs, Swz<N>::COLS, L, Swz<N>::TMA);
    if (!rc) rc = encode_tiled(&tc, C, bd, cs, Swz<N>::COLS, L, Swz<N>::TMA);
    if (rc) return rc;
    cudaError_t e = set_smem(ssd_bwd_walk_kernel<P, N>, WalkSmem<P, N>::bytes);
    if (e == cudaSuccess) e = set_smem(ssd_bwd_grads_kernel<P, N>, GradSmem<P, N>::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_walk_kernel<P, N>
        <<<dim3(p.H, p.batch, 2), kWalkThreads, WalkSmem<P, N>::bytes, stream>>>(tb, tc, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_grads_kernel<P, N>
        <<<dim3(p.NC, p.batch), kGradThreads, GradSmem<P, N>::bytes, stream>>>(tx, tb, tc, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ssd_bwd_da_kernel<<<(p.H + kDaWarps - 1) / kDaWarps, 32 * kDaWarps, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(const void* x, const void* B, const void* C, const Params& p, const int64_t* st,
             int N, cudaStream_t stream) {
    switch (N) {
        case 16: return launch<P, 16>(x, B, C, p, st, stream);
        case 32: return launch<P, 32>(x, B, C, p, st, stream);
        case 64: return launch<P, 64>(x, B, C, p, st, stream);
        case 128: return launch<P, 128>(x, B, C, p, st, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <int P, int N>
int smem_bytes(int kind) {
    return static_cast<int>(kind == 0 ? WalkSmem<P, N>::bytes : GradSmem<P, N>::bytes);
}

template <int P>
int smem_bytes_n(int kind, int N) {
    switch (N) {
        case 16: return smem_bytes<P, 16>(kind);
        case 32: return smem_bytes<P, 32>(kind);
        case 64: return smem_bytes<P, 64>(kind);
        case 128: return smem_bytes<P, 128>(kind);
        default: return 0;
    }
}

}  // namespace

// x [batch, S, H, P] bf16 and B, C [batch, S, N] bf16 with the given strides
// (in elements; last dims contiguous, pointers and strides 16-byte aligned);
// dt [batch, S, H], a_log [H], dy [batch, S, H, P] fp32; h0 and dh_final
// [batch, H, P, N] fp32 or null (zeros).  Writes dx [batch, S, H, P] bf16,
// ddt [batch, S, H] fp32, da_log [H] fp32, dB, dC [batch, S, N] bf16 and,
// when dh0 is not null, dh0 [batch, H, P, N] fp32, all contiguous.  `ws`
// (256-byte aligned) holds batch H NC (2 P N + 64 P) + batch NC H floats,
// NC = ceil(S / 64).  strides: x0, x1, x2, b0, b1, c0, c1.  P one of 16, 32,
// 64; N one of 16, 32, 64, 128; S >= 1 (the wrapper checks all of it).
// Three launches on `stream`: the walkers, the gradients, da_log's sum.
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
    p.batch = batch;
    p.S = S;
    p.H = H;
    p.NC = (S + L - 1) / L;
    const int64_t chunks = int64_t(batch) * H * p.NC;
    p.himg = static_cast<unsigned char*>(ws);
    p.gimg = p.himg + chunks * P * N * 4;
    p.dyimg = p.gimg + chunks * P * N * 4;
    p.da_part = reinterpret_cast<float*>(p.dyimg + chunks * L * P * 4);
    if (batch == 0 || H == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (P) {
        case 16: return launch_n<16>(x, B, C, p, strides, N, s);
        case 32: return launch_n<32>(x, B, C, p, strides, N, s);
        default: return launch_n<64>(x, B, C, p, strides, N, s);
    }
}

// Dynamic shared memory of one block of the walkers (kind 0) or of the
// gradient pass (kind 1) at head dim P and state dim N (0 for another P, N).
extern "C" int ssd_scan_bwd_smem_bytes(int kind, int P, int N) {
    switch (P) {
        case 16: return smem_bytes_n<16>(kind, N);
        case 32: return smem_bytes_n<32>(kind, N);
        case 64: return smem_bytes_n<64>(kind, N);
        default: return 0;
    }
}
