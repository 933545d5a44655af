// Mamba2 SSD chunked scan (state-space duality), forward, for one group of
// bf16 B/C shared by the heads.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel (the Pallas TPU
// kernel behind `ssd_scan`).  Computes the function of
// src/repro/models/ssm.py::ssd_chunked: from a state h0 (zeros when none is
// given), at any sequence length,
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T,   y_t = h_t C_t,
// evaluated chunk by chunk, and returns y and the final state in fp32.
//
// Bound on an H100: at the mamba2-130m prefill shape (4 x 8192 tokens, 24
// heads, P 64, N 128) the bytes, ~0.33 GB (0.10 ms at 3.35 TB/s): the
// products this design runs on the tensor cores are ~84 GFLOP of bf16
// (0.085 ms at 989 TFLOP/s).  Per (batch, head) the 128 chunks form one
// chain through the state, so what bounds it in practice is the time of
// one chunk's steps, one after the other, on 96 of the 132 SMs.
//
// Design:
// * The TPU carries the [heads, P, N] state across an in-order grid axis.
//   Here one block owns a (batch, head) and loops over 64-row chunks; the
//   fp32 state [P, N] stays in the accumulator registers of one warpgroup
//   for the whole sequence (wgmma m64nN: row p, column n; P < 64 pads the
//   rows with zeros), so no per-chunk state reaches device memory.  B x H
//   blocks of 288 threads: a producer warp and two consumer warpgroups, one
//   that carries the state and one that computes y.
// * The producer TMA-loads each chunk's x [64 x P], B and C [64 x N] into a
//   3-stage ring (`full`/`empty` mbarriers, as the flash kernels).  x, B and
//   C are strided views of one conv output; each is a 4-D tensor map
//   encoded in the entry point, rows past S zero-filled.  The producer's
//   lanes read the chunk's dt, whose rows are H fp32 apart, which TMA
//   cannot take, scan dt A log2(e) into the in-chunk cumsum (shuffles) and
//   leave the row factors dt, cum, dt 2^(cum_last - cum) and 2^cum beside
//   the tiles.  Every exponent is <= 0 (cum falls along the chunk).  Rows
//   past S get dt = 0: they neither decay the state nor add to it.
// * State warpgroup, per chunk: x dt and x dt 2^(cum_last - cum_j) split
//   into bf16 hi + lo and written to shared memory as wgmma operands (the
//   first for the y warpgroup, behind an mbarrier pair); then
//     h = 2^cum_last h + (x dt w)^T B    A = (x dt w)^T hi, lo M-major from
//                                        shared memory, B N-major: two
//                                        products into the fp32 state;
//   and the state goes to shared memory once a chunk, as bf16 hi + lo, into
//   one of two buffers (mbarriers h_full / h_empty), the operand of the
//   next chunk's C h^T.
// * y warpgroup, per chunk:
//     G = C B^T                  wgmma m64n64, bf16 in, exact products,
//                                issued with the chunk before's last
//                                product so it is there when the chunk starts;
//     Y = C h^T                  h as bf16 hi + lo (two products), C exact;
//     att = 2^(cum_i - cum_j) G  formed while C h^T runs, for j <= i; above
//                                the diagonal the exponent is -inf by
//                                selection (2^-inf = 0 times a finite G),
//                                never a positive exponent that can be inf;
//     Y = 2^cum_i Y + att (x dt) att hi/lo from registers in the accumulator
//                                layout, x dt hi/lo MN-major: three products;
//   and y is stored from the accumulator in fp32.
// * Each fp32 operand split into hi + lo keeps ~16 bits of mantissa; the
//   sums stay fp32.  hi is rounded where a lo x lo term is dropped (att and
//   x dt), truncated where lo meets an exact bf16 operand (the state and
//   x dt w against C and B), which saves a conversion.  The chunk is 64
//   rows: the function does not depend on it (the plain version's is 256).
// * Measured (PERF.md): per chunk the elementwise work (the operand splits,
//   att, the state's copy, the y stores) takes more of each warpgroup's
//   time than its products do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace hopper_sm90;
typedef __nv_bfloat16 bf16;

constexpr int L = 64;                   // rows per chunk
constexpr int PP = 64;                  // P padded: rows of the state, columns of x dt
constexpr int kStages = 3;              // x/B/C ring depth
constexpr int kThreads = 2 * 128 + 32;  // the output and state warpgroups + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
// a stage's row factors, [4][64] fp32 after x, B and C
constexpr int RF_DT = 0, RF_CUM = L, RF_DTW = 2 * L, RF_ECUM = 3 * L;

template <int N>
struct Smem {
    static constexpr int X = L * PP * 2;                 // x [64 x P] (P <= 64), unswizzled
    static constexpr int BC = L * N * 2;                 // B or C [64 x N]
    static constexpr int STAGE = X + 2 * BC + 1024;      // x, B, C, the row factors
    static constexpr int W = L * PP * 2;                 // one [64 x 64] bf16 operand
    static constexpr int H = PP * N * 2;                 // the state [64 x N] in bf16
    static constexpr int work_off = kStages * STAGE;     // x dt hi, lo; x dt w hi, lo
    static constexpr int h_off = work_off + 4 * W;       // [2 buffers] state hi, lo
    static constexpr int bar_off = h_off + 4 * H;
    static constexpr size_t bytes = bar_off + (2 * kStages + 6) * 8 + 1024;   // + alignment
};

struct Params {
    const float* dt;            // [B, S, H] contiguous
    const float* a_log;         // [H]
    const float* h0;            // [B, H, P, N] contiguous, or null
    float* y;                   // [B, S, H, P] contiguous
    float* hfin;                // [B, H, P, N] contiguous
    int S, H, P;
};

// the state (accumulator layout) to shared memory as bf16 hi and lo tiles,
// four 8x8 blocks a stmatrix: rows g and g + 8 of the warp's 16, column
// blocks j and j + 1
template <int N>
__device__ __forceinline__ void write_state(const float (&h)[N / 2], uint32_t hi_addr,
                                            uint32_t lo_addr, int warp, int lane) {
    const int m = lane / 8;
    const uint32_t row = warp * 16 + lane % 8 + 8 * (m % 2);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int hr = q % 2, jj = j + q / 2;
            split_bf16x2<false>(h[4 * jj + 2 * hr], h[4 * jj + 2 * hr + 1], hi[q], lo[q]);
        }
        const uint32_t off = swz_addr<N, PP>(0, row, 8 * (j + m / 2));
        stsm_x4(hi_addr + off, hi[0], hi[1], hi[2], hi[3]);
        stsm_x4(lo_addr + off, lo[0], lo[1], lo[2], lo[3]);
    }
}

// v (16 bf16 of x, 8 a register pair) times f, split into bf16 hi and lo,
// stored as two 16-byte chunks (offsets off0, off1) of the hi and lo tiles
template <bool Round>
__device__ __forceinline__ void write_split(const uint4 (&v)[2], float f, uint32_t hi_tile,
                                            uint32_t lo_tile, uint32_t off0, uint32_t off1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&v[q]);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(xh[e]);
            split_bf16x2<Round>(x.x * f, x.y * f, hi[e], lo[e]);
        }
        const uint32_t off = q ? off1 : off0;
        sts_u4(hi_tile + off, make_uint4(hi[0], hi[1], hi[2], hi[3]));
        sts_u4(lo_tile + off, make_uint4(lo[0], lo[1], lo[2], lo[3]));
    }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc, const Params p) {
    using M = Smem<N>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + M::bar_off);    // [kStages]
    uint64_t* empty = full + kStages;                                   // [kStages]
    uint64_t* h_full = empty + kStages;                                 // [2]
    uint64_t* h_empty = h_full + 2;                                     // [2]
    uint64_t* xdt_full = h_empty + 2;
    uint64_t* xdt_empty = xdt_full + 1;

    const int hh = blockIdx.x, bb = blockIdx.y;
    const int nchunks = (p.S + L - 1) / L;
    const int tid = threadIdx.x, lane = tid % 32;
    const float a2 = -expf(p.a_log[hh]) * kLog2e;      // A log2(e): decays are powers of 2
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1 + 32);    // TMA's expect_tx and the 32 row-factor lanes
            mbar_init(&empty[s], 8);        // one arrival per consumer warp
        }
        for (int i = 0; i < 2; ++i) {
            mbar_init(&h_full[i], 128);     // the state warpgroup's threads
            mbar_init(&h_empty[i], 128);    // the output warpgroup's threads
        }
        mbar_init(xdt_full, 128);
        mbar_init(xdt_empty, 128);
        mbar_fence_init();
    }
    __syncthreads();

    if (tid >= 256) {               // producer warp
        const float* dtb = p.dt + int64_t(bb) * p.S * p.H + hh;
        for (int ch = 0; ch < nchunks; ++ch) {
            const int s = ch % kStages, s0 = ch * L;
            unsigned char* st = smem + s * M::STAGE;
            if (ch >= kStages) mbar_wait(&empty[s], (ch / kStages - 1) & 1);
            if (lane == 0) {
                mbar_expect_tx(&full[s], L * p.P * 2 + 2 * M::BC);
                tma_load_4d(st, &tx, &full[s], 0, s0, hh, bb);
                tma_load_tile<N, L>(reinterpret_cast<bf16*>(st + M::X), &tb, &full[s], s0, bb, 0);
                tma_load_tile<N, L>(reinterpret_cast<bf16*>(st + M::X + M::BC), &tc, &full[s], s0,
                                    bb, 0);
            }
            // the chunk's row factors, rows lane and lane + 32: dt (0 past S),
            // cum = the in-chunk cumsum of dt A log2(e) (falling), dt 2^(cum_last
            // - cum), 2^cum; every exponent is <= 0
            float* rf = reinterpret_cast<float*>(st + M::X + 2 * M::BC);
            const float d0 = s0 + lane < p.S ? dtb[int64_t(s0 + lane) * p.H] : 0.f;
            const float d1 = s0 + lane + 32 < p.S ? dtb[int64_t(s0 + lane + 32) * p.H] : 0.f;
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
            rf[RF_DT + lane] = d0;
            rf[RF_DT + lane + 32] = d1;
            rf[RF_CUM + lane] = c0;
            rf[RF_CUM + lane + 32] = c1;
            rf[RF_DTW + lane] = d0 * exp2f(last - c0);
            rf[RF_DTW + lane + 32] = d1 * exp2f(last - c1);
            rf[RF_ECUM + lane] = exp2f(c0);
            rf[RF_ECUM + lane + 32] = exp2f(c1);
            mbar_arrive(&full[s]);
        }
        __syncwarp();
        return;
    }

    // two consumer warpgroups: 0 computes y, 1 carries the state and writes
    // the x dt operands of both.  In each, accumulator rows 16 warp + g
    // (+ 8), columns 8 j + 2 c (+ 1)
    const int wg = tid / 128, warp = (tid % 128) / 32, g = lane / 4, c = lane % 4;
    const uint32_t h_tiles = smem_u32(smem + M::h_off);     // buffer k: hi, lo
    const uint32_t xdt_hi = smem_u32(smem + M::work_off), xdt_lo = xdt_hi + M::W;
    const int64_t hbase = (int64_t(bb) * p.H + hh) * p.P * N;

    if (wg == 1) {
        // the state [P, N] in fp32 registers for the whole sequence, from h0
        // (zeros when none, and in the rows past P); buffer k of the bf16
        // hi/lo copy holds the state entering chunk k
        const uint32_t xw_hi = xdt_hi + 2 * M::W, xw_lo = xw_hi + M::W;
        // this warp writes 16 columns of rows lane and lane + 32 of the x dt
        // operands (zeros past P)
        const uint32_t off0 = swz_addr<PP, L>(0, lane, 16 * warp);
        const uint32_t off1 = swz_addr<PP, L>(0, lane, 16 * warp + 8);
        const uint32_t off2 = swz_addr<PP, L>(0, lane + 32, 16 * warp);
        const uint32_t off3 = swz_addr<PP, L>(0, lane + 32, 16 * warp + 8);
        float h[N / 2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = warp * 16 + g + 8 * hr;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
                float2 v = make_float2(0.f, 0.f);
                if (p.h0 && row < p.P)
                    v = *reinterpret_cast<const float2*>(p.h0 + hbase + int64_t(row) * N + 8 * j +
                                                         2 * c);
                h[4 * j + 2 * hr] = v.x;
                h[4 * j + 2 * hr + 1] = v.y;
            }
        }
        write_state<N>(h, h_tiles, h_tiles + M::H, warp, lane);
        fence_proxy_async();
        mbar_arrive(&h_full[0]);
        for (int ch = 0; ch < nchunks; ++ch) {
            const int s = ch % kStages;
            const unsigned char* st = smem + s * M::STAGE;
            const uint32_t x_addr = smem_u32(st), b_addr = x_addr + M::X;
            const float* rf = reinterpret_cast<const float*>(st + M::X + 2 * M::BC);
            mbar_wait(&full[s], (ch / kStages) & 1);
            if (ch > 0) mbar_wait(xdt_empty, (ch - 1) & 1);    // y of chunk ch - 1 read them
            // x dt and x dt 2^(cum_last - cum_j), as bf16 hi + lo
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = lane + 32 * half;
                uint4 xv[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
                if (16 * warp < p.P) {
                    xv[0] = lds_u4(x_addr + (r * p.P + 16 * warp) * 2);
                    xv[1] = lds_u4(x_addr + (r * p.P + 16 * warp + 8) * 2);
                }
                // x dt meets att hi and lo (three products: rounded); x dt w
                // meets B, which is exact
                write_split<true>(xv, rf[RF_DT + r], xdt_hi, xdt_lo, half ? off2 : off0,
                                  half ? off3 : off1);
                write_split<false>(xv, rf[RF_DTW + r], xw_hi, xw_lo, half ? off2 : off0,
                                   half ? off3 : off1);
            }
            fence_proxy_async();
            mbar_arrive(xdt_full);
            named_sync(2, 128);
            // h = 2^cum_last h + (x dt w)^T B, (x dt w) as hi + lo
            const float decay = rf[RF_ECUM + L - 1];
#pragma unroll
            for (int i = 0; i < N / 2; ++i) h[i] *= decay;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < L / 16; ++kk) {
                wgmma_ss<N, 1, 1>(h, desc_mn<PP, L>(xw_hi, kk), desc_mn<N, L>(b_addr, kk), 1);
                wgmma_ss<N, 1, 1>(h, desc_mn<PP, L>(xw_lo, kk), desc_mn<N, L>(b_addr, kk), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(h);
            named_sync(2, 128);             // every read of this chunk's operands is done
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
            // the state entering chunk ch + 1, once chunk ch - 1's y has read
            // the buffer
            const int k = ch + 1;
            if (k >= 2) mbar_wait(&h_empty[k & 1], (k / 2 - 1) & 1);
            write_state<N>(h, h_tiles + (k & 1) * 2 * M::H, h_tiles + (k & 1) * 2 * M::H + M::H,
                           warp, lane);
            fence_proxy_async();
            mbar_arrive(&h_full[k & 1]);
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = warp * 16 + g + 8 * hr;
            if (row >= p.P) continue;
#pragma unroll
            for (int j = 0; j < N / 8; ++j)
                *reinterpret_cast<float2*>(p.hfin + hbase + int64_t(row) * N + 8 * j + 2 * c) =
                    make_float2(h[4 * j + 2 * hr], h[4 * j + 2 * hr + 1]);
        }
        return;
    }

    // warpgroup 0: y = 2^cum_i C_i h^T + sum_{j <= i} att_ij x_j dt_j.  Each
    // chunk's G = C B^T is issued with the chunk before's att (x dt), so it
    // is there when the chunk starts; att is formed while C h^T runs.
    float* yb = p.y + (int64_t(bb) * p.S * p.H + hh) * p.P;
    float gm[L / 2];
    auto issue_g = [&](int ch) {            // chunk ch's stage is full
        const uint32_t b_addr = smem_u32(smem + (ch % kStages) * M::STAGE) + M::X;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss<L, 0, 0>(gm, desc_k<N, L>(b_addr + M::BC, 0, kk), desc_k<N, L>(b_addr, 0, kk),
                              kk > 0);
    };
#pragma unroll
    for (int i = 0; i < L / 2; ++i) gm[i] = 0.f;
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_g(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gm);
    for (int ch = 0; ch < nchunks; ++ch) {
        const int s = ch % kStages, s0 = ch * L;
        const unsigned char* st = smem + s * M::STAGE;
        const uint32_t c_addr = smem_u32(st) + M::X + M::BC;
        const float* rf = reinterpret_cast<const float*>(st + M::X + 2 * M::BC);

        // Y = C h^T (h as hi + lo), once the state is there
        float y[PP / 2];
#pragma unroll
        for (int i = 0; i < PP / 2; ++i) y[i] = 0.f;
        mbar_wait(&h_full[ch & 1], (ch / 2) & 1);
        const uint32_t h_hi = h_tiles + (ch & 1) * 2 * M::H, h_lo = h_hi + M::H;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss<PP, 0, 0>(y, desc_k<N, L>(c_addr, 0, kk), desc_k<N, PP>(h_hi, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss<PP, 0, 0>(y, desc_k<N, L>(c_addr, 0, kk), desc_k<N, PP>(h_lo, 0, kk), 1);
        wgmma_commit();

        // meanwhile att = 2^(cum_i - cum_j) G on and below the diagonal, 0
        // above, as bf16 hi + lo A registers
        uint32_t ahi[L / 16][4], alo[L / 16][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int i = warp * 16 + g + 8 * hr;
            const float ci = rf[RF_CUM + i];
#pragma unroll
            for (int jj = 0; jj < L / 8; ++jj) {
                float a[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = 8 * jj + 2 * c + e;
                    // above the diagonal the exponent is -inf (selected, never
                    // formed), so the entry is 0 times a finite G
                    a[e] = exp2_approx(j <= i ? ci - rf[RF_CUM + j] : -INFINITY) *
                           gm[4 * jj + 2 * hr + e];
                }
                split_bf16x2<true>(a[0], a[1], ahi[jj / 2][(jj % 2) * 2 + hr],
                                   alo[jj / 2][(jj % 2) * 2 + hr]);
            }
        }
        wgmma_wait<0>();
        fence_regs(y);
        mbar_arrive(&h_empty[ch & 1]);
        // Y's rows times 2^cum_i
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const float ec = rf[RF_ECUM + warp * 16 + g + 8 * hr];
#pragma unroll
            for (int jj = 0; jj < PP / 8; ++jj) {
                y[4 * jj + 2 * hr] *= ec;
                y[4 * jj + 2 * hr + 1] *= ec;
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);      // done with C, B and the row factors

        // Y += att (x dt): hi hi + hi lo + lo hi; and the next chunk's G
        mbar_wait(xdt_full, ch & 1);
#pragma unroll
        for (int i = 0; i < L / 2; ++i) gm[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
            wgmma_rs<PP>(y, ahi[kk], desc_mn<PP, L>(xdt_hi, kk), 1);
            wgmma_rs<PP>(y, ahi[kk], desc_mn<PP, L>(xdt_lo, kk), 1);
            wgmma_rs<PP>(y, alo[kk], desc_mn<PP, L>(xdt_hi, kk), 1);
        }
        if (ch + 1 < nchunks) {
            mbar_wait(&full[(ch + 1) % kStages], ((ch + 1) / kStages) & 1);
            issue_g(ch + 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(y);
        fence_regs(gm);
        fence_regs(ahi);
        fence_regs(alo);
        mbar_arrive(xdt_empty);

#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int i = warp * 16 + g + 8 * hr;
            if (s0 + i >= p.S) continue;
            float* yr = yb + int64_t(s0 + i) * p.H * p.P;
#pragma unroll
            for (int jj = 0; jj < PP / 8; ++jj)
                if (8 * jj < p.P)
                    *reinterpret_cast<float2*>(yr + 8 * jj + 2 * c) =
                        make_float2(y[4 * jj + 2 * hr], y[4 * jj + 2 * hr + 1]);
        }
    }
}

template <int N>
int launch(const void* x, const void* B, const void* C, const Params& p, const int64_t* st,
           int batch, cudaStream_t stream) {
    // x [batch, S, H, P] as (P, S, H, batch), one chunk a box, unswizzled;
    // B and C [batch, S, N] as (N, S, batch, 1), in the swizzled slabs the
    // wgmma descriptors read
    CUtensorMap tx, tb, tc;
    const cuuint64_t xd[4] = {cuuint64_t(p.P), cuuint64_t(p.S), cuuint64_t(p.H),
                              cuuint64_t(batch)};
    const int64_t xs[3] = {st[1], st[2], st[0]};
    int rc = encode_tiled(&tx, x, xd, xs, p.P, L, CU_TENSOR_MAP_SWIZZLE_NONE);
    const cuuint64_t bd[4] = {cuuint64_t(N), cuuint64_t(p.S), cuuint64_t(batch), 1};
    const int64_t bs[3] = {st[4], st[3], st[3]};
    const int64_t cs[3] = {st[6], st[5], st[5]};
    if (!rc) rc = encode_tiled(&tb, B, bd, bs, Swz<N>::COLS, L, Swz<N>::TMA);
    if (!rc) rc = encode_tiled(&tc, C, bd, cs, Swz<N>::COLS, L, Swz<N>::TMA);
    if (rc) return rc;
    const int bytes = static_cast<int>(Smem<N>::bytes);
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_scan_kernel<N><<<dim3(p.H, batch), kThreads, bytes, stream>>>(tx, tb, tc, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [batch, S, H, P] bf16 and B, C [batch, S, N] bf16 with the given strides
// (in elements; last dims contiguous, pointers and strides 16-byte aligned);
// dt [batch, S, H] fp32, a_log [H] fp32, h0 [batch, H, P, N] fp32 or null,
// y [batch, S, H, P] fp32 and h_final [batch, H, P, N] fp32, all contiguous.
// strides: x0, x1, x2, b0, b1, c0, c1.  P one of 16, 32, 64; N one of 16,
// 32, 64, 128; S >= 1 (the wrapper checks all of it).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log, const void* B,
                            const void* C, const void* h0, void* y, void* h_final,
                            const int64_t* strides, int batch, int S, int H, int P, int N,
                            void* stream) {
    if ((P != 16 && P != 32 && P != 64) || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.dt = static_cast<const float*>(dt);
    p.a_log = static_cast<const float*>(a_log);
    p.h0 = static_cast<const float*>(h0);
    p.y = static_cast<float*>(y);
    p.hfin = static_cast<float*>(h_final);
    p.S = S;
    p.H = H;
    p.P = P;
    if (batch == 0 || H == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (N) {
        case 16: return launch<16>(x, B, C, p, strides, batch, s);
        case 32: return launch<32>(x, B, C, p, strides, batch, s);
        case 64: return launch<64>(x, B, C, p, strides, batch, s);
        case 128: return launch<128>(x, B, C, p, strides, batch, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Dynamic shared memory of one block at state dim N (0 for another N).
extern "C" int ssd_scan_smem_bytes(int N) {
    switch (N) {
        case 16: return static_cast<int>(Smem<16>::bytes);
        case 32: return static_cast<int>(Smem<32>::bytes);
        case 64: return static_cast<int>(Smem<64>::bytes);
        case 128: return static_cast<int>(Smem<128>::bytes);
        default: return 0;
    }
}
