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
// Bound on an H100: operations.  Per (token, head) the inter-chunk term
// C h^T and the state update each take 2 N P flops, and the in-chunk
// quadratic term L P (causal half of a 64-row chunk): ~29 GFLOP at the
// mamba2-130m prefill shape (4 x 8192 tokens, 24 heads, P 64, N 128), all
// with fp32 operands on the CUDA cores (0.43 ms at 67 TFLOP/s), against
// ~0.33 GB of device memory (0.10 ms at 3.35 TB/s).  C B^T has bf16 inputs
// and runs on the tensor cores.
//
// Design:
// * The TPU carries the [heads, P, N] state across an in-order grid axis.
//   Here one block (4 warps) owns a (batch, head, 16-column slice of P) and
//   loops over the chunks itself; its fp32 state slice [16, N] lives in
//   registers (each thread owns a few (p, n) entries) and, transposed, in
//   shared memory for the C h^T product.  A row p of the state evolves on
//   its own, so slicing P costs only the recomputation of C B^T and the
//   decays per slice, and gives B x H x P/16 blocks (384 at the prefill
//   shape, about three per SM).
// * The chunk is 64 rows (the model's 256 is the plain version's; the
//   function does not depend on it).  Per chunk: cp.async brings B and C
//   (bf16), zero-filled past S; warp 0 scans dt A into the in-chunk cumsum
//   with shuffles and forms exp(cum_i), exp(cum_last - cum_j) and the
//   chunk's decay exp(cum_last), every exponent <= 0; x dt and
//   x dt exp(cum_last - cum_j) go to shared memory in fp32.
// * C B^T: `mma.sync` m16n8k16 (bf16 in, fp32 accumulate, exact products),
//   each warp 16 rows, only the tiles on or below the diagonal.  Each entry
//   is then exp(cum_i - cum_j) C_i.B_j for j <= i, and 0 above the diagonal
//   by selection: the exponential is never formed for j > i, where it can
//   be inf in fp32 (cum falls by 10^2 to 10^3 inside a chunk), and no mask
//   multiplies it (inf * 0 is NaN).
// * y and the state update on the CUDA cores in fp32 from shared memory,
//   register-tiled (4 rows x 2 columns of y, up to 4 x 4 of the state a
//   thread).  Rows past S carry dt = 0, x = B = C = 0: they neither decay
//   the state nor add to it, and their y is not stored.
// * x, B and C are read with strides (last dim contiguous, 16-byte
//   aligned), so the model's slices of one conv output go in without a copy.
// No backward yet; wgmma and double-buffered loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using mma_sm90::bf16;

namespace {

using namespace mma_sm90;

constexpr int L = 64;                          // rows per chunk
constexpr int PB = 16;                         // columns of P per block
constexpr int kWarps = L / 16;                 // each warp owns 16 rows of C B^T
constexpr int kThreads = kWarps * 32;
constexpr int TI = L * PB / (2 * kThreads);    // rows of y per thread (4)
constexpr int YG = PB / 2;                     // column pairs of y (8)
constexpr int LDA = L + 4;                     // fp32 rows of att^T, padded

struct Strides {
    int64_t x0, x1, x2;                        // x [B, S, H, P]
    int64_t b0, b1;                            // B [B, S, N]
    int64_t c0, c1;                            // C [B, S, N]
};

template <int N>
struct Tile {
    static constexpr int E = PB * N / kThreads;    // state entries per thread
    static constexpr int SN = E < 4 ? E : 4;       // ... along n
    static constexpr int SP = E / SN;              // ... along p
    static constexpr int NG = N / SN;              // threads along n
    static constexpr int LDB = N + 8;              // bf16 rows of B, C padded by 16 B
    static_assert(SN >= 2 && SP * SN == E && NG * (PB / SP) == kThreads, "tile");
};

template <int N>
struct Smem {
    __align__(16) bf16 b[L][Tile<N>::LDB];
    __align__(16) bf16 c[L][Tile<N>::LDB];
    __align__(16) float att[L][LDA];           // att^T[j][i]
    __align__(16) float xdt[L][PB];            // x dt
    __align__(16) float xw[L][PB];             // x dt exp(cum_last - cum_j)
    __align__(16) float ht[N][PB];             // the state, transposed
    float dts[L], cum[L], ecum[L], wend[L];
    float decay;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 3)    // three blocks an SM (~69 KB each)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hfin, Strides st, int S,
                int H, int P) {
    using T = Tile<N>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int pofs = blockIdx.x * PB, hh = blockIdx.y, bb = blockIdx.z;
    const float A = -expf(a_log[hh]);

    // the state entries this thread owns: p0s + a, n0 + c
    const int n0 = (tid % T::NG) * T::SN, p0s = (tid / T::NG) * T::SP;
    const int64_t hbase = ((int64_t(bb) * H + hh) * P + pofs) * N;
    float hreg[T::SP][T::SN];
#pragma unroll
    for (int a = 0; a < T::SP; ++a)
#pragma unroll
        for (int c = 0; c < T::SN; ++c) {
            hreg[a][c] = h0 ? h0[hbase + int64_t(p0s + a) * N + n0 + c] : 0.f;
            sm.ht[n0 + c][p0s + a] = hreg[a][c];
        }

    // the y entries: rows yi..yi+TI-1, columns yp, yp+1
    const int yp = (tid % YG) * 2, yi = (tid / YG) * TI;
    const bf16* xb = x + bb * st.x0 + hh * st.x2 + pofs;
    const bf16* Bb = Bm + bb * st.b0;
    const bf16* Cb = Cm + bb * st.c0;
    const float* dtb = dt + int64_t(bb) * S * H + hh;
    float* yb = y + (int64_t(bb) * S * H + hh) * P + pofs;
    const int xr = tid / 2, xc = (tid % 2) * 8;      // this thread's 8 x values

    const int nchunks = (S + L - 1) / L;
    for (int ch = 0; ch < nchunks; ++ch) {
        const int s0 = ch * L;
        constexpr int VPR = N / 8;                    // 16-byte vectors per row
        for (int v = tid; v < L * VPR; v += kThreads) {
            const int r = v / VPR, col = (v % VPR) * 8;
            const bool ok = s0 + r < S;
            const int64_t row = ok ? s0 + r : 0;
            cp_async16(&sm.b[r][col], Bb + row * st.b1 + col, ok);
            cp_async16(&sm.c[r][col], Cb + row * st.c1 + col, ok);
        }
        cp_async_commit();
        uint4 xv = make_uint4(0u, 0u, 0u, 0u);
        if (s0 + xr < S)
            xv = *reinterpret_cast<const uint4*>(xb + int64_t(s0 + xr) * st.x1 + xc);

        if (warp == 0) {                              // rows lane and lane + 32
            const float d0 = s0 + lane < S ? dtb[int64_t(s0 + lane) * H] : 0.f;
            const float d1 = s0 + lane + 32 < S ? dtb[int64_t(s0 + lane + 32) * H] : 0.f;
            float c0 = d0 * A, c1 = d1 * A;
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
            sm.dts[lane] = d0;
            sm.dts[lane + 32] = d1;
            sm.cum[lane] = c0;
            sm.cum[lane + 32] = c1;
            sm.ecum[lane] = expf(c0);
            sm.ecum[lane + 32] = expf(c1);
            sm.wend[lane] = expf(last - c0);
            sm.wend[lane + 32] = expf(last - c1);
            if (lane == 0) sm.decay = expf(last);
        }
        cp_async_wait<0>();
        __syncthreads();

        {   // x dt and x dt exp(cum_last - cum_j)
            const float d = sm.dts[xr], w = sm.wend[xr];
            const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(hv[j]);
                const float a0 = f.x * d, a1 = f.y * d;
                sm.xdt[xr][xc + 2 * j] = a0;
                sm.xdt[xr][xc + 2 * j + 1] = a1;
                sm.xw[xr][xc + 2 * j] = a0 * w;
                sm.xw[xr][xc + 2 * j + 1] = a1 * w;
            }
        }
        {   // att^T[j][i] = exp(cum_i - cum_j) C_i.B_j for j <= i, else 0
            const int r0 = warp * 16;
            float acc[8][4];
#pragma unroll
            for (int t = 0; t < 8; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
            for (int k0 = 0; k0 < N; k0 += 16) {
                uint32_t af[4];
                ldmatrix_x4(af, frag_a(&sm.c[0][0], T::LDB, r0, k0, lane));
#pragma unroll
                for (int np = 0; np < kWarps; ++np) {
                    if (np <= warp) {
                        uint32_t bf[4];
                        ldmatrix_x4(bf, frag_bt(&sm.b[0][0], T::LDB, np * 16, k0, lane));
                        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
                        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
                    }
                }
            }
#pragma unroll
            for (int np = 0; np < kWarps; ++np) {
                if (np > warp) continue;
#pragma unroll
                for (int half = 0; half < 2; ++half)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int row = r0 + lane / 4 + (e >= 2 ? 8 : 0);
                        const int col = np * 16 + half * 8 + 2 * (lane % 4) + (e & 1);
                        sm.att[col][row] = col <= row
                            ? expf(sm.cum[row] - sm.cum[col]) * acc[2 * np + half][e]
                            : 0.f;
                    }
            }
        }
        __syncthreads();

        {   // y_i = exp(cum_i) C_i.h + sum_{j <= i} att[i][j] x_j dt_j
            float acc[TI][2];
#pragma unroll
            for (int r = 0; r < TI; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
            for (int n = 0; n < N; n += 2) {
                const float2 h0v = *reinterpret_cast<const float2*>(&sm.ht[n][yp]);
                const float2 h1v = *reinterpret_cast<const float2*>(&sm.ht[n + 1][yp]);
#pragma unroll
                for (int r = 0; r < TI; ++r) {
                    const float2 cv = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&sm.c[yi + r][n]));
                    acc[r][0] += cv.x * h0v.x + cv.y * h1v.x;
                    acc[r][1] += cv.x * h0v.y + cv.y * h1v.y;
                }
            }
#pragma unroll
            for (int r = 0; r < TI; ++r) {
                const float e = sm.ecum[yi + r];
                acc[r][0] *= e;
                acc[r][1] *= e;
            }
            for (int j = 0; j < yi + TI; ++j) {
                const float4 av = *reinterpret_cast<const float4*>(&sm.att[j][yi]);
                const float2 xv2 = *reinterpret_cast<const float2*>(&sm.xdt[j][yp]);
                const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
                for (int r = 0; r < TI; ++r) {
                    acc[r][0] += a4[r] * xv2.x;
                    acc[r][1] += a4[r] * xv2.y;
                }
            }
#pragma unroll
            for (int r = 0; r < TI; ++r)
                if (s0 + yi + r < S)
                    *reinterpret_cast<float2*>(yb + int64_t(s0 + yi + r) * H * P + yp) =
                        make_float2(acc[r][0], acc[r][1]);
        }
        {   // h <- exp(cum_last) h + sum_j exp(cum_last - cum_j) (x_j dt_j) B_j^T
            const float dec = sm.decay;
#pragma unroll
            for (int a = 0; a < T::SP; ++a)
#pragma unroll
                for (int c = 0; c < T::SN; ++c) hreg[a][c] *= dec;
#pragma unroll 4
            for (int j = 0; j < L; ++j) {
                float xw[T::SP], bv[T::SN];
#pragma unroll
                for (int a = 0; a < T::SP; ++a) xw[a] = sm.xw[j][p0s + a];
#pragma unroll
                for (int c = 0; c < T::SN; c += 2) {
                    const float2 f = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&sm.b[j][n0 + c]));
                    bv[c] = f.x;
                    bv[c + 1] = f.y;
                }
#pragma unroll
                for (int a = 0; a < T::SP; ++a)
#pragma unroll
                    for (int c = 0; c < T::SN; ++c) hreg[a][c] += xw[a] * bv[c];
            }
        }
        __syncthreads();                              // every read of this chunk done
#pragma unroll
        for (int a = 0; a < T::SP; ++a)
#pragma unroll
            for (int c = 0; c < T::SN; ++c) sm.ht[n0 + c][p0s + a] = hreg[a][c];
    }

#pragma unroll
    for (int a = 0; a < T::SP; ++a)
#pragma unroll
        for (int c = 0; c < T::SN; ++c)
            hfin[hbase + int64_t(p0s + a) * N + n0 + c] = hreg[a][c];
}

template <int N>
cudaError_t launch(const bf16* x, const float* dt, const float* a_log, const bf16* B,
                   const bf16* C, const float* h0, float* y, float* hfin, const Strides& st,
                   int batch, int S, int H, int P, cudaStream_t stream) {
    const int bytes = static_cast<int>(sizeof(Smem<N>));
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid(P / PB, H, batch);
    ssd_scan_kernel<N><<<grid, kThreads, bytes, stream>>>(x, dt, a_log, B, C, h0, y, hfin,
                                                         st, S, H, P);
    return cudaGetLastError();
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
    if (P % PB || P > 64 || P < PB || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    const Strides st{strides[0], strides[1], strides[2], strides[3],
                     strides[4], strides[5], strides[6]};
    const bf16* xp = static_cast<const bf16*>(x);
    const float* dtp = static_cast<const float*>(dt);
    const float* ap = static_cast<const float*>(a_log);
    const bf16* bp = static_cast<const bf16*>(B);
    const bf16* cp = static_cast<const bf16*>(C);
    const float* hp = static_cast<const float*>(h0);
    float* yp = static_cast<float*>(y);
    float* fp = static_cast<float*>(h_final);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    switch (N) {
        case 16: e = launch<16>(xp, dtp, ap, bp, cp, hp, yp, fp, st, batch, S, H, P, s); break;
        case 32: e = launch<32>(xp, dtp, ap, bp, cp, hp, yp, fp, st, batch, S, H, P, s); break;
        case 64: e = launch<64>(xp, dtp, ap, bp, cp, hp, yp, fp, st, batch, S, H, P, s); break;
        case 128: e = launch<128>(xp, dtp, ap, bp, cp, hp, yp, fp, st, batch, S, H, P, s); break;
        default: e = cudaErrorInvalidValue;
    }
    return static_cast<int>(e);
}
