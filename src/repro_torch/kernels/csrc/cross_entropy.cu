// Fused masked cross-entropy over bf16 logits: forward (per-row masked NLL
// and lse) and backward (dlogits).
//
// Replaces: src/repro/kernels/cross_entropy/kernel.py::_ce_kernel (the
// Pallas TPU kernel behind `fused_ce`).  JAX has no backward kernel; the
// port writes one so that the gradient never leaves the kernels on a card.
//
// Bound on an H100: device-memory bytes.  The forward reads the [R, V]
// logits once (2 bytes an element) for ~4 operations an element; the
// backward reads them and writes dlogits of the same size.  At the train
// step's chunk ([512, 65024] bf16, 66.6 MB) that is ~20 us forward and
// ~40 us backward at 3.35 TB/s.
//
// Design:
// * The TPU kernel tiles the vocab over a sequential grid axis and carries
//   (max, sum-exp, label logit) in VMEM across it.  Here one block streams
//   a whole row: each thread keeps its own online (max, sum-exp) over
//   16-byte loads (8 logits) spread across the row, and the block merges the
//   threads' pairs with shuffles and shared memory.  The label logit is one
//   load.  So the logits are read once, in bf16, straight from the head
//   matmul, and the vocab needs no multiple of a tile: 65024 and 50304 are
//   not multiples of the Pallas kernel's 2048 (kernel.py:59-62).
// * Outputs per row: nll * mask and lse, both fp32; the wrapper sums the
//   rows.  lse is saved for the backward, which is one elementwise pass:
//   dlogits[r, j] = g[r] mask[r] (exp(logit - lse[r]) - [j == label[r]]),
//   rounded to bf16 once.
// * exp is taken as exp2 of logits scaled by log2(e), on fp32 values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// merge (m, s) with (m2, s2): s counts exp2(x - m) over its elements
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
    const float mx = fmaxf(m, m2);
    if (mx == -INFINITY) return;               // both empty
    s = s * exp2f(m - mx) + s2 * exp2f(m2 - mx);
    m = mx;
}

__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const __nv_bfloat16* __restrict__ logits, const int64_t* __restrict__ labels,
              const float* __restrict__ mask, float* __restrict__ nll,
              float* __restrict__ lse, int v) {
    const int row = blockIdx.x;
    const int nvec = v / 8;
    const __nv_bfloat16* lrow = logits + static_cast<int64_t>(row) * v;
    const uint4* vr = reinterpret_cast<const uint4*>(lrow);

    float m = -INFINITY, s = 0.f;              // base-2 online max and sum
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
        uint4 u = vr[i];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        float t[8];
        float mx = m;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            t[2 * j] = f.x * kLog2e;
            t[2 * j + 1] = f.y * kLog2e;
            mx = fmaxf(mx, fmaxf(t[2 * j], t[2 * j + 1]));
        }
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) add += exp2f(t[j] - mx);
        s = (m == -INFINITY ? 0.f : s * exp2f(m - mx)) + add;
        m = mx;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        merge(m, s, m2, s2);
    }
    __shared__ float wm[kThreads / 32], ws[kThreads / 32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        wm[warp] = m;
        ws[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
        m = lane < kThreads / 32 ? wm[lane] : -INFINITY;
        s = lane < kThreads / 32 ? ws[lane] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
            const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
            merge(m, s, m2, s2);
        }
        if (lane == 0) {
            const float l = (m + log2f(fmaxf(s, 1e-30f))) * kLn2;
            const float pick = __bfloat162float(lrow[labels[row]]);
            lse[row] = l;
            nll[row] = (l - pick) * mask[row];
        }
    }
}

__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const __nv_bfloat16* __restrict__ logits, const int64_t* __restrict__ labels,
              const float* __restrict__ mask, const float* __restrict__ lse,
              const float* __restrict__ g, __nv_bfloat16* __restrict__ dlogits, int v) {
    const int row = blockIdx.x;
    const int nvec = v / 8;
    const int64_t off = static_cast<int64_t>(row) * v;
    const uint4* vr = reinterpret_cast<const uint4*>(logits + off);
    uint4* dr = reinterpret_cast<uint4*>(dlogits + off);
    const float w = g[row] * mask[row];
    const float l2 = lse[row] * kLog2e;
    const int64_t lab = labels[row];
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
        uint4 u = vr[i];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        uint4 o;
        __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            const int col = 8 * i + 2 * j;
            const float a = exp2f(f.x * kLog2e - l2) - (col == lab ? 1.f : 0.f);
            const float b = exp2f(f.y * kLog2e - l2) - (col + 1 == lab ? 1.f : 0.f);
            y[j] = __floats2bfloat162_rn(w * a, w * b);
        }
        dr[i] = o;
    }
}

}  // namespace

// logits: [rows, v] contiguous bf16, v % 8 == 0, 16-byte aligned; labels
// [rows] int64 in [0, v); mask, nll, lse [rows] fp32 (the wrapper checks all
// but the label range, which it cannot read without a sync).
extern "C" int ce_fwd_bf16(const void* logits, const void* labels, const void* mask,
                           void* nll, void* lse, int rows, int v, void* stream) {
    if (rows > 0) {
        ce_fwd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(logits), static_cast<const int64_t*>(labels),
            static_cast<const float*>(mask), static_cast<float*>(nll),
            static_cast<float*>(lse), v);
    }
    return static_cast<int>(cudaGetLastError());
}

// As ce_fwd_bf16, plus lse and g [rows] fp32 in, dlogits [rows, v] bf16 out.
extern "C" int ce_bwd_bf16(const void* logits, const void* labels, const void* mask,
                           const void* lse, const void* g, void* dlogits, int rows, int v,
                           void* stream) {
    if (rows > 0) {
        ce_bwd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(logits), static_cast<const int64_t*>(labels),
            static_cast<const float*>(mask), static_cast<const float*>(lse),
            static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dlogits), v);
    }
    return static_cast<int>(cudaGetLastError());
}
