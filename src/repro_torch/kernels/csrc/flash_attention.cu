// Flash attention forward (causal or full, GQA) for bf16 q/k/v.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_fwd_kernel (the
// Pallas TPU kernel behind `flash_attention_fwd`).
//
// Bound on an H100: at the serve path's prefill shapes (S = 512, head dim
// 128) the bytes of q and out and the tensor-core operations are of the same
// size, about 10 us each; at longer S the operations (4*D per unmasked
// score) dominate.  At stablelm-3b's head dim 80 (MHA) the bytes bound it:
// q, k, v and out of a B8 x H32 x S512 train step are 84 MB, 25 us at 3.35
// TB/s, against 11 us of operations.  The kernel never writes the [S, T] scores or
// probabilities to device memory, so bytes stay at one read of q, k, v and
// one write of out and lse.  Only `wgmma` reaches the card's full
// tensor-core rate, so both products run on it.
//
// Design:
// * A work item is (64-row q tile, head, batch); the TPU grid's sequential
//   kv axis becomes a loop over 64-row kv tiles inside it, so the
//   online-softmax state (m, l, acc) never leaves the SM, and the loop
//   stops at the causal limit of the tile's last row.  The grid is
//   persistent: as many blocks as stay resident (two an SM), block i walking
//   items i, i + grid, ..., numbered so that the q tiles with the most kv
//   tiles come first (causal balance).
// * A block is one consumer warpgroup and one producer warp (160 threads).
//   The producer loads with TMA: each item's q tile into one of two
//   buffers, ahead of the consumer, and K and V tiles into a 2-stage ring,
//   each buffer and stage with a `full` mbarrier (TMA's byte count) and an
//   `empty` one (one arrival per consumer warp).  q is a [B, H, S, D] view
//   and k, v [B, Hkv, T, D] views of the cache: each is a 4-D tensor map
//   (D, rows, heads, batch) with its own strides, encoded on the host in the
//   entry point.  The maps' row extents are S and kv_len, so TMA zero-fills
//   rows past either; kv head = q head / rep.
// * Tiles land in shared memory in the 128-byte (64-byte at D = 32)
//   swizzled layout that the wgmma descriptors read (hopper_sm90.cuh); at
//   D = 80 a tile is a 64-column slab (128-byte swizzle) and a 16-column
//   tail slab (32-byte swizzle), two TMA boxes from two tensor maps into one
//   `full` barrier, so q, k, v and the cache are read as they are, with no
//   padded copy: the k-steps over D are 4 + 1, and O += P V is an m64n64 and
//   an m64n16 product into O's 32 + 8 registers a thread.  Q is
//   read once per item into A registers (ldmatrix on the swizzled tile) and
//   its buffer goes back to the producer at once.  S = Q K^T is wgmma
//   m64n64k16 with A from registers and K K-major in shared memory;
//   O += P V is m64nDk16 with P from registers (the accumulator layout of S
//   is the A-operand layout) and V MN-major.  S, P and O stay in registers;
//   a thread holds two rows of each, four lanes share a row and reduce with
//   shuffles.  P is rounded to bf16 for P V, as FlashAttention does; the
//   row sums use the rounded values.
// * The mask is explicit: col < kv_len, and for causal col <= q_offset + row.
//   Rows past S are computed on zeros and never stored, so S and kv_len need
//   not be multiples of the tile (the Pallas grid drops such tails).
// * O leaves the registers through a 4 x 4 transpose inside each quad of
//   lanes, as 16-byte stores that fill whole 32-byte sectors (D / 8 chunks
//   of a row, in pairs: 5 pairs at D = 80).
// * Occupancy: two blocks an SM (168 registers, ~97 KB of shared memory
//   each at D = 128; 158 and ~62 KB at D = 80, where a third block would
//   need <= 112 registers), so one block's loads and stores overlap the
//   other's products.  A 128-row tile of two warpgroups (one block an SM), a 3- or
//   4-stage ring, 128-row kv tiles, Q read by wgmma from shared memory, a
//   TMA or shared-memory-staged store of O and an S/PV software pipeline
//   inside the warpgroup were each measured no faster at the serve and
//   train shapes (PERF.md).  lse is returned in fp32 for the backward pass.
// * q/k head dim D and v head dim DV may differ: MLA's expanded branch
//   attends over [nope | rope] keys at D = 192 (three 64-column slabs, each
//   the 128-byte swizzled slab D = 128 uses twice) against v at DV = 128.
//   Q and K tiles take D's geometry, V and O DV's; S = Q K^T runs 12
//   k-steps and O += P V is m64n128.  A thread then holds Q's A registers
//   (48), O (64), S (32) and P (16): over what two blocks an SM leave it
//   (168 registers; it spilled there), so that instance runs one block an
//   SM (`kFwdBlocks`), with up to 255 registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_sm90.cuh"

namespace {

using namespace hopper_sm90;
using mma_sm90::pack_bf16;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;              // q rows per tile: one consumer warpgroup
constexpr int BN = 64;              // kv rows per tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kThreads = 128 + 32;  // the consumer warpgroup + the producer warp
constexpr float kLn2 = 0.6931471805599453f;

// Blocks an SM: two where a thread's live registers (Q's A registers D/4,
// O DV/2, S BN/2, P BN/4) stay within the 168 that two blocks leave it (D
// 128: 144, no spill), else one
template <int D, int DV>
constexpr int kFwdBlocks = D / 4 + DV / 2 + BN / 2 + BN / 4 <= 144 ? 2 : 1;

template <int D, int DV>
struct Smem {
    static constexpr int Q = BM * D * 2;        // bytes of one q tile
    static constexpr int K = BN * D * 2;        // bytes of one K tile
    static constexpr int V = BN * DV * 2;       // bytes of one V tile
    static constexpr int k_off = 2 * Q;         // after the two q buffers
    static constexpr int v_off = k_off + kStages * K;
    static constexpr int bar_off = v_off + kStages * V;
    static constexpr size_t bytes = bar_off + (4 + 2 * kStages) * 8 + 1024;   // + alignment
};

struct Params {
    bf16* o;
    float* lse;                 // [B, H, S] contiguous
    int B, H, rep, S, kv_len, q_offset, causal, n_qt;
    float scale_log2;           // softmax scale * log2(e)
    int64_t o_sb, o_sh, o_ss;
};

// Work item w (in [0, B H n_qt)): the q tiles with the most kv tiles first.
struct Item {
    int b, h, q0, n_tiles;
};

__device__ __forceinline__ Item item_of(const Params& p, int w) {
    Item it;
    const int bh = p.B * p.H;
    it.q0 = (p.n_qt - 1 - w / bh) * BM;
    it.h = (w % bh) % p.H;
    it.b = (w % bh) / p.H;
    int kv_end = p.kv_len;
    if (p.causal) kv_end = min(kv_end, p.q_offset + min(it.q0 + BM, p.S));
    it.n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;
    return it;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, kFwdBlocks<D, DV>)
    flash_fwd_kernel(const __grid_constant__ TileMap<D> tq,
                     const __grid_constant__ TileMap<D> tk,
                     const __grid_constant__ TileMap<DV> tv, const Params p) {
    using L = Smem<D, DV>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* q_sh = reinterpret_cast<bf16*>(smem);                   // [2][BM x D]
    bf16* k_sh = reinterpret_cast<bf16*>(smem + L::k_off);        // [kStages][BN x D]
    bf16* v_sh = reinterpret_cast<bf16*>(smem + L::v_off);        // [kStages][BN x DV]
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);   // [2]
    uint64_t* q_empty = q_full + 2;                                       // [2]
    uint64_t* full = q_empty + 2;                                         // [kStages]
    uint64_t* empty = full + kStages;                                           // [kStages]

    const int n_work = p.B * p.H * p.n_qt;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(&q_full[i], 1);
            mbar_init(&q_empty[i], 4);      // one arrival per consumer warp
        }
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (tid >= 128) {               // producer warp: one thread issues every load
        if (tid == 128) {
            int n = 0;              // K/V tiles loaded so far, over all items
            for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
                const Item it = item_of(p, w);
                const int hk = it.h / p.rep, qb = j & 1;
                if (j >= 2) mbar_wait(&q_empty[qb], ((j >> 1) - 1) & 1);
                mbar_expect_tx(&q_full[qb], L::Q);
                tma_load_tile<D, BM>(q_sh + qb * BM * D, &tq, &q_full[qb], it.q0, it.h, it.b);
                for (int t = 0; t < it.n_tiles; ++t, ++n) {
                    const int s = n % kStages;
                    if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
                    mbar_expect_tx(&full[s], L::K + L::V);
                    tma_load_tile<D, BN>(k_sh + s * BN * D, &tk, &full[s], t * BN, hk, it.b);
                    tma_load_tile<DV, BN>(v_sh + s * BN * DV, &tv, &full[s], t * BN, hk, it.b);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: q rows [q0, q0 + 64) of each item
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const uint32_t q_addr = smem_u32(q_sh), k_addr = smem_u32(k_sh), v_addr = smem_u32(v_sh);
    int n = 0;                      // K/V tiles consumed so far, over all items
    for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
        const Item it = item_of(p, w);
        const int qb = j & 1;
        // this warp's 16 rows of Q, as A registers for every kv tile; the
        // buffer goes back to the producer for the item after next
        mbar_wait(&q_full[qb], (j >> 1) & 1);
        uint32_t qf[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            ldsm_x4(qf[kk], swz_addr<D, BM>(q_addr + qb * L::Q, warp * 16 + lane % 16,
                                            kk * 16 + (lane / 16) * 8));
        __syncwarp();
        if (lane == 0) mbar_arrive(&q_empty[qb]);

        int lim[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = it.q0 + warp * 16 + g + 8 * hr;
            lim[hr] = p.causal ? min(p.kv_len, p.q_offset + row + 1) : p.kv_len;
        }
        float o[DV / 2];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
        float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};

        for (int t = 0; t < it.n_tiles; ++t, ++n) {
            const int s = n % kStages;
            mbar_wait(&full[s], (n / kStages) & 1);
            const uint32_t kb = k_addr + s * L::K, vb = v_addr + s * L::V;

            // S = Q K^T: 64 rows x BN columns; register 4 j + 2 hr + e holds
            // row g + 8 hr of this warp's 16, column 8 j + 2 c + e
            float sc[BN / 2];
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_rs<BN, 0>(sc, qf[kk], desc_k<D, BN>(kb, 0, kk), kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            fence_regs(qf);

            // mask, scale (base 2) and the online softmax for rows g and g+8
            const int n0 = t * BN;
            uint32_t pf[BN / 16][4];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                float mx = -INFINITY;
#pragma unroll
                for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = n0 + jj * 8 + 2 * c + e;
                        float& sv = sc[4 * jj + 2 * hr + e];
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
                for (int jj = 0; jj < BN / 8; ++jj) {
                    float r0, r1;
                    const uint32_t packed =
                        pack_bf16(exp2f(sc[4 * jj + 2 * hr] - m_use),
                                  exp2f(sc[4 * jj + 2 * hr + 1] - m_use), r0, r1);
                    rsum += r0 + r1;
                    // A registers of k-step jj/2: {0,1} from even column tiles, {2,3} odd
                    pf[jj / 2][(jj % 2) * 2 + hr] = packed;
                }
                rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
                rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
                l_i[hr] = l_i[hr] * alpha + rsum;
                m_i[hr] = m_new;
#pragma unroll
                for (int dt = 0; dt < DV / 8; ++dt) {
                    o[4 * dt + 2 * hr] *= alpha;
                    o[4 * dt + 2 * hr + 1] *= alpha;
                }
            }

            // O += P V
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tile<DV, BN>(o, pf[kk], vb, kk);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pf);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with the stage
        }

        // O / l in bf16.  For each pair of 16-byte column chunks (dt0, dt0 + 1)
        // the quad's 4 x 4 transpose of its pairs gives lane c the whole chunk
        // dt0 + c / 2 of row g + 8 (c % 2), stored in one 16-byte write: two
        // full 32-byte sectors of a row an instruction.  Rows past S are not
        // stored.
        float inv[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = it.q0 + warp * 16 + g + 8 * hr;
            inv[hr] = l_i[hr] > 0.f ? 1.f / l_i[hr] : 0.f;
            if (c == 0 && row < p.S)
                p.lse[(int64_t(it.b) * p.H + it.h) * p.S + row] =
                    l_i[hr] > 0.f ? (m_i[hr] + log2f(l_i[hr])) * kLn2 : -INFINITY;
        }
        const int odd = c & 1, hi = c & 2;
        const int row = it.q0 + warp * 16 + g + 8 * odd;
        bf16* orow = p.o + it.b * p.o_sb + it.h * p.o_sh + row * p.o_ss;
#pragma unroll
        for (int dt0 = 0; dt0 < DV / 8; dt0 += 2) {
            uint32_t x[4];              // x[e]: row g + 8 (e % 2), chunk dt0 + e / 2
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hr = e & 1, dt = dt0 + e / 2;
                x[e] = pack_bf16(o[4 * dt + 2 * hr] * inv[hr], o[4 * dt + 2 * hr + 1] * inv[hr]);
            }
            uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? x[0] : x[1], 1);
            if (odd) x[0] = r; else x[1] = r;
            r = __shfl_xor_sync(0xffffffffu, odd ? x[2] : x[3], 1);
            if (odd) x[2] = r; else x[3] = r;
            r = __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[2], 2);
            if (hi) x[0] = r; else x[2] = r;
            r = __shfl_xor_sync(0xffffffffu, hi ? x[1] : x[3], 2);
            if (hi) x[1] = r; else x[3] = r;
            if (row < p.S)
                *reinterpret_cast<uint4*>(orow + (dt0 + c / 2) * 8) =
                    make_uint4(x[0], x[1], x[2], x[3]);
        }
    }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const Params& p, int Hkv,
           const int64_t* st, cudaStream_t stream) {
    TileMap<D> tq, tk;
    TileMap<DV> tv;
    int rc = encode_map<D>(&tq, q, p.B, p.H, p.S, st[0], st[1], st[2], BM);
    if (!rc) rc = encode_map<D>(&tk, k, p.B, Hkv, p.kv_len, st[3], st[4], st[5], BN);
    if (!rc) rc = encode_map<DV>(&tv, v, p.B, Hkv, p.kv_len, st[6], st[7], st[8], BN);
    if (rc) return rc;
    const int bytes = static_cast<int>(Smem<D, DV>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    // a persistent grid: as many blocks as stay resident, each walking the
    // work items blockIdx.x, blockIdx.x + gridDim.x, ...
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(e);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_kernel<D, DV>,
                                                           kThreads, bytes)) != cudaSuccess)
        return static_cast<int>(e);
    const int n_work = p.B * p.H * p.n_qt;
    const int grid = max(1, min(n_work, sms * max(per_sm, 1)));
    flash_fwd_kernel<D, DV><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k [B,H,S,D] / [B,Hkv,T,D], v [B,Hkv,T,DV], out [B,H,S,DV] as strided
// bf16 views whose last dim is contiguous; lse [B,H,S] contiguous fp32.
// strides holds the (batch, head, row) element strides of q, k, v, out in
// that order.  The wrapper checks shapes, 16-byte alignment (which TMA needs
// of the data pointers and strides) and (D, DV): (32, 32), (64, 64),
// (80, 80), (128, 128) or (192, 128).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* out, void* lse, int B, int H, int Hkv,
                                        int S, int D, int DV, int kv_len, int q_offset,
                                        int causal, float scale, const int64_t* strides,
                                        void* stream) {
    Params p;
    p.o = static_cast<bf16*>(out);
    p.lse = static_cast<float*>(lse);
    p.B = B;
    p.H = H;
    p.rep = H / Hkv;
    p.S = S;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.causal = causal;
    p.n_qt = (S + BM - 1) / BM;
    p.scale_log2 = scale * 1.4426950408889634f;
    p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
    if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D != DV && !(D == 192 && DV == 128)) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
        case 32: return launch<32, 32>(q, k, v, p, Hkv, strides, st);
        case 64: return launch<64, 64>(q, k, v, p, Hkv, strides, st);
        case 80: return launch<80, 80>(q, k, v, p, Hkv, strides, st);
        case 128: return launch<128, 128>(q, k, v, p, Hkv, strides, st);
        case 192: return launch<192, 128>(q, k, v, p, Hkv, strides, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Dynamic shared memory of one forward block at head dims (D, DV) (0 for
// another pair).
extern "C" int flash_attention_fwd_smem_bytes(int D, int DV) {
    if (D != DV && !(D == 192 && DV == 128)) return 0;
    switch (D) {
        case 32: return static_cast<int>(Smem<32, 32>::bytes);
        case 64: return static_cast<int>(Smem<64, 64>::bytes);
        case 80: return static_cast<int>(Smem<80, 80>::bytes);
        case 128: return static_cast<int>(Smem<128, 128>::bytes);
        case 192: return static_cast<int>(Smem<192, 128>::bytes);
        default: return 0;
    }
}
