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
// reach device memory.  At stablelm-3b's head dim 80 (MHA, B8 x H32 x
// S512) the bytes bound the dk/dv pass: q, dO read and k, v read and dk, dv
// written, 127 MB, 38 us at 3.35 TB/s, against 22 us of operations.
//
// Design:
// * The TPU grid carries dq (or dk, dv) across a sequential grid axis in
//   VMEM.  Here each becomes a loop inside one block, so the accumulator
//   stays in registers.
// * dq pass: a persistent grid, one block an SM, each walking work items
//   heavy-first (the items with the most kv tiles first).  A block is two
//   consumer warpgroups and a producer warpgroup of which one warp loads
//   (384 threads; its registers go to the consumers with setmaxnreg, 40
//   against 232 a thread).  An item gives each consumer warpgroup a slot,
//   a 64-row q tile of one head: at rep >= 2 one tile of two query heads
//   of a GQA group; at rep 1 (MHA) two adjacent tiles of one head, rows
//   [q0, q0 + 128), so that neither warpgroup idles there.  The producer
//   TMA-loads both slots' Q and dO tiles into one of two item buffers,
//   ahead of the consumers, and the kv tiles up to the causal limit of the
//   item's last row into a 3-stage K ring and a 2-stage V ring that both
//   warpgroups read (K_t is read until dQ's product of tile t, V_t only by
//   dP's): the K/V is fetched once for two heads, or for 128 q rows.  At
//   rep 1 the warpgroup of the earlier rows waits on and releases the kv
//   tiles past its causal limit without computing them.  Its lanes copy
//   the item's lse, which TMA cannot take.  Each buffer and stage has a
//   `full` mbarrier (TMA's byte count) and an `empty` one (one arrival per
//   consumer warp).  A warpgroup computes delta = rowsum(out * dO) from the
//   dO tile in shared memory and one read of out (issued before the tile's
//   wait; lane c of a quad takes the row's 16-byte chunks c, c + 4, ...),
//   runs S = Q K^T and dP = dO V^T on wgmma m64n64k16 (both operands
//   K-major), P = 2^(S scale - lse) on the special-function unit (masked
//   entries by selecting the exponent -inf) and dS in registers, then
//   dQ += dS K on wgmma m64nDk16 with dS from registers in the accumulator
//   layout and K MN-major.  Tile t + 1's S and dP are issued with tile t's
//   dQ, so the tensor cores work while the next dS is formed.  dq leaves
//   through the forward's quad transpose as 16-byte stores.  No atomics:
//   the same inputs give the same bits.  Measured no faster (PERF.md):
//   288 threads without setmaxnreg (168 registers, spills), the two
//   warpgroups taking turns on the tensor cores, the next item's out read
//   one item ahead, delta computed by extra producer warps; at rep 1, one
//   tile an item with the second warpgroup idle (`tools/kernel_ab.py
//   --make-variant dq-head-pairs`).
// * dk/dv pass: a cluster of C blocks (C = 1, 2, 4 or 8, chosen by the
//   wrapper) per (64-row kv tile, kv head, batch).  Block `rank` of the
//   cluster owns query heads [rank rep / C, (rank + 1) rep / C) of the GQA
//   group (none when rep < C) and loops over them and, for each, over the
//   64-row q tiles from the diagonal down, summing fp32 dk/dv partials in
//   registers.  At the end each block puts its partials in shared memory,
//   and block r sums rows [64 r / C, 64 (r + 1) / C) over the cluster
//   through distributed shared memory in rank order 0, 1, ..., C - 1 and
//   stores them: no atomics and no fp32 scratch in device memory, and the
//   same inputs give the same bits.  The grid is (C, B x Hkv, kv tiles),
//   kv tile 0 (which every q tile sees) first.
// * Each dk/dv block is one consumer warpgroup (64 kv rows) and one
//   producer warp.  The producer loads the block's K and V once with TMA,
//   then Q and dO of each (head, q tile) item into a 3-stage ring tracked by
//   `full` and `empty` mbarriers; its 32 lanes also copy that item's lse
//   and delta, which TMA cannot take: their rows are S fp32 apart, and S * 4
//   bytes need not be a multiple of 16.  q and dO are [B, H, S, D] views
//   and k, v [B, Hkv, T, D] views; each is a 4-D tensor map (D, rows, heads,
//   batch) encoded on the host in the entry point, row extents S and kv_len
//   so that TMA zero-fills past them.
// * The four products run on wgmma with the tiles in TMA's swizzled layout
//   (hopper_sm90.cuh): S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//   operands K-major in shared memory), then dV += P^T dO and
//   dK += dS^T Q (m64nDk16, P^T and dS^T from registers in the accumulator
//   layout, dO and Q MN-major).  P^T = exp(S^T * scale - lse) and
//   dS^T = P^T (dP^T - delta) are computed in registers; lse and delta are
//   read per column from shared memory.
// * One dk/dv block an SM: at D = 128 it takes 255 registers (dk, dv 128
//   fp32 + S^T, dP^T 64) without spills.  At D = 80 (dk, dv 80) two blocks
//   an SM would cap it at 168 registers, and it spills; it is compiled for
//   one, as at D = 128.  At D = 80 its tiles are a 64-column slab and a
//   16-column tail slab with their own swizzles (hopper_sm90.cuh): the
//   k-steps of S^T and dP^T over D are 4 + 1, and dV += P^T dO and
//   dK += dS^T Q are each an m64n64 and an m64n16 product, so q, k, v and
//   dO are read as they are.  The dq pass takes D = 80 the same way: 4 + 1
//   k-steps for S and dP, and dQ += dS K as an m64n64 and an m64n16
//   product.
// * q/k head dim D and v head dim DV may differ: MLA's expanded branch
//   runs at D = 192 ([nope | rope], three 64-column slabs) and DV = 128.
//   Q, K, dQ and dK take D's tiles; V, dO, out and dV DV's.  S and S^T run
//   D / 16 k-steps, dP and dP^T DV / 16; dQ += dS K and dK += dS^T Q are
//   an m64n128 and an m64n64 product (wgmma_rs_tile).  The dq pass's two
//   item buffers, 3-stage K ring and 2-stage V ring need 264 KB there, so
//   it keeps one item buffer (`DqSmem::BUFS`): the next item's Q and dO load
//   once the consumers release this item's.  The dk/dv block would hold dk
//   (96 fp32 registers a thread), dv (64), S^T and dP^T (32 each) at once
//   and spill, so at <192, 128> (`kPTBf16`) P^T is rounded to its bf16 A
//   registers as soon as S^T is read, dV += P^T dO is issued with
//   dP^T = V dO^T, and dS^T = P^T (dP^T - delta) takes P^T from those bf16
//   registers: S^T and dP^T never live at once.  dS^T then carries P^T's
//   bf16 rounding (2^-9 relative) besides its own.  An item's products and its
//   exp/dS work run one after the other in the one warpgroup, which is what
//   holds the pass to a fraction of the bf16 rate; a 3-stage ring beat 2,
//   and issuing dV += P^T dO before dS^T is ready was slower (PERF.md).
// * The mask is explicit: q row i (absolute position q_offset + i, i < S)
//   sees kv column j when j < kv_len and, for causal, j <= q_offset + i.
//   Rows past S and columns past kv_len get zero gradients, so S and kv_len
//   need not be multiples of the tile (the Pallas grid drops such tails).
// * Inputs are strided views with a contiguous last dim, as in the forward.
//   The 1/sqrt(D) scale of dS is applied once, to dq and dk at the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_sm90.cuh"

using mma_sm90::bf16;

namespace {

using namespace mma_sm90;
using namespace hopper_sm90;

constexpr int BM = 64;              // rows of the block's own tile
constexpr int BN = 64;              // rows of each tile the loop walks over
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------
constexpr int kDqKStages = 3;                // K ring depth: K_t is read until dQ's product of t
constexpr int kDqVStages = 2;                // V ring depth: V_t only by dP's product of t
constexpr int kDqThreads = 3 * 128;          // two consumer warpgroups + a producer warpgroup
constexpr int kDqProducerRegs = 40;          // registers a thread after setmaxnreg:
constexpr int kDqConsumerRegs = 232;         // 128 x 40 + 256 x 232 <= 65536

struct DqParams {
    const bf16* o;
    const float* lse;           // [B, H, S] contiguous
    float* delta;               // [B, H, S] contiguous: written here, read by dk/dv
    bf16* dq;
    int B, H, Hkv, rep, S, kv_len, q_offset, causal, n_qt;
    float scale, scale_log2;
    int64_t o_sb, o_sh, o_ss, dq_sb, dq_sh, dq_ss;
};

template <int D, int DV>
struct DqSmem {
    static constexpr int TQ = BM * D * 2;                // one [64 x D] bf16 tile: q, K
    static constexpr int TO = BM * DV * 2;               // one [64 x DV] tile: dO, V
    static constexpr int ITEM = 2 * (TQ + TO);           // q and dO of an item's two slots
    static constexpr int REST = kDqKStages * TQ + kDqVStages * TO + 2 * 2 * BM * 4 +
                                (4 + 2 * kDqKStages + 2 * kDqVStages) * 8 + 1024;
    // two item buffers where they fit a block's 227 KB, else one
    static constexpr int BUFS = 2 * ITEM + REST <= 232448 ? 2 : 1;
    static constexpr int k_off = BUFS * ITEM;            // after the item buffers
    static constexpr int v_off = k_off + kDqKStages * TQ;
    static constexpr int rows_off = v_off + kDqVStages * TO;     // [2 items] lse [2][64]
    static constexpr int bar_off = rows_off + 2 * 2 * BM * 4;
    static constexpr size_t bytes =
        bar_off + (4 + 2 * kDqKStages + 2 * kDqVStages) * 8 + 1024;   // + alignment
};

// Work items.  At rep >= 2 an item is a 64-row q tile of two query heads of
// one GQA group (one when the group's size is odd and the pair is its
// last), warpgroup wg taking head 2 pair + wg.  At rep 1 (MHA) it is two
// adjacent 64-row q tiles of one head, rows [q0, q0 + 128), warpgroup wg
// taking rows q0 + 64 wg; the tiles pair from the last one down, so when
// n_qt is odd the last item holds tile 0 alone (in warpgroup 1).  Either
// way both warpgroups read one K/V ring.  The items with the most kv tiles
// come first; neighbouring items share a kv group.  The wrapper's
// `dq_items` mirrors this numbering, and the card tests
// (tests/test_torch_cuda.py::test_flash_bwd_kernels_match_plain) hold every
// head and tile of it against the plain version: rep 1 with n_qt odd, 3
// and 16, S not a multiple of 64, an offset into a longer cache.
__host__ __device__ __forceinline__ bool dq_tile_pairs(int rep) { return rep == 1; }

// items of a launch: (q tiles / tiles an item) x B x Hkv x (head slots / 2)
__host__ __device__ __forceinline__ int dq_work(int n_qt, int B, int Hkv, int rep) {
    return dq_tile_pairs(rep) ? (n_qt + 1) / 2 * B * Hkv : n_qt * B * Hkv * ((rep + 1) / 2);
}

struct DqItem {
    int b, hk, n_tiles;     // kv tiles up to the causal limit of the item's last row
    int h[2], q0[2];        // warpgroup wg's head (-1: none) and first q row
};

// kv tiles that q rows [q0, q0 + 64) see
__device__ __forceinline__ int dq_kv_tiles(const DqParams& p, int q0) {
    int kv_end = p.kv_len;
    if (p.causal) kv_end = min(kv_end, p.q_offset + min(q0 + BM, p.S));
    return kv_end > 0 ? (kv_end + BN - 1) / BN : 0;
}

__device__ __forceinline__ DqItem dq_item(const DqParams& p, int w) {
    const bool tiles2 = dq_tile_pairs(p.rep);
    const int n_pairs = tiles2 ? 1 : (p.rep + 1) / 2, per = p.B * p.Hkv * n_pairs;
    const int qt_last = p.n_qt - 1 - (tiles2 ? 2 : 1) * (w / per);
    const int r = w % per, pair = r % n_pairs;
    DqItem it;
    it.hk = (r / n_pairs) % p.Hkv;
    it.b = r / (n_pairs * p.Hkv);
#pragma unroll
    for (int wg = 0; wg < 2; ++wg) {
        const int hg = tiles2 ? 0 : 2 * pair + wg, qt = tiles2 ? qt_last - 1 + wg : qt_last;
        it.h[wg] = hg < p.rep && qt >= 0 ? it.hk * p.rep + hg : -1;
        it.q0[wg] = qt * BM;
    }
    it.n_tiles = dq_kv_tiles(p, qt_last * BM);
    return it;
}

template <int D, int DV>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ TileMap<D> tq,
                        const __grid_constant__ TileMap<DV> tdo,
                        const __grid_constant__ TileMap<D> tk,
                        const __grid_constant__ TileMap<DV> tv, const DqParams p) {
    using L = DqSmem<D, DV>;
    constexpr int NB = L::BUFS;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    float* rows_sh = reinterpret_cast<float*>(smem + L::rows_off);     // item buffer b: lse
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);   // [2]
    uint64_t* q_empty = q_full + 2;                                      // [2]
    uint64_t* k_full = q_empty + 2;                                      // [kDqKStages]
    uint64_t* k_empty = k_full + kDqKStages;                             // [kDqKStages]
    uint64_t* v_full = k_empty + kDqKStages;                             // [kDqVStages]
    uint64_t* v_empty = v_full + kDqVStages;                             // [kDqVStages]

    const int n_work = dq_work(p.n_qt, p.B, p.Hkv, p.rep);
    const int tid = threadIdx.x, lane = tid % 32;
    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(&q_full[i], 1 + 32);  // TMA's expect_tx and the 32 lse lanes
            mbar_init(&q_empty[i], 8);      // one arrival per consumer warp
        }
        for (int s = 0; s < kDqKStages; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&k_empty[s], 8);
        }
        for (int s = 0; s < kDqVStages; ++s) {
            mbar_init(&v_full[s], 1);
            mbar_init(&v_empty[s], 8);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (tid >= 256) {               // producer warpgroup: its first warp loads
        setmaxnreg_dec<kDqProducerRegs>();
        if (tid >= 256 + 32) return;
        for (int w = blockIdx.x, j = 0, n = 0; w < n_work; w += gridDim.x, ++j) {
            const DqItem it = dq_item(p, w);
            const int qb = j % NB;
            const int ns = (it.h[0] >= 0) + (it.h[1] >= 0);
            unsigned char* buf = smem + qb * L::ITEM;
            float* lse_sh = rows_sh + qb * 2 * BM;      // [2 slots][64]
            if (j >= NB) mbar_wait(&q_empty[qb], (j / NB - 1) & 1);
            // q and dO of both warpgroups' slots by TMA, their lse by the
            // lanes, then the item's K and V tiles
            if (lane == 0) {
                mbar_expect_tx(&q_full[qb], ns * (L::TQ + L::TO));
#pragma unroll
                for (int g = 0; g < 2; ++g) {
                    if (it.h[g] < 0) continue;
                    bf16* slot = reinterpret_cast<bf16*>(buf + g * (L::TQ + L::TO));
                    tma_load_tile<D, BM>(slot, &tq, &q_full[qb], it.q0[g], it.h[g], it.b);
                    tma_load_tile<DV, BM>(slot + BM * D, &tdo, &q_full[qb], it.q0[g], it.h[g],
                                          it.b);
                }
            }
            for (int i = lane; i < 2 * BM; i += 32) {
                const int g = i / BM, h = g ? it.h[1] : it.h[0];
                const int row = (g ? it.q0[1] : it.q0[0]) + i % BM;
                lse_sh[i] = h >= 0 && row < p.S
                    ? p.lse[(int64_t(it.b) * p.H + h) * p.S + row] * kLog2e : 0.f;
            }
            mbar_arrive(&q_full[qb]);
            for (int t = 0; t < it.n_tiles; ++t, ++n) {
                const int sk = n % kDqKStages, sv = n % kDqVStages;
                if (n >= kDqKStages) mbar_wait(&k_empty[sk], (n / kDqKStages - 1) & 1);
                if (lane == 0) {
                    mbar_expect_tx(&k_full[sk], L::TQ);
                    tma_load_tile<D, BN>(reinterpret_cast<bf16*>(smem + L::k_off + sk * L::TQ),
                                         &tk, &k_full[sk], t * BN, it.hk, it.b);
                }
                if (n >= kDqVStages) mbar_wait(&v_empty[sv], (n / kDqVStages - 1) & 1);
                if (lane == 0) {
                    mbar_expect_tx(&v_full[sv], L::TO);
                    tma_load_tile<DV, BN>(reinterpret_cast<bf16*>(smem + L::v_off + sv * L::TO),
                                          &tv, &v_full[sv], t * BN, it.hk, it.b);
                }
            }
        }
        __syncwarp();
        return;
    }

    // consumer warpgroup wg: its slot's head and q rows [q0, q0 + 64); this
    // thread's rows are g and g + 8 of its warp's 16
    setmaxnreg_inc<kDqConsumerRegs>();
    const int wg = tid / 128, warp = (tid % 128) / 32;
    const int g = lane / 4, c = lane % 4;
    // a row of out / dO in 16-byte chunks: lane c of the quad takes chunks c, c + 4, ...
    constexpr int NCH = DV / 8, QV = (NCH + 3) / 4;
    const uint32_t k_base = smem_u32(smem + L::k_off), v_base = smem_u32(smem + L::v_off);
    int n = 0;                          // K/V tiles consumed so far, over all items
    for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
        const DqItem it = dq_item(p, w);
        const int qb = j % NB, h = wg ? it.h[1] : it.h[0], q0 = wg ? it.q0[1] : it.q0[0];
        const bool active = h >= 0;     // an odd group's last pair has one head;
                                        // an odd n_qt's last tile pair one tile
        // the kv tiles of this slot's rows: a suffix of the item's tiles that
        // lies past the causal limit is waited on and released, not computed
        const int n_own = active ? dq_kv_tiles(p, q0) : 0;
        const uint32_t q_addr = smem_u32(smem + qb * L::ITEM + wg * (L::TQ + L::TO));
        const uint32_t do_addr = q_addr + L::TQ;
        const float* lse_sh = rows_sh + qb * 2 * BM + wg * BM;

        // delta = rowsum(out * dO) in fp32: out read now, ahead of the tile's
        // arrival; dO from the tile in shared memory
        int lim[2];
        uint4 ov[2][QV];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = q0 + warp * 16 + g + 8 * hr;
            const bool ok = active && row < p.S;
            lim[hr] = !ok ? 0 : p.causal ? min(p.kv_len, p.q_offset + row + 1) : p.kv_len;
            const bf16* orow = p.o + it.b * p.o_sb + max(h, 0) * p.o_sh + int64_t(row) * p.o_ss;
#pragma unroll
            for (int k = 0; k < QV; ++k)
                ov[hr][k] = ok && 4 * k + c < NCH
                    ? *reinterpret_cast<const uint4*>(orow + 8 * (4 * k + c))
                    : make_uint4(0u, 0u, 0u, 0u);
        }
        mbar_wait(&q_full[qb], (j / NB) & 1);
        float lse2[2], dlt[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int rr = warp * 16 + g + 8 * hr, row = q0 + rr;
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < QV; ++k) {
                if (4 * k + c >= NCH) continue;
                const uint4 du = lds_u4(swz_addr<DV, BM>(do_addr, rr, 8 * (4 * k + c)));
                const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov[hr][k]);
                const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 of = __bfloat1622float2(oh[e]), df = __bfloat1622float2(dh[e]);
                    acc += of.x * df.x + of.y * df.y;
                }
            }
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            dlt[hr] = acc;
            lse2[hr] = lse_sh[rr];
            if (c == 0 && active && row < p.S)
                p.delta[(int64_t(it.b) * p.H + h) * p.S + row] = acc;
        }

        // kv tile t: S, dP = Q K_t^T, dO V_t^T; P, dS in registers; dQ += dS K_t.
        // The products of tile t + 1 are issued with dQ's of tile t, so the
        // tensor cores work while the next dS is computed.  dsf stays live
        // across the loop's back edge: dQ's product of tile t reads it until
        // the wait at the top of iteration t + 1.
        float acc[D / 2], sc[BN / 2], dp[BN / 2];
        uint32_t dsf[BN / 16][4];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        auto wait_kv = [&](int t) {
            mbar_wait(&k_full[(n + t) % kDqKStages], ((n + t) / kDqKStages) & 1);
            mbar_wait(&v_full[(n + t) % kDqVStages], ((n + t) / kDqVStages) & 1);
        };
        auto issue_s_dp = [&](int t) {      // tile t's K and V are there
            const uint32_t k_addr = k_base + ((n + t) % kDqKStages) * L::TQ;
            const uint32_t v_addr = v_base + ((n + t) % kDqVStages) * L::TO;
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<BN, 0, 0>(sc, desc_k<D, BM>(q_addr, 0, kk), desc_k<D, BN>(k_addr, 0, kk),
                                kk > 0);
#pragma unroll
            for (int kk = 0; kk < DV / 16; ++kk)
                wgmma_ss<BN, 0, 0>(dp, desc_k<DV, BM>(do_addr, 0, kk),
                                   desc_k<DV, BN>(v_addr, 0, kk), kk > 0);
        };
        auto release = [&](uint64_t* bar) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bar);
        };
        if (it.n_tiles > 0) {
            wait_kv(0);
            if (n_own > 0) {
                issue_s_dp(0);
                wgmma_commit();
            }
        }
        for (int t = 0; t < it.n_tiles; ++t) {
            if (t <= n_own) {
                // S, dP of tile t (and dQ of tile t - 1) are done
                wgmma_wait<0>();
                fence_regs(sc);
                fence_regs(dp);
                fence_regs(acc);
                fence_regs(dsf);
            }
            release(&v_empty[(n + t) % kDqVStages]);
            if (t > 0) release(&k_empty[(n + t - 1) % kDqKStages]);
            if (t >= n_own) {           // past this slot's rows, or no slot
                if (t + 1 < it.n_tiles) wait_kv(t + 1);
                continue;
            }
            // P = exp(S * scale - lse) on unmasked entries (0 elsewhere),
            // dS = P (dP - delta), rounded to bf16 A registers; register
            // 4 j + 2 hr + e of S and dP holds row g + 8 hr, column 8 j + 2 c + e
            const int n0 = t * BN;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
                for (int jj = 0; jj < BN / 8; ++jj) {
                    float ds[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int r = 4 * jj + 2 * hr + e;
                        // masked entries: 2^-inf = 0, by selection of the exponent
                        const float pv = exp2_approx(n0 + jj * 8 + 2 * c + e < lim[hr]
                                                         ? sc[r] * p.scale_log2 - lse2[hr]
                                                         : -INFINITY);
                        ds[e] = pv * (dp[r] - dlt[hr]);
                    }
                    dsf[jj / 2][(jj % 2) * 2 + hr] = pack_bf16(ds[0], ds[1]);
                }
            }
            // dQ += dS K_t (K MN-major), then tile t + 1's S and dP
            wgmma_fence();
            const uint32_t k_addr = k_base + ((n + t) % kDqKStages) * L::TQ;
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tile<D, BN>(acc, dsf[kk], k_addr, kk);
            if (t + 1 < it.n_tiles) {
                wait_kv(t + 1);
                if (t + 1 < n_own) issue_s_dp(t + 1);
            }
            wgmma_commit();
            fence_regs(dsf);
        }
        if (it.n_tiles > 0) {
            if (n_own == it.n_tiles) {  // dQ of the last tile (else waited above)
                wgmma_wait<0>();
                fence_regs(acc);
                fence_regs(dsf);
            }
            release(&k_empty[(n + it.n_tiles - 1) % kDqKStages]);
        }
        n += it.n_tiles;
        release(&q_empty[qb]);              // done with the item's q and dO
        if (!active) continue;

        // dq * scale in bf16, through the quad's 4 x 4 transpose (as the
        // forward stores O): lane c stores 16-byte chunk dt0 + c / 2 of row
        // g + 8 (c % 2), two full 32-byte sectors of a row an instruction
        const int odd = c & 1, hi = c & 2;
        const int row = q0 + warp * 16 + g + 8 * odd;
        bf16* drow = p.dq + it.b * p.dq_sb + h * p.dq_sh + int64_t(row) * p.dq_ss;
#pragma unroll
        for (int dt0 = 0; dt0 < D / 8; dt0 += 2) {
            uint32_t x[4];              // x[e]: row g + 8 (e % 2), chunk dt0 + e / 2
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hr = e & 1, dt = dt0 + e / 2;
                x[e] = pack_bf16(acc[4 * dt + 2 * hr] * p.scale, acc[4 * dt + 2 * hr + 1] * p.scale);
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
                *reinterpret_cast<uint4*>(drow + (dt0 + c / 2) * 8) = make_uint4(x[0], x[1], x[2], x[3]);
        }
    }
}

// ---------------------------------------------------------------------------
// dk/dv pass
// ---------------------------------------------------------------------------
constexpr int kDkvStages = 3;           // Q/dO ring depth
constexpr int kDkvThreads = 128 + 32;   // one consumer warpgroup + the producer warp

struct DkvParams {
    const float* lse;           // [B, H, S] contiguous
    const float* delta;         // [B, H, S] contiguous
    bf16* dk;
    bf16* dv;
    int H, Hkv, rep, S, T, kv_len, q_offset, causal, cluster;
    float scale, scale_log2;
    int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

template <int D, int DV>
struct DkvSmem {
    static constexpr int TK = BM * D * 2;                // one [64 x D] bf16 tile: K, q
    static constexpr int TV = BM * DV * 2;               // one [64 x DV] tile: V, dO
    static constexpr int STAGE = TK + TV + 1024;         // q, dO, lse and delta (64 floats each)
    static constexpr int RLD = D + 4, RLDV = DV + 4;     // fp32 partial rows, padded
    static constexpr int RED = BM * (RLD + RLDV) * 4;    // dk and dv partials
    static constexpr int RING = kDkvStages * STAGE > RED ? kDkvStages * STAGE : RED;
    static constexpr int ring_off = TK + TV;             // after this block's K and V
    static constexpr int bar_off = ring_off + RING;
    static constexpr size_t bytes = bar_off + (1 + 2 * kDkvStages) * 8 + 1024;
};

// P^T kept as bf16 A registers (see the design note): where dk, dv, S^T and
// dP^T together would pass 192 fp32 registers a thread
template <int D, int DV>
constexpr bool kPTBf16 = D / 2 + DV / 2 + BN > 192;

template <int D, int DV>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ TileMap<D> tq,
                         const __grid_constant__ TileMap<DV> tdo,
                         const __grid_constant__ TileMap<D> tk,
                         const __grid_constant__ TileMap<DV> tv, const DkvParams p) {
    using L = DkvSmem<D, DV>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* k_sh = reinterpret_cast<bf16*>(smem);
    bf16* v_sh = reinterpret_cast<bf16*>(smem + L::TK);
    unsigned char* ring = smem + L::ring_off;      // stage s: q, dO, lse, delta
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + kDkvStages;

    const int C = p.cluster;
    const int rank = C > 1 ? static_cast<int>(cluster_rank()) : 0;
    const int hk = blockIdx.y % p.Hkv, b = blockIdx.y / p.Hkv;
    const int k0 = blockIdx.z * BM;
    // this block's query heads (the wrapper's `dkv_heads` is the same split)
    const int h_lo = hk * p.rep + rank * p.rep / C;
    const int h_hi = hk * p.rep + (rank + 1) * p.rep / C;
    // q tiles that can see row k0: causal needs q_offset + i >= k0
    const int n_q = (p.S + BN - 1) / BN;
    const int qt0 = p.causal ? min(n_q, max(0, k0 - p.q_offset) / BN) : 0;
    const int per_head = n_q - qt0;
    const int n_items = k0 < p.kv_len ? (h_hi - h_lo) * per_head : 0;
    const int tid = threadIdx.x, lane = tid % 32;

    if (tid == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < kDkvStages; ++s) {
            mbar_init(&full[s], 1 + 32);   // TMA's expect_tx and the 32 lse/delta lanes
            mbar_init(&empty[s], 4);       // one arrival per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    float dk[D / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

    if (tid >= 128) {               // producer warp
        if (n_items > 0) {
            if (lane == 0) {
                mbar_expect_tx(kv_full, L::TK + L::TV);
                tma_load_tile<D, BM>(k_sh, &tk, kv_full, k0, hk, b);
                tma_load_tile<DV, BM>(v_sh, &tv, kv_full, k0, hk, b);
            }
            for (int it = 0; it < n_items; ++it) {
                const int s = it % kDkvStages;
                if (it >= kDkvStages) mbar_wait(&empty[s], (it / kDkvStages - 1) & 1);
                const int h = h_lo + it / per_head;
                const int n0 = (qt0 + it % per_head) * BN;
                unsigned char* st = ring + s * L::STAGE;
                if (lane == 0) {
                    mbar_expect_tx(&full[s], L::TK + L::TV);
                    tma_load_tile<D, BN>(reinterpret_cast<bf16*>(st), &tq, &full[s], n0, h, b);
                    tma_load_tile<DV, BN>(reinterpret_cast<bf16*>(st + L::TK), &tdo, &full[s],
                                          n0, h, b);
                }
                float* lse_sh = reinterpret_cast<float*>(st + L::TK + L::TV);
                const int64_t base = (int64_t(b) * p.H + h) * p.S;
                for (int i = lane; i < BN; i += 32) {
                    const bool ok = n0 + i < p.S;
                    lse_sh[i] = ok ? p.lse[base + n0 + i] * kLog2e : 0.f;
                    lse_sh[BN + i] = ok ? p.delta[base + n0 + i] : 0.f;
                }
                mbar_arrive(&full[s]);
            }
        }
        __syncwarp();
    } else if (n_items > 0) {       // consumer warpgroup: kv rows k0 .. k0 + 63
        const int warp = tid / 32, g = lane / 4, c = lane % 4;
        const uint32_t k_addr = smem_u32(k_sh), v_addr = smem_u32(v_sh);
        int krow[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) krow[hr] = k0 + warp * 16 + g + 8 * hr;
        mbar_wait(kv_full, 0);
        for (int it = 0; it < n_items; ++it) {
            const int s = it % kDkvStages;
            mbar_wait(&full[s], (it / kDkvStages) & 1);
            const unsigned char* st = ring + s * L::STAGE;
            const uint32_t q_addr = smem_u32(st), do_addr = q_addr + L::TK;
            const float* lb = reinterpret_cast<const float*>(st + L::TK + L::TV);
            const float* db = lb + BN;
            const int n0 = (qt0 + it % per_head) * BN;
            // (row hr, column j * 8 + 2 c + e) of this thread is unmasked
            auto live = [&](int hr, int cc) {
                const int qi = n0 + cc;
                return qi < p.S && krow[hr] < p.kv_len && (!p.causal || krow[hr] <= p.q_offset + qi);
            };

            // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x BN q columns each
            auto issue_st = [&](float (&sc)[BN / 2]) {
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<BN, 0, 0>(sc, desc_k<D, BM>(k_addr, 0, kk),
                                       desc_k<D, BN>(q_addr, 0, kk), kk > 0);
            };
            uint32_t pf[BN / 16][4], dsf[BN / 16][4];
            if constexpr (!kPTBf16<D, DV>) {
                float sc[BN / 2], dp[BN / 2];
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
                wgmma_fence();
                issue_st(sc);
#pragma unroll
                for (int kk = 0; kk < DV / 16; ++kk)
                    wgmma_ss<BN, 0, 0>(dp, desc_k<DV, BM>(v_addr, 0, kk),
                                       desc_k<DV, BN>(do_addr, 0, kk), kk > 0);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(sc);
                fence_regs(dp);

                // P^T on unmasked entries (0 elsewhere) and dS^T = P^T (dP^T - delta),
                // both rounded to bf16 A registers
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int cc = j * 8 + 2 * c + e;
                            float& sv = sc[4 * j + 2 * hr + e];
                            sv = live(hr, cc) ? exp2f(sv * p.scale_log2 - lb[cc]) : 0.f;
                        }
                        const int r = 4 * j + 2 * hr, cc = j * 8 + 2 * c;
                        pf[j / 2][(j % 2) * 2 + hr] = pack_bf16(sc[r], sc[r + 1]);
                        dsf[j / 2][(j % 2) * 2 + hr] = pack_bf16(
                            sc[r] * (dp[r] - db[cc]), sc[r + 1] * (dp[r + 1] - db[cc + 1]));
                    }
                }
                // dV += P^T dO and dK += dS^T Q
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tile<DV, BN>(dv, pf[kk], do_addr, kk);
#pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tile<D, BN>(dk, dsf[kk], q_addr, kk);
            } else {
                float sc[BN / 2];
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
                wgmma_fence();
                issue_st(sc);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(sc);
                // P^T straight to bf16 A registers; S^T is dead after this
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j) {
                        float pv[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e)
                            pv[e] = live(hr, j * 8 + 2 * c + e)
                                ? exp2f(sc[4 * j + 2 * hr + e] * p.scale_log2 - lb[j * 8 + 2 * c + e])
                                : 0.f;
                        pf[j / 2][(j % 2) * 2 + hr] = pack_bf16(pv[0], pv[1]);
                    }
                }
                // dV += P^T dO, and dP^T = V dO^T beside it
                float dp[BN / 2];
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) dp[i] = 0.f;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tile<DV, BN>(dv, pf[kk], do_addr, kk);
#pragma unroll
                for (int kk = 0; kk < DV / 16; ++kk)
                    wgmma_ss<BN, 0, 0>(dp, desc_k<DV, BM>(v_addr, 0, kk),
                                       desc_k<DV, BN>(do_addr, 0, kk), kk > 0);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dp);
                fence_regs(dv);
                fence_regs(pf);
                // dS^T = P^T (dP^T - delta), P^T read back from its bf16 registers
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j) {
                        const int r = 4 * j + 2 * hr, cc = j * 8 + 2 * c;
                        const float2 pv = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&pf[j / 2][(j % 2) * 2 + hr]));
                        dsf[j / 2][(j % 2) * 2 + hr] = pack_bf16(
                            pv.x * (dp[r] - db[cc]), pv.y * (dp[r + 1] - db[cc + 1]));
                    }
                }
                // dK += dS^T Q
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tile<D, BN>(dk, dsf[kk], q_addr, kk);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv);
            fence_regs(dk);
            fence_regs(pf);
            fence_regs(dsf);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with the stage
        }
    }

    if (C == 1) {                   // the block holds the whole group: store
        if (tid >= 128) return;
        const int warp = tid / 32, g = lane / 4, c = lane % 4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = k0 + warp * 16 + g + 8 * hr;
            if (row >= p.T) continue;
            bf16* krw = p.dk + b * p.dk_sb + hk * p.dk_sh + row * p.dk_ss + 2 * c;
            bf16* vrw = p.dv + b * p.dv_sb + hk * p.dv_sh + row * p.dv_ss + 2 * c;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt)
                *reinterpret_cast<__nv_bfloat162*>(krw + dt * 8) = __floats2bfloat162_rn(
                    dk[4 * dt + 2 * hr] * p.scale, dk[4 * dt + 2 * hr + 1] * p.scale);
#pragma unroll
            for (int dt = 0; dt < DV / 8; ++dt)
                *reinterpret_cast<__nv_bfloat162*>(vrw + dt * 8) =
                    __floats2bfloat162_rn(dv[4 * dt + 2 * hr], dv[4 * dt + 2 * hr + 1]);
        }
        return;
    }

    // The cluster's sum.  The ring is idle now: every load was consumed.
    // [64][RLD] dk partials, then [64][RLDV] dv partials
    float* red = reinterpret_cast<float*>(ring);
    float* red_v = red + BM * L::RLD;
    if (tid < 128) {
        const int warp = tid / 32, g = lane / 4, c = lane % 4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int r = warp * 16 + g + 8 * hr;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt)
                *reinterpret_cast<float2*>(red + r * L::RLD + dt * 8 + 2 * c) =
                    make_float2(dk[4 * dt + 2 * hr], dk[4 * dt + 2 * hr + 1]);
#pragma unroll
            for (int dt = 0; dt < DV / 8; ++dt)
                *reinterpret_cast<float2*>(red_v + r * L::RLDV + dt * 8 + 2 * c) =
                    make_float2(dv[4 * dt + 2 * hr], dv[4 * dt + 2 * hr + 1]);
        }
    }
    cluster_sync();
    const int rows = BM / C, r0 = rank * rows;
    const uint32_t red_addr = smem_u32(red), red_v_addr = smem_u32(red_v);
    const int n_k = rows * (D / 4);                 // dk's float4s, then dv's
    for (int i = tid; i < n_k + rows * (DV / 4); i += kDkvThreads) {
        const int which = i >= n_k, rem = which ? i - n_k : i, w4 = which ? DV / 4 : D / 4;
        const int r = r0 + rem / w4, col = (rem % w4) * 4;
        const uint32_t addr = which ? red_v_addr + (r * L::RLDV + col) * 4
                                    : red_addr + (r * L::RLD + col) * 4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int src = 0; src < C; ++src) {      // fixed order: repeatable bits
            const float4 v = ld_cluster_f4(map_rank(addr, src));
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
        }
        const int row = k0 + r;
        if (row >= p.T) continue;
        const float sc = which == 0 ? p.scale : 1.f;
        bf16* dst = which == 0 ? p.dk + b * p.dk_sb + hk * p.dk_sh + row * p.dk_ss + col
                               : p.dv + b * p.dv_sb + hk * p.dv_sh + row * p.dv_ss + col;
        __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x * sc, sum.y * sc);
        __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z * sc, sum.w * sc);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst) = packed;
    }
    cluster_sync();                 // no block leaves while another reads its partials
}

template <int D, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const DqParams& p,
              const int64_t* st, cudaStream_t stream) {
    TileMap<D> tq, tk;
    TileMap<DV> tdo, tv;
    int rc = encode_map<D>(&tq, q, p.B, p.H, p.S, st[0], st[1], st[2], BM);
    if (!rc) rc = encode_map<DV>(&tdo, dout, p.B, p.H, p.S, st[12], st[13], st[14], BM);
    if (!rc) rc = encode_map<D>(&tk, k, p.B, p.Hkv, p.kv_len, st[3], st[4], st[5], BN);
    if (!rc) rc = encode_map<DV>(&tv, v, p.B, p.Hkv, p.kv_len, st[6], st[7], st[8], BN);
    if (rc) return rc;
    const int bytes = static_cast<int>(DqSmem<D, DV>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    // a persistent grid: as many blocks as stay resident, each walking the
    // work items blockIdx.x, blockIdx.x + gridDim.x, ...
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(e);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_dq_kernel<D, DV>,
                                                           kDqThreads, bytes)) != cudaSuccess)
        return static_cast<int>(e);
    const int n_work = dq_work(p.n_qt, p.B, p.Hkv, p.rep);
    const int grid = max(1, min(n_work, sms * max(per_sm, 1)));
    flash_bwd_dq_kernel<D, DV><<<grid, kDqThreads, bytes, stream>>>(tq, tdo, tk, tv, p);
    return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const DkvParams& p, int B, const int64_t* st, cudaStream_t stream) {
    TileMap<D> tq, tk;
    TileMap<DV> tdo, tv;
    int rc = encode_map<D>(&tq, q, B, p.H, p.S, st[0], st[1], st[2], BN);
    if (!rc) rc = encode_map<DV>(&tdo, dout, B, p.H, p.S, st[12], st[13], st[14], BN);
    if (!rc) rc = encode_map<D>(&tk, k, B, p.Hkv, p.kv_len, st[3], st[4], st[5], BM);
    if (!rc) rc = encode_map<DV>(&tv, v, B, p.Hkv, p.kv_len, st[6], st[7], st[8], BM);
    if (rc) return rc;
    const int bytes = static_cast<int>(DkvSmem<D, DV>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.cluster, B * p.Hkv, (p.T + BM - 1) / BM);
    cfg.blockDim = dim3(kDkvThreads, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<D, DV>, tq, tdo, tk, tv, p);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}


}  // namespace

// Shared layout of both entry points: q, dq [B,H,S,D], k, dk [B,Hkv,T,D],
// out, dO [B,H,S,DV] and v, dv [B,Hkv,T,DV] as strided bf16 views whose last
// dim is contiguous; lse and delta [B,H,S] contiguous fp32.  strides holds the
// (batch, head, row) element strides of q, k, v, out, dO, dq, dk, dv in that
// order.  A pointer the pass does not touch may be null.  The wrapper checks
// shapes, 16-byte alignment and (D, DV): one of (32, 32), (64, 64), (80, 80),
// (128, 128) and (192, 128).
namespace {
bool head_dims_ok(int D, int DV) { return D == DV || (D == 192 && DV == 128); }
}  // namespace

// dq pass: writes dq and delta = rowsum(out * dO).
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           void* delta, void* dq, int B, int H, int Hkv, int S,
                                           int T, int D, int DV, int kv_len, int q_offset,
                                           int causal, float scale, const int64_t* strides,
                                           void* stream) {
    (void)T;
    DqParams p;
    p.o = static_cast<const bf16*>(out);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<float*>(delta);
    p.dq = static_cast<bf16*>(dq);
    p.B = B;
    p.H = H;
    p.Hkv = Hkv;
    p.rep = H / Hkv;
    p.S = S;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.causal = causal;
    p.n_qt = (S + BM - 1) / BM;
    p.scale = scale;
    p.scale_log2 = scale * kLog2e;
    p.o_sb = strides[9];   p.o_sh = strides[10];  p.o_ss = strides[11];
    p.dq_sb = strides[15]; p.dq_sh = strides[16]; p.dq_ss = strides[17];
    if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    if (!head_dims_ok(D, DV)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dq<32, 32>(q, k, v, dout, p, strides, st);
        case 64: return launch_dq<64, 64>(q, k, v, dout, p, strides, st);
        case 80: return launch_dq<80, 80>(q, k, v, dout, p, strides, st);
        case 128: return launch_dq<128, 128>(q, k, v, dout, p, strides, st);
        case 192: return launch_dq<192, 128>(q, k, v, dout, p, strides, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// dk/dv pass: reads the delta the dq pass wrote (same stream, launched after).
// `cluster` (1, 2, 4 or 8) blocks split each kv tile's GQA group.
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int B, int H, int Hkv, int S,
                                            int T, int D, int DV, int kv_len, int q_offset,
                                            int causal, int cluster, float scale,
                                            const int64_t* strides, void* stream) {
    if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
        return static_cast<int>(cudaErrorInvalidValue);
    DkvParams p;
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.H = H;
    p.Hkv = Hkv;
    p.rep = H / Hkv;
    p.S = S;
    p.T = T;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.causal = causal;
    p.cluster = cluster;
    p.scale = scale;
    p.scale_log2 = scale * kLog2e;
    p.dk_sb = strides[18]; p.dk_sh = strides[19]; p.dk_ss = strides[20];
    p.dv_sb = strides[21]; p.dv_sh = strides[22]; p.dv_ss = strides[23];
    if (B == 0 || T == 0) return static_cast<int>(cudaGetLastError());
    if (!head_dims_ok(D, DV)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dkv<32, 32>(q, k, v, dout, p, B, strides, st);
        case 64: return launch_dkv<64, 64>(q, k, v, dout, p, B, strides, st);
        case 80: return launch_dkv<80, 80>(q, k, v, dout, p, B, strides, st);
        case 128: return launch_dkv<128, 128>(q, k, v, dout, p, B, strides, st);
        case 192: return launch_dkv<192, 128>(q, k, v, dout, p, B, strides, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Dynamic shared memory of one dk/dv block at head dims (D, DV) (0 for
// another pair).
extern "C" int flash_attention_bwd_dkv_smem_bytes(int D, int DV) {
    if (!head_dims_ok(D, DV)) return 0;
    switch (D) {
        case 32: return static_cast<int>(DkvSmem<32, 32>::bytes);
        case 64: return static_cast<int>(DkvSmem<64, 64>::bytes);
        case 80: return static_cast<int>(DkvSmem<80, 80>::bytes);
        case 128: return static_cast<int>(DkvSmem<128, 128>::bytes);
        case 192: return static_cast<int>(DkvSmem<192, 128>::bytes);
        default: return 0;
    }
}

// Dynamic shared memory of one dq block at head dims (D, DV) (0 for another
// pair).
extern "C" int flash_attention_bwd_dq_smem_bytes(int D, int DV) {
    if (!head_dims_ok(D, DV)) return 0;
    switch (D) {
        case 32: return static_cast<int>(DqSmem<32, 32>::bytes);
        case 64: return static_cast<int>(DqSmem<64, 64>::bytes);
        case 80: return static_cast<int>(DqSmem<80, 80>::bytes);
        case 128: return static_cast<int>(DqSmem<128, 128>::bytes);
        case 192: return static_cast<int>(DqSmem<192, 128>::bytes);
        default: return 0;
    }
}
