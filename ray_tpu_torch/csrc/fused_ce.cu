// Fused LM-head cross-entropy for Hopper (sm_90a): the (N, V) logits of
// x W^T never reach device memory, in the forward or the backward.
//
// Replaces: ray_tpu/ops/fused_ce.py
//   fused_ce_fwd  <- _fwd_pallas (:81, _fwd_kernel :53): per row the online
//                    logsumexp of x W^T over vocab tiles, and the target logit;
//   fused_ce_dx   <- _bwd_pallas's dx call (:154, _dx_kernel :113):
//                    dx = sum_v (softmax - onehot) W;
//   fused_ce_dw   <- _bwd_pallas's dW call (:167, _dw_kernel :131):
//                    dW = sum_n (softmax - onehot)^T x.
// x (N, D) and W (V, D) are bf16, t (N,) int32; lse and tgt (N,) and dx
// (N, D), dW (V, D) are fp32 (the Python wrapper scales and casts them).
// p = exp(logits - lse) - onehot is rounded to bf16 before each product, as
// the reference rounds it to the operand type (:127, :146).
//
// What bounds it on an H100: operations. At GPT-2 124M's training shape
// (N = 16 * 1024, D = 768, V = 50304) the forward is 2*N*V*D = 1.27e12 flops
// (1.28 ms at 989 TFLOP/s) against 0.1 GB of x and W; dx and dW each
// recompute the logits and add one product of the same size (2.56 ms each).
// Times, ablations and the designs tried: PERF.md, Findings.
//
// The forward: a block holds 64 rows of x in shared memory (one TMA copy)
// and walks the vocabulary in tiles of 256 rows of W, each tile's logits
// (64 x 256 fp32, 128 registers a thread) in registers and never in device
// memory. Per tile, an online logsumexp (base 2) keeps each thread's
// running max and sum over its 2 rows x 64 columns; a row's four
// column-owning threads merge once, at the end. What bounds the design at
// the training shape (N = 16384, D = 768, V = 50304):
// - Operations: 4.95 GFLOP a block, 0.66 ms at one SM's share of the peak.
//   The logits are wgmma m64n256k16 with both operands in shared memory:
//   10 KB read per 128 clocks of math, under the 128 bytes a clock shared
//   memory gives (a 32-column tile, as the backward's, would be bound by
//   shared memory).
// - L2: every block reads all of W (77 MB), 19.8 GB a launch at one block
//   per 64 rows. Blocks form clusters of kFwdCluster = 2 along N: each
//   loads half of every W chunk and the TMA multicasts it into both, which
//   halves the L2 traffic. Clusters of 4 were slower (the slowest of four
//   blocks sets every buffer's refill).
// - The exponentials: 64 x 256 a tile, ~1000 clocks of the SFUs against
//   ~6100 of products. Two consumer warpgroups take alternate vocab tiles
//   (ping-pong) and take turns at the W stream (two named barriers), so
//   one warpgroup's products run while the other exponentiates.
// - The refill's round trip: W streams as chunks of 64 columns by 256
//   vocab rows (32 KB, 128-byte swizzled, the layout wgmma reads) through a
//   ring of kFwdStages = 4 buffers next to x's 96 KB. One producer warp
//   issues the copies; a buffer is refilled once the consuming warpgroup
//   of both blocks has released it (an mbarrier that counts arrivals from
//   the cluster, made at CTA scope: at cluster scope each release was a
//   fence that doubled the kernel's time). Tiles of 128 rows through 8
//   buffers of 16 KB were slower: twice the chunks, each with its round
//   trip.
// Vocab rows past V arrive as zeros and their columns are masked out of
// the max and the sum; rows past N are never written. Every block sums its
// tiles in one order, and the two warpgroups' halves merge in one order,
// so two runs give the same bits.
//
// The backward, dx and dW: one body, the roles a template parameter.
//   dx: R = 64 rows of x resident, S = W streaming past, out = dx (N, D);
//   dW: R = 64 vocab rows of W resident, S = x streaming past, out = dW.
// Per streamed tile of 32 rows the block recomputes the 64 x 32 logits
// R S^T, forms p - onehot, rounds it to bf16 and adds P S into a 64 x D
// fp32 accumulator in registers. Each block owns its 64 output rows and
// walks every streamed tile itself, in one order (the counterpart of the
// TPU's sequential grid axis, :141-147): no atomics, the same bits on every
// run. Rows past N and vocab rows past V arrive as zeros (TMA), get p = 0
// and are never written.
//
// What bounds the design, and the accumulator arithmetic:
// - The accumulator sets the layout. 64 x 768 fp32 is 192 KB, three
//   quarters of the register file: no tile taller than 64 rows fits, and
//   one warpgroup cannot hold 768 columns. So D is split across consumer
//   warpgroups, two at D = 768 (one at 128 or 64): warpgroup i owns the
//   columns D_i, which are at once the K-slice of its partial logits
//   R[:, D_i] S[:, D_i]^T (wgmma m64n32k16, both operands K-major in shared
//   memory) and the N-slice of its accumulator, acc_i (64 x 384 fp32, 192
//   registers a thread) += P S[:, D_i] (wgmma m64n128k16 three times per
//   k-step, P from registers as the A operand, S read MN-major). Two
//   warpgroups of 128 threads may hold 255 registers a thread: 240 (dx)
//   and 248 (dW) are used, no spill. Three warpgroups of 256 columns (128
//   accumulator registers under a 168 cap) spilled 136 bytes and ptxas
//   serialised their wgmma (C7512): 10.9 / 11.1 ms for dx / dW at the
//   training shape on an H100 SXM (700 W), against 5.9 / 6.7 for two.
// - Each warpgroup touches only its own D-slice of R and S. The only traffic
//   between warpgroups is the partial logits (64 x 32 fp32 each): each
//   writes its own to shared memory, one barrier, then every warpgroup sums
//   the partials in the same order (warpgroup 0, then 1), so both form the
//   same P bits and exponentiate the whole tile (twice the exponentials of
//   one pass).
// - Loads: one thread has the TMA copy each tile by tensor map, the whole
//   tile in one instruction ({64, rows, D / 64} with the 64-column slab as
//   the outer index, 128-byte swizzled): R once (64 rows), S through a
//   ring of two buffers of 32 rows, one mbarrier each, a buffer refilled
//   once every thread is past the barrier that ends its tile. One copy per
//   64-column box (12 at D = 768) kept every other warp waiting at the
//   next barrier while one thread issued them: 13% of dx's time. dW
//   stages each streamed tile's 32 lse values (base 2) and targets in
//   shared memory, by plain loads issued a tile ahead.
// - Shared memory at D = 768: R 96 KB, two S buffers 96 KB, the partials
//   16 KB: 210 KB with the barriers and the alignment slack, one block per
//   SM. A 64-row S tile would cut the logits' shared-memory reads per flop
//   by a third, but only one buffer of it fits.
// - The grid at the training shape: 256 blocks for dx (W, 77 MB, streamed
//   past each once from L2), 786 for dW (x, 25 MB, each).
// - Each tile's products are waited for within the tile. Starting the next
//   tile's logits before this tile's exponentials, or before its product,
//   gives the same bits but needs a second set of logits registers: 255
//   registers, ~500 bytes of spill, and dx / dW 10-11 / 12 ms (PERF.md,
//   Findings). Where the time goes, by ablation
//   (scripts/torch_ce_ablate.py): the P S product is the largest share,
//   then the logits, the loads, the partial exchange, the exponentials.
//
// D must be one of the instantiated widths: 768 (GPT-2 124M), 128
// (GPTConfig.tiny()) and 64 (the ragged test case). The accumulators are
// registers sized at compile time; the wrapper checks D, and that x and W
// start on 16 bytes (the tensor maps' rule).

#include "wgmma_sm90.cuh"


namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// ---- The backward body (dx and dW) ----

constexpr int kResRows = 64;  // rows of the resident tile: wgmma's M
constexpr int kStrRows = 32;  // rows of a streamed tile: the logits' N, P's K
constexpr int kStages = 2;    // buffers of the streamed ring
// One 64-column box of a tile: 64 (or 32) rows of 128 swizzled bytes.
constexpr int kResBox = kResRows * kBoxCols * 2;
constexpr int kStrBox = kStrRows * kBoxCols * 2;

// The backward's threads and shared memory at width D, from a
// 1024-byte-aligned base (kBytes adds the slack to reach it): the resident
// tile (D / 64 boxes of 64 rows), kStages streamed tiles (D / 64 boxes of
// 32 rows each), each warpgroup's partial logits (64 x 32 fp32, when D is
// split), the streamed rows' lse (base 2) and targets per buffer (dW), and
// the mbarriers: the resident tile's, then one per buffer.
template <int D>
struct BwdLayout {
  static constexpr int kGroups = D > 384 ? D / 384 : 1;  // warpgroups
  static constexpr int kCols = D / kGroups;  // columns a warpgroup owns
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kStrTile = D / kBoxCols * kStrBox;
  static constexpr int kRes = 0;
  static constexpr int kStr = D / kBoxCols * kResBox;
  static constexpr int kPart = kStr + kStages * kStrTile;
  static constexpr int kSide =
      kPart + (kGroups > 1 ? kGroups * kResRows * kStrRows * 4 : 0);
  static constexpr int kBars = kSide + kStages * kStrRows * 8;
  static constexpr int kBytes = kBars + (1 + kStages) * 8 + 1024;
  static_assert(kCols * kGroups == D && kCols % kBoxCols == 0,
                "a warpgroup owns whole boxes");
};

// A contiguous bf16 (rows, D) matrix as the tensor {64, rows, D / 64, 1}
// (a 64-column slab is the third index) whose box is `box_rows` rows of
// `box_slabs` slabs: one copy lands the slabs one after another in shared
// memory, each `box_rows` rows of 128 swizzled bytes, the layout wgmma
// reads. Rows past `rows` arrive as zeros.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base,
                                   int rows, int D, int box_rows,
                                   int box_slabs) {
  const cuuint64_t dims[4] = {kBoxCols, (cuuint64_t)rows,
                              (cuuint64_t)D / kBoxCols, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, kBoxCols * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[4] = {kBoxCols, (cuuint32_t)box_rows,
                             (cuuint32_t)box_slabs, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    const_cast<void*>(base), dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// One thread: starts loading rows row0 .. row0 + ROWS - 1, all D columns,
// into the tile at shared address dst (1024-byte aligned), as one copy and
// one arrival on `bar` that expects it.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_tma(uint32_t dst,
                                              const CUtensorMap* map, int row0,
                                              uint64_t* bar) {
  mbar_expect_tx(bar, D * ROWS * 2);
  tensor_load(dst, map, 0, row0, 0, 0, bar);
}

// With p[n, v] = exp(x[n] . W[v] - lse[n]) - [v == t[n]]:
// dx (kDw false): out[n] = sum_v p[n, v] W[v];
// dW (kDw true):  out[v] = sum_n p[n, v] x[n];
// fp32, p - onehot rounded to bf16. res_map: the resident operand (x for
// dx, W for dW) in 64-row boxes; str_map: the streamed one in 32-row boxes.
template <int D, bool kDw>
__global__ void __launch_bounds__(BwdLayout<D>::kThreads, 1)
fused_ce_bwd_kernel(const __grid_constant__ CUtensorMap res_map,
                    const __grid_constant__ CUtensorMap str_map,
                    const int* __restrict__ t, const float* __restrict__ lse,
                    float* __restrict__ out, int N, int V) {
  using L = BwdLayout<D>;
  constexpr int kNW = L::kCols >= 128 ? 128 : 64;  // columns of one wgmma
  constexpr int kNC = L::kCols / kNW;              // wgmma per k-step
  constexpr int kKS = kStrRows / 16;               // k-steps of P S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* ptr = smem_raw + (base - raw);
  uint64_t* res_bar = reinterpret_cast<uint64_t*>(ptr + L::kBars);
  uint64_t* str_bar = res_bar + 1;
  float4* part = reinterpret_cast<float4*>(ptr + L::kPart);
  float* side_lse = reinterpret_cast<float*>(ptr + L::kSide);
  int* side_t = reinterpret_cast<int*>(side_lse + kStages * kStrRows);

  const int n_res = kDw ? V : N;  // rows of the resident operand and of out
  const int n_str = kDw ? N : V;  // rows of the streamed operand
  const int r0 = blockIdx.x * kResRows;
  const int n_tiles = (n_str + kStrRows - 1) / kStrRows;

  const int group = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4;  // row within the 8-row group of a fragment
  const int tq = tid % 4;        // column pair within a fragment
  const int row_a = r0 + (tid / 32) * 16 + g;  // this thread's two out rows
  const int row_b = row_a + 8;

  // dW: thread i < 32 stages the lse (base 2) of streamed row i of a tile,
  // thread 32 + i its target; rows past N hold 0 and -1.
  const int stage_i = threadIdx.x % kStrRows;
  auto stage_value = [&](int j) -> uint32_t {
    const int n = j * kStrRows + stage_i;
    if (threadIdx.x < kStrRows)
      return __float_as_uint(n < N ? lse[n] * kLog2e : 0.f);
    return (uint32_t)(n < N ? t[n] : -1);
  };
  auto stage_store = [&](int buf, uint32_t v) {
    if (threadIdx.x < kStrRows)
      side_lse[buf * kStrRows + stage_i] = __uint_as_float(v);
    else
      side_t[buf * kStrRows + stage_i] = (int)v;
  };
  const bool stager = kDw && threadIdx.x < 2 * kStrRows;

  const CUtensorMap* smap = &str_map;
  auto load_streamed = [&](int j) {
    const int buf = j % kStages;
    load_rows_tma<D, kStrRows>(base + L::kStr + buf * L::kStrTile, smap,
                               j * kStrRows, str_bar + buf);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(res_bar + i, 1);
    fence_mbar_init();
    load_rows_tma<D, kResRows>(base + L::kRes, &res_map, r0, res_bar);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_streamed(j);
  }
  if (stager)
    for (int j = 0; j < kStages && j < n_tiles; ++j)
      stage_store(j, stage_value(j));
  __syncthreads();

  // dx: lse (base 2) and target of the two rows.
  float lse_a = 0.f, lse_b = 0.f;
  int t_a = -1, t_b = -1;
  if (!kDw) {
    if (row_a < N) { lse_a = lse[row_a] * kLog2e; t_a = t[row_a]; }
    if (row_b < N) { lse_b = lse[row_b] * kLog2e; t_b = t[row_b]; }
  }

  // This warpgroup's first 64-column box.
  const int box0 = group * (L::kCols / kBoxCols);
  const uint64_t res_desc =
      sw128_desc(base + L::kRes + box0 * kResBox, 16, 1024);

  float acc[kNC][kNW / 2];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kNW / 2; ++i) acc[c][i] = 0.f;
  float z[16];  // the tile's logits (this warpgroup's partial, then whole)

  mbar_wait(res_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j % kStages;
    const uint32_t s_tile = base + L::kStr + buf * L::kStrTile + box0 * kStrBox;
    const bool refill = j + kStages < n_tiles;
    // The staged row of the tile this buffer takes next, loaded now and
    // stored once every thread is done with the buffer.
    const uint32_t staged = stager && refill ? stage_value(j + kStages) : 0u;

    // Partial logits R[:, D_i] S[:, D_i]^T, one group.
    mbar_wait(str_bar + buf, (j / kStages) & 1);
    fence_regs(z);
    wgmma_fence();
    {
      const uint64_t s_desc = sw128_desc(s_tile, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < L::kCols / 16; ++kk)
        wgmma_64x32x16_ss(
            z, desc_at(res_desc, (kk / 4) * kResBox + (kk % 4) * 32),
            desc_at(s_desc, (kk / 4) * kStrBox + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);

    // The whole logits: the partials summed in warpgroup order. Thread tid
    // of every warpgroup holds the same 16 entries, so each is stored at
    // (warpgroup, chunk, tid).
    if constexpr (L::kGroups > 1) {
      float4* mine = part + group * 4 * 128 + tid;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mine[q * 128] = make_float4(z[4 * q], z[4 * q + 1], z[4 * q + 2],
                                    z[4 * q + 3]);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 own = make_float4(z[4 * q], z[4 * q + 1], z[4 * q + 2],
                                       z[4 * q + 3]);
        float4 s = group == 0 ? own : part[q * 128 + tid];
#pragma unroll
        for (int p = 1; p < L::kGroups; ++p) {
          const float4 v = p == group ? own : part[(p * 4 + q) * 128 + tid];
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        z[4 * q] = s.x; z[4 * q + 1] = s.y; z[4 * q + 2] = s.z;
        z[4 * q + 3] = s.w;
      }
    }

    // p - onehot; rows and columns past N or V get 0 by assignment.
    const int col0 = j * kStrRows;
    const bool edge = col0 + kStrRows > n_str || r0 + kResRows > n_res;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cl = 8 * q + 2 * tq;  // local column of entries 0 and 2
      float2 ls2 = make_float2(0.f, 0.f);
      int2 tt2 = make_int2(-1, -1);
      if (kDw) {
        ls2 = *reinterpret_cast<const float2*>(side_lse + buf * kStrRows + cl);
        tt2 = *reinterpret_cast<const int2*>(side_t + buf * kStrRows + cl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + cl + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float ls;
        bool hot;
        if (kDw) {
          ls = (e & 1) ? ls2.y : ls2.x;
          hot = ((e & 1) ? tt2.y : tt2.x) == row;
        } else {
          ls = e < 2 ? lse_a : lse_b;
          hot = col == (e < 2 ? t_a : t_b);
        }
        float p = exp2f(z[4 * q + e] * kLog2e - ls) - (hot ? 1.f : 0.f);
        if (edge && (col >= n_str || row >= n_res)) p = 0.f;
        z[4 * q + e] = p;
      }
    }
    // P in the A layout: the accumulator chunks 2kt and 2kt + 1 are k-step
    // kt.
    uint32_t pa[kKS][4];
#pragma unroll
    for (int kt = 0; kt < kKS; ++kt) {
      pa[kt][0] = pack_bf16(z[8 * kt], z[8 * kt + 1]);
      pa[kt][1] = pack_bf16(z[8 * kt + 2], z[8 * kt + 3]);
      pa[kt][2] = pack_bf16(z[8 * kt + 4], z[8 * kt + 5]);
      pa[kt][3] = pack_bf16(z[8 * kt + 6], z[8 * kt + 7]);
    }

    // acc += P S[:, D_i], one group: S read MN-major, 16 rows (2 KB of each
    // box) per k-step, kNW columns (kNW / 64 boxes) per wgmma.
#pragma unroll
    for (int c = 0; c < kNC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kt = 0; kt < kKS; ++kt) fence_regs(pa[kt]);
    wgmma_fence();
    {
      const uint64_t b_desc = sw128_desc(s_tile, kStrBox, 1024);
#pragma unroll
      for (int kt = 0; kt < kKS; ++kt)
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          wgmma_rs<kNW>(acc[c], pa[kt],
                        desc_at(b_desc, kt * 16 * kBoxCols * 2 +
                                            c * (kNW / kBoxCols) * kStrBox));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kNC; ++c) fence_regs(acc[c]);

    // Every thread is done with buffer buf and the partials: the buffer
    // takes tile j + kStages. The barrier stands after every tile but the
    // last, so that a staged row is visible before its tile is read.
    if (j + 1 < n_tiles) {
      __syncthreads();
      if (refill) {
        if (threadIdx.x == 0) load_streamed(j + kStages);
        if (stager) stage_store(buf, staged);
      }
    }
  }

  // This warpgroup's columns of the two rows; rows past n_res are skipped.
  const int col_base = group * L::kCols + 2 * tq;
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int d = 0; d < kNW / 8; ++d) {
      const int col = col_base + c * kNW + 8 * d;
      if (row_a < n_res)
        *reinterpret_cast<float2*>(out + (long long)row_a * D + col) =
            make_float2(acc[c][4 * d], acc[c][4 * d + 1]);
      if (row_b < n_res)
        *reinterpret_cast<float2*>(out + (long long)row_b * D + col) =
            make_float2(acc[c][4 * d + 2], acc[c][4 * d + 3]);
    }
}

// ---- The forward (lse and tgt) ----

constexpr int kVocabTile = 256;  // vocab rows of a logits tile: wgmma's N
constexpr int kFwdGroups = 2;    // consumer warpgroups, taking alternate tiles
constexpr int kFwdCluster = 2;   // blocks along N that share every W chunk
// One W chunk: 64 columns of kVocabTile rows, 128 swizzled bytes a row.
constexpr int kChunkBytes = kVocabTile * kBoxCols * 2;
constexpr int kFwdStages = 4;  // W chunk buffers: 128 KB beside x's 96 KB
static_assert(kVocabTile == 256, "a logits tile is one m64n256k16 wgmma");
static_assert(kFwdGroups == 1 || kFwdGroups == 2, "one or two consumers");

// The forward's threads and shared memory at width D, from a
// 1024-byte-aligned base: x's 64 rows (D / 64 boxes), kFwdStages W chunks,
// the second warpgroup's (max, sum, target) per row for the final merge,
// and the mbarriers: x's, then each chunk buffer's full and empty.
template <int D>
struct FwdLayout {
  static constexpr int kChunks = D / kBoxCols;  // W chunks per vocab tile
  static constexpr int kThreads = 128 * kFwdGroups + 32;  // + producer warp
  static constexpr int kX = 0;
  static constexpr int kW = kChunks * kResBox;
  static constexpr int kMerge = kW + kFwdStages * kChunkBytes;
  static constexpr int kBars = kMerge + kResRows * 3 * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kFwdStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// lse[n] = logsumexp_v(x[n] . W[v]) and tgt[n] = x[n] . W[t[n]], fp32.
// x_map: x as one box of 64 rows of every slab; w_map: W in boxes of
// kVocabTile / kFwdCluster rows of one slab. Launched in clusters of
// kFwdCluster blocks along N (FwdLaunch).
template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::kThreads, 1)
fused_ce_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const int* __restrict__ t, float* __restrict__ lse,
                    float* __restrict__ tgt, int N, int V) {
  using L = FwdLayout<D>;
  constexpr int kPart = kVocabTile / kFwdCluster;  // W rows a block loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* ptr = smem_raw + (base - raw);
  uint64_t* x_bar = reinterpret_cast<uint64_t*>(ptr + L::kBars);
  uint64_t* full = x_bar + 1;           // a chunk has landed here
  uint64_t* empty = full + kFwdStages;  // the cluster is done with a chunk
  float* merge = reinterpret_cast<float*>(ptr + L::kMerge);

  const int r0 = blockIdx.x * kResRows;
  const int n_tiles = (V + kVocabTile - 1) / kVocabTile;
  const int n_chunks = n_tiles * L::kChunks;

  if (threadIdx.x == 0) {
    mbar_init(x_bar, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      // One arrival from each warp of the consuming warpgroup of every
      // block of the cluster.
      mbar_init(empty + s, 4 * kFwdCluster);
    }
    fence_mbar_init();
  }
  // No block copies into a peer or arrives on its barriers before the
  // peer's barriers are set.
  cluster_sync();

  if (threadIdx.x >= 128 * kFwdGroups) {
    // The producer warp: one thread issues every copy. Chunk i is slab
    // i % kChunks of vocab tile i / kChunks, in buffer i % kFwdStages; this
    // block loads rows rank * kPart .. of it into every block of the
    // cluster. No copy starts wholly outside its tensor: a block past N
    // (the grid is whole clusters) loads x's last rows and writes nothing,
    // and a part past V starts at W's last row, in columns that are masked.
    if (threadIdx.x == 128 * kFwdGroups) {
      const int rank = (int)cluster_ctarank();
      load_rows_tma<D, kResRows>(base + L::kX, &x_map, min(r0, N - 1), x_bar);
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % kFwdStages;
        if (i >= kFwdStages)
          mbar_wait(empty + s, (i / kFwdStages - 1) & 1);
        mbar_expect_tx(full + s, kChunkBytes);
        const int v = min((i / L::kChunks) * kVocabTile + rank * kPart, V - 1);
        const uint32_t dst =
            base + L::kW + s * kChunkBytes + rank * (kChunkBytes / kFwdCluster);
        if constexpr (kFwdCluster > 1)
          tensor_load_multicast(dst, &w_map, 0, v, i % L::kChunks, 0, full + s,
                                (uint16_t)((1 << kFwdCluster) - 1));
        else
          tensor_load(dst, &w_map, 0, v, i % L::kChunks, 0, full + s);
      }
    }
    __syncwarp();
  } else {
    const int group = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4;   // row within the 8-row group of a fragment
    const int tq = lane % 4;  // column pair within a fragment
    const int lr_a = warp * 16 + g;  // this thread's two local rows
    const int row_a = r0 + lr_a, row_b = row_a + 8;
    const int t_a = row_a < N ? t[row_a] : -1;
    const int t_b = row_b < N ? t[row_b] : -1;
    // Per row: the running max (base 2), this thread's share of the sum of
    // 2^(z log2(e) - max) over the columns it holds, the target logit.
    float m_a = kMaskValue, m_b = kMaskValue;
    float l_a = 0.f, l_b = 0.f, g_a = 0.f, g_b = 0.f;

    // Lane r of each warp releases a chunk buffer in block r of the cluster.
    auto release = [&](int i) {
      if (lane < kFwdCluster)
        mbar_arrive_cluster(empty + i % kFwdStages, (uint32_t)lane);
    };
    const uint64_t x_desc = sw128_desc(base + L::kX, 16, 1024);
    // The tile's logits: z[4q .. 4q + 3] = (row_a, columns 8q + 2tq and
    // 8q + 2tq + 1), then row_b's same two columns.
    float z[kVocabTile / 2];
#pragma unroll
    for (int i = 0; i < kVocabTile / 2; ++i) z[i] = 0.f;

    mbar_wait(x_bar, 0);
    for (int j = group; j < n_tiles; j += kFwdGroups) {
      // Two consumers take turns: one starts waiting for tile j's chunks
      // once the other has waited for all of tile j - 1's. A wait is by
      // the parity of a buffer's phase, so it must not look more than one
      // fill ahead; and so one warpgroup's products run while the other
      // exponentiates. (Named barriers 2 and 3: warpgroup 0's and 1's turn.)
      if constexpr (kFwdGroups > 1)
        if (j >= kFwdGroups || group > 0)
          named_barrier_sync(2 + group, 128 * kFwdGroups);
      // The logits of vocab tile j, one wgmma group per chunk; a chunk's
      // buffer is released once its products are done.
#pragma unroll 1
      for (int c = 0; c < L::kChunks; ++c) {
        const int i = j * L::kChunks + c;
        const int s = i % kFwdStages;
        mbar_wait(full + s, (i / kFwdStages) & 1);
        fence_regs(z);
        wgmma_fence();
        const uint64_t w_desc =
            sw128_desc(base + L::kW + s * kChunkBytes, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_64x256x16_ss(z, desc_at(x_desc, c * kResBox + kk * 32),
                             desc_at(w_desc, kk * 32), c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (c > 0) release(i - 1);
      }
      if constexpr (kFwdGroups > 1)
        if (j + 1 < n_tiles)
          named_barrier_arrive(2 + (group ^ 1), 128 * kFwdGroups);
      wgmma_wait<0>();
      fence_regs(z);
      release(j * L::kChunks + L::kChunks - 1);

      const int v0 = j * kVocabTile;
      const int col0 = v0 + 2 * tq;  // the column of z[0]
      if (v0 + kVocabTile > V) {
        // Columns past V: -inf, not kMaskValue, so that they add nothing to
        // the sum even of a thread that has seen no column below V (whose
        // max is still kMaskValue).
#pragma unroll
        for (int q = 0; q < kVocabTile / 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col0 + 8 * q + (e & 1) >= V)
              z[4 * q + e] = __int_as_float(0xff800000);  // -inf
      }
      if ((unsigned)(t_a - v0) < (unsigned)kVocabTile) {
#pragma unroll
        for (int q = 0; q < kVocabTile / 8; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * q + e == t_a) g_a += z[4 * q + e];
      }
      if ((unsigned)(t_b - v0) < (unsigned)kVocabTile) {
#pragma unroll
        for (int q = 0; q < kVocabTile / 8; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * q + e == t_b) g_b += z[4 * q + 2 + e];
      }
      float mx_a = z[0], mx_b = z[2];
#pragma unroll
      for (int q = 0; q < kVocabTile / 8; ++q) {
        mx_a = fmaxf(mx_a, fmaxf(z[4 * q], z[4 * q + 1]));
        mx_b = fmaxf(mx_b, fmaxf(z[4 * q + 2], z[4 * q + 3]));
      }
      mx_a = fmaxf(m_a, mx_a * kLog2e);
      mx_b = fmaxf(m_b, mx_b * kLog2e);
      l_a *= fast_exp2(m_a - mx_a);
      l_b *= fast_exp2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
#pragma unroll
      for (int q = 0; q < kVocabTile / 8; ++q) {
        l_a += fast_exp2(fmaf(z[4 * q], kLog2e, -m_a)) +
               fast_exp2(fmaf(z[4 * q + 1], kLog2e, -m_a));
        l_b += fast_exp2(fmaf(z[4 * q + 2], kLog2e, -m_b)) +
               fast_exp2(fmaf(z[4 * q + 3], kLog2e, -m_b));
      }
    }

    // A row's four threads, then (two consumers) the two warpgroups'
    // halves of the vocabulary, merged in one order.
    auto merge_into = [](float& m, float& l, float& gg, float mo, float lo,
                         float go) {
      const float mm = fmaxf(m, mo);
      l = l * fast_exp2(m - mm) + lo * fast_exp2(mo - mm);
      m = mm;
      gg += go;
    };
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      const float ma = __shfl_xor_sync(0xffffffffu, m_a, off);
      const float la = __shfl_xor_sync(0xffffffffu, l_a, off);
      const float ga = __shfl_xor_sync(0xffffffffu, g_a, off);
      const float mb = __shfl_xor_sync(0xffffffffu, m_b, off);
      const float lb = __shfl_xor_sync(0xffffffffu, l_b, off);
      const float gb = __shfl_xor_sync(0xffffffffu, g_b, off);
      merge_into(m_a, l_a, g_a, ma, la, ga);
      merge_into(m_b, l_b, g_b, mb, lb, gb);
    }
    if constexpr (kFwdGroups > 1) {
      if (group == 1 && tq == 0) {
        merge[3 * lr_a] = m_a; merge[3 * lr_a + 1] = l_a;
        merge[3 * lr_a + 2] = g_a;
        merge[3 * lr_a + 24] = m_b; merge[3 * lr_a + 25] = l_b;
        merge[3 * lr_a + 26] = g_b;
      }
      named_barrier_sync(1, 128 * kFwdGroups);
      if (group == 0 && tq == 0) {
        merge_into(m_a, l_a, g_a, merge[3 * lr_a], merge[3 * lr_a + 1],
                   merge[3 * lr_a + 2]);
        merge_into(m_b, l_b, g_b, merge[3 * lr_a + 24], merge[3 * lr_a + 25],
                   merge[3 * lr_a + 26]);
      }
    }
    if (group == 0 && tq == 0) {
      if (row_a < N) {
        lse[row_a] = (m_a + log2f(l_a)) * kLn2;
        tgt[row_a] = g_a;
      }
      if (row_b < N) {
        lse[row_b] = (m_b + log2f(l_b)) * kLn2;
        tgt[row_b] = g_b;
      }
    }
  }
  // No block leaves while a peer may still copy into it or arrive on its
  // barriers.
  cluster_sync();
}

// The forward's launch configuration: `blocks` blocks rounded up to whole
// clusters of kFwdCluster along x.
template <int D>
struct FwdLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute cluster[1];

  FwdLaunch(int blocks, cudaStream_t stream) {
    config.gridDim = dim3((unsigned)((blocks + kFwdCluster - 1) / kFwdCluster *
                                     kFwdCluster));
    config.blockDim = dim3(FwdLayout<D>::kThreads);
    config.dynamicSmemBytes = FwdLayout<D>::kBytes;
    config.stream = stream;
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = kFwdCluster;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    config.attrs = cluster;
    config.numAttrs = 1;
  }
  FwdLaunch(const FwdLaunch&) = delete;
};

template <int D>
int launch_fwd(const void* x, const void* w, const void* t, void* lse,
               void* tgt, int N, int V, cudaStream_t stream) {
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(fused_ce_fwd_kernel<D>, FwdLayout<D>::kBytes,
                               allowed);
  CUtensorMap x_map, w_map;
  if (err == cudaSuccess)
    err = encode_rows_map(&x_map, x, N, D, kResRows, D / kBoxCols);
  if (err == cudaSuccess)
    err = encode_rows_map(&w_map, w, V, D, kVocabTile / kFwdCluster, 1);
  if (err != cudaSuccess) return (int)err;
  const FwdLaunch<D> launch((N + kResRows - 1) / kResRows, stream);
  err = cudaLaunchKernelEx(&launch.config, fused_ce_fwd_kernel<D>, x_map,
                           w_map, static_cast<const int*>(t),
                           static_cast<float*>(lse), static_cast<float*>(tgt),
                           N, V);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the forward's kernel holds on an SM (kernel_resources' five
// numbers), then the cluster's size and how many such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters; blocks per SM alone does
// not see clusters).
template <int D>
int fwd_resources(int* out) {
  using L = FwdLayout<D>;
  cudaError_t err = kernel_resources(fused_ce_fwd_kernel<D>, L::kThreads,
                                     L::kBytes, out);
  if (err != cudaSuccess) return (int)err;
  const FwdLaunch<D> launch(kFwdCluster, nullptr);
  out[5] = kFwdCluster;
  return (int)cudaOccupancyMaxActiveClusters(out + 6, fused_ce_fwd_kernel<D>,
                                             &launch.config);
}

enum class Which { kFwd, kDx, kDw };

template <int D, bool kDw>
int launch_bwd(const void* x, const void* w, const void* t, const void* lse,
               void* out, int N, int V, cudaStream_t stream) {
  using L = BwdLayout<D>;
  static bool allowed[64] = {};
  cudaError_t err =
      allow_smem(fused_ce_bwd_kernel<D, kDw>, L::kBytes, allowed);
  CUtensorMap res_map, str_map;
  if (err == cudaSuccess)
    err = encode_rows_map(&res_map, kDw ? w : x, kDw ? V : N, D, kResRows,
                          D / kBoxCols);
  if (err == cudaSuccess)
    err = encode_rows_map(&str_map, kDw ? x : w, kDw ? N : V, D, kStrRows,
                          D / kBoxCols);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((kDw ? V : N) + kResRows - 1) / kResRows);
  fused_ce_bwd_kernel<D, kDw><<<blocks, L::kThreads, L::kBytes, stream>>>(
      res_map, str_map, static_cast<const int*>(t),
      static_cast<const float*>(lse), static_cast<float*>(out), N, V);
  return (int)cudaGetLastError();
}

template <int D>
int launch(Which which, const void* x, const void* w, const void* t, void* a,
           void* b, int N, int V, cudaStream_t stream) {
  if (which == Which::kDx)
    return launch_bwd<D, false>(x, w, t, a, b, N, V, stream);
  if (which == Which::kDw)
    return launch_bwd<D, true>(x, w, t, a, b, N, V, stream);
  return launch_fwd<D>(x, w, t, a, b, N, V, stream);
}

// What the backward's kernels hold on an SM (kernel_resources in
// mma_sm90.cuh): dx's five numbers, then dW's.
template <int D>
int bwd_resources(int* out) {
  using L = BwdLayout<D>;
  const cudaError_t err = kernel_resources(fused_ce_bwd_kernel<D, false>,
                                           L::kThreads, L::kBytes, out);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_resources(fused_ce_bwd_kernel<D, true>, L::kThreads,
                               L::kBytes, out + 5);
}

// Returns go(std::integral_constant<int, D>{}) for an instantiated width,
// cudaErrorInvalidValue for another.
template <typename Go>
int width_dispatch(int D, Go go) {
  switch (D) {
    case 64: return go(std::integral_constant<int, 64>{});
    case 128: return go(std::integral_constant<int, 128>{});
    case 768: return go(std::integral_constant<int, 768>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(Which which, const void* x, const void* w, const void* t, void* a,
             void* b, int N, int V, int D, void* stream) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return width_dispatch(D, [&](auto d) {
    return launch<decltype(d)::value>(which, x, w, t, a, b, N, V, st);
  });
}

}  // namespace

// Plain C entries, bound with ctypes. x (N, D) and w (V, D) contiguous bf16
// (dx and dW: based on 16 bytes), t (N,) int32, lse/tgt (N,) fp32, dx (N, D)
// and dw (V, D) fp32, all contiguous. Each launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported D, an empty
// input, or an input the tensor maps do not take).
extern "C" int fused_ce_fwd(const void* x, const void* w, const void* t,
                            void* lse, void* tgt, int N, int V, int D,
                            void* stream) {
  return dispatch(Which::kFwd, x, w, t, lse, tgt, N, V, D, stream);
}

extern "C" int fused_ce_dx(const void* x, const void* w, const void* t,
                           const void* lse, void* dx, int N, int V, int D,
                           void* stream) {
  return dispatch(Which::kDx, x, w, t, const_cast<void*>(lse), dx, N, V, D,
                  stream);
}

extern "C" int fused_ce_dw(const void* x, const void* w, const void* t,
                           const void* lse, void* dw, int N, int V, int D,
                           void* stream) {
  return dispatch(Which::kDw, x, w, t, const_cast<void*>(lse), dw, N, V, D,
                  stream);
}

// The dx kernel's registers, spill bytes, static and dynamic shared bytes
// and resident blocks per SM at width D, then the dW kernel's.
extern "C" int fused_ce_resources(int D, int* out) {
  return width_dispatch(D, [&](auto d) {
    return bwd_resources<decltype(d)::value>(out);
  });
}

// The forward kernel's registers, spill bytes, static and dynamic shared
// bytes and resident blocks per SM at width D, then its cluster size and
// the clusters the card holds at once: seven ints.
extern "C" int fused_ce_fwd_resources(int D, int* out) {
  return width_dispatch(D, [&](auto d) {
    return fwd_resources<decltype(d)::value>(out);
  });
}
