// Splash attention backward for Hopper (sm_90a): dq, dk, dv in bf16 from
// q, k, v, o, do (bf16) and the forward's natural-log lse (fp32).
//
// Replaces: the fused dq/dk/dv backward of ray_tpu/ops/attention.py:
// splash_attention (the Pallas splash kernel built by _splash_kernel with
// use_fused_bwd_kernel=True, :56-62), and with it the dkv and dq backward
// kernels of ray_tpu/ops/attention.py:flash_attention, which differentiate
// the same function.
//
//   s = q k^T * scale + mask,  p = exp(s - lse),  delta = rowsum(o * do)
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - delta)
//   dq = scale * ds k,  dk = scale * ds^T q
//
// What bounds it on an H100: operations. At the training shape (B=16,
// S=1024, 12 heads, hd=64, causal) the function needs 10 * hd flops for each
// kept (query, key) pair (the score recompute and the dv, dp, dq, dk
// products), 6.5e10 flops (0.065 ms at 989 TFLOP/s), against ~2e8 bytes of
// q, k, v, o, do, dq, dk, dv, lse and delta (0.06 ms at 3.35 TB/s).
//
// What the design does about it, and what it costs:
// - Determinism first. The TPU kernel carries the dq sum along its
//   sequential grid; Hopper runs blocks in no order, and a dq summed with
//   fp32 atomics would change its bits from run to run (remat_policy="full"
//   must give the gradients of "attn_outside" bit for bit). So the work is
//   split into three launches that own every row they write:
//   (a) delta = rowsum(o * do) in fp32, (B, H, S); skipped when the caller
//       passes its own delta;
//   (b) dk, dv: one block per (64-row KV tile, batch * head) walks the query
//       tiles from the causal diagonal on, recomputing s^T = k q^T and
//       dp^T = v do^T, with dk and dv in registers;
//   (c) dq: one block per (64-row query tile, batch * head) walks the KV
//       tiles up to the diagonal, recomputing s and dp, with dq in
//       registers; blocks are issued longest-first.
//   The price is the second s and dp: 14 * hd flops per pair, not 10 * hd.
//   At (16, 1024, 12, 64) causal each launch walks 26,112 tile pairs (the
//   diagonal tiles whole), 9.6e10 flops: 0.097 ms on the tensor cores at
//   their peak, the floor of this design. Each pair also takes two
//   exponentials (one per launch), 2.1e8, ~0.055 ms on the SFUs.
// - Neither s, p nor ds reaches device memory: one warpgroup (four warps,
//   128 threads) owns its block's 64 rows, and every product is a wgmma
//   whose A operand is a K-major tile in shared memory or an accumulator
//   already in the register A layout:
//     dk/dv: s^T = k q^T and dp^T = v do^T, m64n64k16 with both operands
//            K-major; dv += p^T do and dk += ds^T q, m64n{hd}k16 with p^T
//            and ds^T packed from the accumulators to bf16 and do, q read
//            MN-major from their row-major tiles;
//     dq:    s = q k^T and dp = do v^T (both K-major); dq += ds k (k read
//            MN-major).
//   No product re-reads a tile through ldmatrix, and none needs a staged
//   transpose.
// - Loads: one thread has the TMA copy each tile by tensor map: q, k, v and
//   do are each a 4D map {hd, H, S, B} over the caller's strides (the views
//   split from the fused qkv need no copy), boxes of 64 rows by 64 columns
//   landing 128-byte swizzled; rows past S arrive as zeros. A block's own
//   two tiles (K and V, or Q and dO) load once; the two it walks over go
//   through rings of kStages buffers, one mbarrier per buffer, a buffer
//   refilled by one thread once every thread has waited for the products
//   that read it. The dk/dv block keeps the walked query tile's 64 lse
//   values (base 2) and 64 delta values in shared memory beside its Q
//   buffer, by plain loads issued one tile ahead.
// - Each tile's products are waited for within the tile: the scores and dp
//   as two groups, the exponentials running while v do^T (do v^T) is still
//   on the tensor cores, then the gradient products as one group. The
//   dk/dv kernel holds dk, dv, s^T and dp^T in registers: 168 at hd=64, 3
//   blocks per SM (dq 122, 4 blocks), 237 at hd=128 (dq 176), no spills.
//   Starting dv's product before ds is computed took 171 and a block per
//   SM, and was slower (PERF.md, PR 7).
//
// Numerics: the forward's lse is natural-log; the kernels work in base 2
// (exp2 of s * scale * log2(e) - lse * log2(e)). A masked (query, key) pair
// gets p = 0 by assignment, never by exp of the mask value, so no inf or NaN
// can leak from a masked score or from a row past S. The port scales the
// fp32 scores, where JAX scales q in bf16 before the kernel, so dq and dk
// carry the scale explicitly.
//
// Not yet done (later work): warp specialisation (a producer warp for the
// TMA, two consumer warpgroups with setmaxnreg) and persistent blocks; the
// next tile's scores issued under this tile's gradient products; delta
// computed inside a pass that already reads do; a TMA store of dq, dk, dv.
//
// Inputs may be strided views (q, k, v split from the fused qkv have a row
// stride of 3*D): every row of hd elements must be contiguous and every
// stride and the base 16-byte aligned, which the Python wrapper checks.
// Rows past S are read as zeros and never written. The ring backward keeps
// the mma.sync bodies of attention_bwd.cuh (ring_attention_bwd.cu).

#include "wgmma_sm90.cuh"

namespace {

constexpr int kBlock = 64;     // rows of a query tile and of a KV tile
constexpr int kThreads = 128;  // one warpgroup: four warps, 16 rows each
constexpr int kStages = 2;     // buffers of each walked tile's ring
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlock == kBoxRows, "a tile is one box of rows");

// delta[b, h, s] = sum_d o[b, s, h, d] * do[b, s, h, d], fp32. HD/8
// neighbouring threads share a row, 16 bytes each.
template <int HD>
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout,
                           float* __restrict__ delta, int B, int S, int H,
                           long long o_sb, long long o_ss, long long o_sh,
                           long long d_sb, long long d_ss, long long d_sh) {
  constexpr int kPer = HD / 8;  // threads per row
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / kPer;
  const int c = (int)(idx % kPer) * 8;
  const long long n_rows = (long long)B * S * H;
  const int h = (int)(row % H);
  const int s = (int)((row / H) % S);
  const int b = (int)(row / ((long long)H * S));
  float acc = 0.f;
  if (row < n_rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * o_sb + s * o_ss + h * o_sh + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * d_sb + s * d_ss + h * d_sh + c);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(op[i]);
      const float2 y = __bfloat1622float2(dp[i]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && c == 0) delta[((long long)b * H + h) * S + s] = acc;
}

// Shared memory of a block, from a 1024-byte-aligned base (the swizzle
// atom; kBytes adds the slack to reach it): the block's own two tiles (K
// and V for dk/dv, Q and dO for dq), the two rings of walked tiles (Q and
// dO, or K and V), kStages buffers each, the lse and delta rows of each
// walked query tile (dk/dv only), and the mbarriers: one per own tile, then
// one per buffer of each ring. 51,248 bytes at hd=64, 100,400 at hd=128.
template <int HD>
struct BwdLayout {
  static constexpr int kTile = HD / kBoxCols * kBoxBytes;
  static constexpr int kOwnA = 0;
  static constexpr int kOwnB = kTile;
  static constexpr int kRingA = 2 * kTile;
  static constexpr int kRingB = kRingA + kStages * kTile;
  static constexpr int kLse = kRingB + kStages * kTile;
  static constexpr int kDelta = kLse + kStages * kBlock * 4;
  static constexpr int kBars = kDelta + kStages * kBlock * 4;
  static constexpr int kBytes = kBars + (2 + 2 * kStages) * 8 + 1024;
};

// The block's 1024-byte-aligned shared base, as an address and a pointer.
struct SmemBase {
  uint32_t addr;
  unsigned char* ptr;
};
__device__ __forceinline__ SmemBase smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  return {base, smem_raw + (base - raw)};
}

// Descriptors of a tile at shared address addr: read K-major (the product
// contracts over its hd columns) or MN-major (over its 64 rows).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, kBoxBytes, 1024);
}

// d = a b^T over hd, started: a and b 64-row tiles read K-major, hd / 16
// k-steps.
template <int HD>
__device__ __forceinline__ void ss_product(float (&d)[32], uint64_t a,
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_64x64x16_ss(d, kmajor_step(a, kk), kmajor_step(b, kk), kk > 0);
}

// acc += x b, started: x (64 x 64) from registers, packed into the A
// operands of its four 16-column k-steps; b a 64-row tile read MN-major,
// 16 rows (2 KB of each box) per k-step.
template <int HD>
__device__ __forceinline__ void rs_product(float (&acc)[HD / 2],
                                           const uint32_t (&x)[4][4],
                                           uint64_t b) {
#pragma unroll
  for (int kt = 0; kt < kBlock / 16; ++kt)
    wgmma_rs<HD>(acc, x[kt], desc_at(b, kt * 16 * kBoxCols * 2));
}

// The accumulator chunks 2kt and 2kt + 1 are the A operand of k-step kt.
__device__ __forceinline__ void pack_a(uint32_t (&x)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kt = 0; kt < kBlock / 16; ++kt) {
    x[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
    x[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
    x[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
    x[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
  }
}

// Writes this thread's share of a 64-row accumulator (the wgmma layout:
// rows row_a and row_a + 8, columns 8d + 2t and 8d + 2t + 1), times
// `scale`, as bf16 rows of batch b, head h of a contiguous (B, S, H, HD)
// tensor. Rows at or past S are skipped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[HD / 2], int b,
                                           int h, int S, int H, int row_a,
                                           float scale) {
  const int t = threadIdx.x % 4;
  const long long ss = (long long)H * HD;
  const int row_b = row_a + 8;
  __nv_bfloat16* p = out + (long long)b * S * ss + (long long)h * HD + 2 * t;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(p + row_a * ss + d * 8) =
          pack_bf16(acc[4 * d] * scale, acc[4 * d + 1] * scale);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(p + row_b * ss + d * 8) =
          pack_bf16(acc[4 * d + 2] * scale, acc[4 * d + 3] * scale);
  }
}

// dk, dv of KV tile blockIdx.x of (batch, head) blockIdx.y. Causal: KV tile
// 0 walks every query tile, and blocks go out in index order. lse, delta:
// fp32 (B, H, S); dk, dv: bf16 contiguous (B, S, H, HD).
template <int HD>
__global__ void __launch_bounds__(kThreads)
splash_attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int S, int H,
                                float scale_log2, float scale, int causal) {
  using L = BwdLayout<HD>;
  const SmemBase sm = smem_base();
  const uint32_t base = sm.addr;
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(sm.ptr + L::kBars);
  uint64_t* q_bar = own_bar + 2;
  uint64_t* do_bar = q_bar + kStages;
  float* lse_s = reinterpret_cast<float*>(sm.ptr + L::kLse);
  float* delta_s = reinterpret_cast<float*>(sm.ptr + L::kDelta);

  const int kv_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = kv_tile * kBlock;
  const int n_q = (S + kBlock - 1) / kBlock;
  const int q_begin = causal ? kv_tile : 0;
  const int n_iter = n_q - q_begin;  // query tiles this block walks

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group of a fragment
  const int t = lane % 4;  // column pair within a fragment
  const int kvr_a = kv0 + warp * 16 + g;  // this thread's two key rows
  const int kvr_b = kvr_a + 8;

  // Walked tile n is query tile q_begin + n, in buffer n % kStages. Thread
  // r < 64 stages row r of its lse (base 2), thread 64 + r row r of its
  // delta; rows past S hold 0.
  const int stage_r = threadIdx.x % kBlock;
  float* stage_dst = (threadIdx.x < kBlock ? lse_s : delta_s) + stage_r;
  const float* stage_src =
      (threadIdx.x < kBlock ? lse : delta) + (long long)bh * S;
  const float stage_mul = threadIdx.x < kBlock ? kLog2e : 1.f;
  auto stage_row = [&](int n) {
    const int r = (q_begin + n) * kBlock + stage_r;
    return r < S ? stage_src[r] * stage_mul : 0.f;
  };
  const CUtensorMap* qmap = &q_map;
  const CUtensorMap* domap = &do_map;
  auto load_walked = [&](int n) {
    const int buf = n % kStages;
    const int q0 = (q_begin + n) * kBlock;
    load_bf16_tile<HD>(base + L::kRingA + buf * L::kTile, qmap, h, q0, b,
                       q_bar + buf);
    load_bf16_tile<HD>(base + L::kRingB + buf * L::kTile, domap, h, q0, b,
                       do_bar + buf);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + 2 * kStages; ++i) mbar_init(own_bar + i, 1);
    fence_mbar_init();
    load_bf16_tile<HD>(base + L::kOwnA, &k_map, h, kv0, b, own_bar);
    load_bf16_tile<HD>(base + L::kOwnB, &v_map, h, kv0, b, own_bar + 1);
    for (int n = 0; n < kStages && n < n_iter; ++n) load_walked(n);
  }
  for (int n = 0; n < kStages && n < n_iter; ++n)
    stage_dst[n * kBlock] = stage_row(n);
  __syncthreads();

  const uint64_t k_desc = kmajor_desc(base + L::kOwnA);
  const uint64_t v_desc = kmajor_desc(base + L::kOwnB);

  float acc_dk[HD / 2], acc_dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  float st[32], dpt[32];  // s^T (then p^T) and dp^T (then ds^T)

  mbar_wait(own_bar, 0);
  mbar_wait(own_bar + 1, 0);
  for (int n = 0; n < n_iter; ++n) {
    const int buf = n % kStages;
    const int q0 = (q_begin + n) * kBlock;
    const uint32_t q_tile = base + L::kRingA + buf * L::kTile;
    const uint32_t do_tile = base + L::kRingB + buf * L::kTile;
    const bool refill = n + kStages < n_iter;
    // The lse or delta row of the tile this buffer takes next, loaded now
    // and staged once every thread is done with the buffer.
    const float staged = refill ? stage_row(n + kStages) : 0.f;

    // s^T = k q^T and dp^T = v do^T, two groups.
    mbar_wait(q_bar + buf, (n / kStages) & 1);
    mbar_wait(do_bar + buf, (n / kStages) & 1);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    ss_product<HD>(st, k_desc, kmajor_desc(q_tile));
    wgmma_commit();
    ss_product<HD>(dpt, v_desc, kmajor_desc(do_tile));
    wgmma_commit();

    // p^T = exp2(s^T * scale_log2 - lse) while v do^T runs; masked pairs
    // (and rows past S) get 0 by assignment.
    wgmma_wait<1>();
    fence_regs(st);
    const bool edge = (q0 + kBlock > S) || (kv0 + kBlock > S) ||
                      (causal && q_begin + n == kv_tile);
    const float* lseb = lse_s + buf * kBlock;
    const float* deltab = delta_s + buf * kBlock;
#pragma unroll
    for (int c = 0; c < kBlock / 8; ++c) {
      const float2 l = *reinterpret_cast<const float2*>(lseb + 8 * c + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[4 * c + e] * scale_log2 - ((e & 1) ? l.y : l.x));
        if (edge) {
          const int qi = q0 + 8 * c + 2 * t + (e & 1);
          const int row = e < 2 ? kvr_a : kvr_b;
          if (qi >= S || row >= S || (causal && row > qi)) p = 0.f;
        }
        st[4 * c + e] = p;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    pack_a(pa, st);

    // ds^T = p^T (dp^T - delta).
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int c = 0; c < kBlock / 8; ++c) {
      const float2 d = *reinterpret_cast<const float2*>(deltab + 8 * c + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * c + e] = st[4 * c + e] * (dpt[4 * c + e] - ((e & 1) ? d.y : d.x));
    }
    pack_a(dsa, dpt);

    // dv += p^T do and dk += ds^T q (scaled at the end), one group.
    fence_regs(acc_dv);
    fence_regs(acc_dk);
#pragma unroll
    for (int kt = 0; kt < kBlock / 16; ++kt) {
      fence_regs(pa[kt]);
      fence_regs(dsa[kt]);
    }
    wgmma_fence();
    rs_product<HD>(acc_dv, pa, mnmajor_desc(do_tile));
    rs_product<HD>(acc_dk, dsa, mnmajor_desc(q_tile));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);

    // Every thread is done with buffer buf: it takes walked tile
    // n + kStages. The barrier stands after every tile but the last, so
    // that a staged row is visible before its tile is read.
    if (n + 1 < n_iter) {
      __syncthreads();
      if (refill) {
        if (threadIdx.x == 0) load_walked(n + kStages);
        stage_dst[buf * kBlock] = staged;
      }
    }
  }

  store_rows<HD>(dk, acc_dk, b, h, S, H, kvr_a, scale);
  store_rows<HD>(dv, acc_dv, b, h, S, H, kvr_a, 1.f);
}

// dq of query tile gridDim.x - 1 - blockIdx.x (longest first) of (batch,
// head) blockIdx.y. dq: bf16 contiguous (B, S, H, HD).
template <int HD>
__global__ void __launch_bounds__(kThreads)
splash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dq, int S, int H,
                               float scale_log2, float scale, int causal) {
  using L = BwdLayout<HD>;
  const SmemBase sm = smem_base();
  const uint32_t base = sm.addr;
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(sm.ptr + L::kBars);
  uint64_t* k_bar = own_bar + 2;
  uint64_t* v_bar = k_bar + kStages;

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = q_tile * kBlock;
  const int n_kv = (S + kBlock - 1) / kBlock;
  const int kv_end = causal ? min(n_kv, q_tile + 1) : n_kv;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;

  // KV tile n in buffer n % kStages.
  const CUtensorMap* kmap = &k_map;
  const CUtensorMap* vmap = &v_map;
  auto load_kv = [&](int n) {
    const int buf = n % kStages;
    load_bf16_tile<HD>(base + L::kRingA + buf * L::kTile, kmap, h,
                       n * kBlock, b, k_bar + buf);
    load_bf16_tile<HD>(base + L::kRingB + buf * L::kTile, vmap, h,
                       n * kBlock, b, v_bar + buf);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + 2 * kStages; ++i) mbar_init(own_bar + i, 1);
    fence_mbar_init();
    load_bf16_tile<HD>(base + L::kOwnA, &q_map, h, q0, b, own_bar);
    load_bf16_tile<HD>(base + L::kOwnB, &do_map, h, q0, b, own_bar + 1);
    for (int n = 0; n < kStages && n < kv_end; ++n) load_kv(n);
  }
  __syncthreads();

  const float* lse_p = lse + (long long)bh * S;
  const float* delta_p = delta + (long long)bh * S;
  const float lse_a = row_a < S ? lse_p[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < S ? lse_p[row_b] * kLog2e : 0.f;
  const float delta_a = row_a < S ? delta_p[row_a] : 0.f;
  const float delta_b = row_b < S ? delta_p[row_b] : 0.f;
  const uint64_t q_desc = kmajor_desc(base + L::kOwnA);
  const uint64_t do_desc = kmajor_desc(base + L::kOwnB);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];  // s (then p) and dp (then ds)

  mbar_wait(own_bar, 0);
  mbar_wait(own_bar + 1, 0);
  for (int j = 0; j < kv_end; ++j) {
    const int buf = j % kStages;
    const uint32_t k_tile = base + L::kRingA + buf * L::kTile;
    const uint32_t v_tile = base + L::kRingB + buf * L::kTile;

    // s = q k^T and dp = do v^T, two groups.
    mbar_wait(k_bar + buf, (j / kStages) & 1);
    mbar_wait(v_bar + buf, (j / kStages) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    ss_product<HD>(s, q_desc, kmajor_desc(k_tile));
    wgmma_commit();
    ss_product<HD>(dp, do_desc, kmajor_desc(v_tile));
    wgmma_commit();

    // p = exp2(s * scale_log2 - lse) while do v^T runs.
    wgmma_wait<1>();
    fence_regs(s);
    const int kv0 = j * kBlock;
    const bool edge = (kv0 + kBlock > S) || (q0 + kBlock > S) ||
                      (causal && j == q_tile);
#pragma unroll
    for (int c = 0; c < kBlock / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        float p = exp2f(s[4 * c + e] * scale_log2 - (e < 2 ? lse_a : lse_b));
        if (edge) {
          const int col = kv0 + 8 * c + 2 * t + (e & 1);
          if (col >= S || row >= S || (causal && col > row)) p = 0.f;
        }
        s[4 * c + e] = p;
      }
    }

    // ds = p (dp - delta).
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < kBlock / 8; ++c) {
      dp[4 * c] = s[4 * c] * (dp[4 * c] - delta_a);
      dp[4 * c + 1] = s[4 * c + 1] * (dp[4 * c + 1] - delta_a);
      dp[4 * c + 2] = s[4 * c + 2] * (dp[4 * c + 2] - delta_b);
      dp[4 * c + 3] = s[4 * c + 3] * (dp[4 * c + 3] - delta_b);
    }
    uint32_t dsa[4][4];
    pack_a(dsa, dp);

    // dq += ds k (scaled at the end).
    fence_regs(acc);
#pragma unroll
    for (int kt = 0; kt < kBlock / 16; ++kt) fence_regs(dsa[kt]);
    wgmma_fence();
    rs_product<HD>(acc, dsa, mnmajor_desc(k_tile));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // Every thread is done with buffer buf: it takes KV tile j + kStages.
    if (j + kStages < kv_end) {
      __syncthreads();
      if (threadIdx.x == 0) load_kv(j + kStages);
    }
  }

  store_rows<HD>(dq, acc, b, h, S, H, row_a, scale);
}

// Returns go(std::integral_constant<int, HD>{}) for head_dim 64 or 128,
// cudaErrorInvalidValue for another.
template <typename Go>
int bwd_dispatch(int head_dim, Go go) {
  if (head_dim == 64) return go(std::integral_constant<int, 64>{});
  if (head_dim == 128) return go(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry, bound with ctypes. Strides are in elements; dq, dk, dv are
// written contiguous (B, S, H, hd); lse and delta are contiguous (B, H, S)
// fp32. With compute_delta the kernel writes delta = rowsum(o * do) first;
// otherwise it reads the caller's delta (and never reads o). Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported head dimension or grid, or inputs the tensor maps do not
// take).
extern "C" int splash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long d_sb,
    long long d_ss, long long d_sh, float scale, int causal,
    int compute_delta, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  return bwd_dispatch(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    constexpr int kSmem = BwdLayout<HD>::kBytes;
    static bool allowed_dkv[64] = {};
    static bool allowed_dq[64] = {};
    cudaError_t err = allow_smem(splash_attention_bwd_dkv_kernel<HD>, kSmem,
                                 allowed_dkv);
    if (err == cudaSuccess)
      err = allow_smem(splash_attention_bwd_dq_kernel<HD>, kSmem, allowed_dq);
    CUtensorMap q_map, k_map, v_map, do_map;
    if (err == cudaSuccess)
      err = encode_bf16_tile_map(&q_map, q, B, S, H, HD, q_sb, q_ss, q_sh);
    if (err == cudaSuccess)
      err = encode_bf16_tile_map(&k_map, k, B, S, H, HD, k_sb, k_ss, k_sh);
    if (err == cudaSuccess)
      err = encode_bf16_tile_map(&v_map, v, B, S, H, HD, v_sb, v_ss, v_sh);
    if (err == cudaSuccess)
      err = encode_bf16_tile_map(&do_map, dout, B, S, H, HD, d_sb, d_ss, d_sh);
    if (err != cudaSuccess) return (int)err;
    float* deltap = static_cast<float*>(delta);
    if (compute_delta) {
      const long long threads = (long long)B * S * H * (HD / 8);
      const unsigned blocks = (unsigned)((threads + 255) / 256);
      attention_bwd_delta_kernel<HD><<<blocks, 256, 0, st>>>(
          static_cast<const bf16*>(o), static_cast<const bf16*>(dout), deltap,
          B, S, H, o_sb, o_ss, o_sh, d_sb, d_ss, d_sh);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((S + kBlock - 1) / kBlock, B * H);
    const float* lsep = static_cast<const float*>(lse);
    const float scale_log2 = scale * kLog2e;
    splash_attention_bwd_dkv_kernel<HD><<<grid, kThreads, kSmem, st>>>(
        q_map, k_map, v_map, do_map, lsep, deltap, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, H, scale_log2, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    splash_attention_bwd_dq_kernel<HD><<<grid, kThreads, kSmem, st>>>(
        q_map, k_map, v_map, do_map, lsep, deltap, static_cast<bf16*>(dq), S,
        H, scale_log2, scale, causal);
    return (int)cudaGetLastError();
  });
}

// What the two main kernels hold on an SM (kernel_resources in
// mma_sm90.cuh: registers, spill bytes, static and dynamic shared bytes,
// resident blocks), the dk/dv kernel's five numbers then the dq kernel's,
// at head_dim.
extern "C" int splash_attention_bwd_resources(int head_dim, int* out) {
  return bwd_dispatch(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    constexpr int kSmem = BwdLayout<HD>::kBytes;
    cudaError_t err = kernel_resources(splash_attention_bwd_dkv_kernel<HD>,
                                       kThreads, kSmem, out);
    if (err != cudaSuccess) return (int)err;
    return (int)kernel_resources(splash_attention_bwd_dq_kernel<HD>, kThreads,
                                 kSmem, out + 5);
  });
}
