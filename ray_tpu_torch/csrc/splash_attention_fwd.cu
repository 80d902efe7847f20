// Splash attention forward for Hopper (sm_90a), bf16 in and out, fp32 lse.
//
// Replaces: ray_tpu/ops/attention.py:splash_attention (the forward of the
// Pallas splash kernel built in _splash_kernel), and with it
// ray_tpu/ops/attention.py:flash_attention, which computes the same function.
//
//   o   = softmax(q k^T * scale + mask) v          (B, S, H, hd), bf16
//   lse = logsumexp(q k^T * scale + mask)           (B, H, S), fp32, natural log
//
// The mask is causal or full. Masked scores take a finite value (the splash
// mask's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX), so no exp(-inf - -inf) can make
// a NaN.
//
// What bounds it on an H100: memory, with the exponentials close behind. At
// the serving and training shapes (S=1024, 12 heads, hd=64) the causal half
// of q k^T and p v is ~64 flops per byte of q, k, v and o, well below the
// ~295 flops per byte where the tensor cores become the limit, so the least
// time is reading q, k, v once and writing o once. But each kept (query,
// key) pair also costs one exponential against 4 * hd = 256 flops: at
// (16, 1024, 12, 64) causal, ~1.0e8 exponentials take ~0.026 ms on the
// SFUs (~3.9e12 a second) and the 2.6e10 flops ~0.026 ms on the tensor
// cores, so a block that ran the two one after the other could not go
// below ~0.05 ms.
//
// What the design does about it: one warpgroup (four warps) owns a 64-row
// query tile of one (batch, head) and walks the 64-row K and V tiles,
// keeping the scores, the running max and the running sum in registers
// (flash attention's online softmax): the (S, S) scores never reach device
// memory, so q, k, v and o are the only traffic, with K and V re-read once
// per query tile from L2. A causal block stops at the diagonal tile; blocks
// are issued longest-first.
// - Loads: one thread has the TMA copy each tile by tensor map: q, k and v
//   are each a 4D map {hd, H, S, B} over the caller's strides, so the views
//   split from the fused qkv need no copy. Boxes of 64 rows by 64 columns
//   land 128-byte swizzled, the layout wgmma reads without bank conflicts;
//   rows past S arrive as zeros. The Q tile loads once; K and V go through
//   rings of kKStages and kVStages buffers, each buffer with its own
//   mbarrier. A buffer is refilled once every thread has waited for the
//   product that read it, after a barrier.
// - Products: s = q k^T is wgmma m64n64k16 with Q and K read K-major from
//   shared memory, hd / 16 instructions in one group. o += p v is
//   m64n{hd}k16 with p from registers (the score accumulator's layout is
//   the register A operand's, so p only needs packing to bf16) and V read
//   MN-major from its row-major tile.
// - Overlap: the q k^T of tile j + 1 is issued, into a second set of score
//   registers, before the softmax of tile j, whose exponentials then run
//   while the tensor cores work on the next scores (FlashAttention-3's
//   intra-warpgroup pipelining). The output is rescaled once those scores
//   have landed and p v of tile j is waited for within the tile: ptxas
//   serialises every wgmma of a kernel in which another instruction
//   defines an accumulator inside a wgmma's pipeline stage. The second
//   score set costs registers: 134 at hd=64 (3 blocks per SM), where
//   products waited for at once took 90 (4 blocks) and were faster at
//   (16, 1024) and slower at (1, 1024) (PERF.md, PR 6).
//
// Not yet done (later work): warp specialisation and persistent blocks, a
// TMA store of o, and a split over KV for small batches (at B=1 the longest
// causal block walks all S/64 KV tiles in series).
//
// Inputs may be strided views (q, k, v split from the fused qkv projection
// have a row stride of 3*D): every row of hd elements must be contiguous and
// every stride and the base 16-byte aligned, which the Python wrapper
// checks. Rows past S are read as zeros and never written.

#include <type_traits>

#include "attention_fwd.cuh"  // kBlockQ, kBlockKV, kThreads, kMaskValue, kLn2
#include "wgmma_sm90.cuh"

namespace {

// Buffers of the K and the V ring. KV tile n's K and V are both requested
// at the end of tile n - 3: K for the q k^T that tile n - 1 issues, V for
// tile n's p v.
constexpr int kKStages = 2;
constexpr int kVStages = 3;

// Shared memory of a block, from a 1024-byte-aligned base (the swizzle
// atom; kBytes adds the slack to reach it): the Q tile, the K and V rings,
// and the mbarriers (Q, then one per K and per V buffer). 50,224 bytes at
// hd=64, 99,376 at hd=128.
template <int HD>
struct FwdLayout {
  static constexpr int kTile = HD / kBoxCols * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kKStages * kTile;
  static constexpr int kBars = kV + kVStages * kTile;
  static constexpr int kBytes =
      kBars + (1 + kKStages + kVStages) * 8 + 1024;
};

// s = q k^T of one KV tile, started: hd / 16 k-steps in one group.
template <int HD>
__device__ __forceinline__ void qk_product(float (&s)[32], uint64_t q_desc,
                                           uint64_t k_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_64x64x16_ss(s, kmajor_step(q_desc, kk), kmajor_step(k_desc, kk),
                      kk > 0);
  wgmma_commit();
}

// acc += p v of one KV tile, started: p's four 16-key k-steps, each over
// 16 rows (2 KB) of the V tile.
template <int HD>
__device__ __forceinline__ void pv_product(float (&acc)[HD / 2],
                                           uint32_t (&p)[4][4],
                                           uint64_t v_desc) {
  fence_regs(acc);  // the rescale and the packing of p come before
#pragma unroll
  for (int kt = 0; kt < kBlockKV / 16; ++kt) fence_regs(p[kt]);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < kBlockKV / 16; ++kt)
    wgmma_rs<HD>(acc, p[kt], desc_at(v_desc, kt * 16 * kBoxCols * 2));
  wgmma_commit();
}

// One KV tile's online softmax for this thread's rows row_a and row_b:
// scales the scores into base-2 units, masks them where `edge`, updates the
// running maxima and this thread's share of the row sums, and turns s into
// unnormalised probabilities. alpha_*: the factors by which the output
// accumulated so far is to be rescaled.
__device__ __forceinline__ void online_softmax(
    float (&s)[32], int kv0, int row_a, int row_b, int S, int causal,
    bool edge, float scale_log2, float& m_a, float& m_b, float& l_a,
    float& l_b, float& alpha_a, float& alpha_b) {
  const int t = threadIdx.x % 4;
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int n = 0; n < kBlockKV / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e] * scale_log2;
      if (edge) {
        const int col = kv0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        if (col >= S || (causal && col > row)) x = kMaskValue;
      }
      s[4 * n + e] = x;
    }
    mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  alpha_a = exp2f(m_a - mx_a);
  alpha_b = exp2f(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  l_a *= alpha_a;
  l_b *= alpha_b;
#pragma unroll
  for (int n = 0; n < kBlockKV / 8; ++n) {
    s[4 * n] = exp2f(s[4 * n] - m_a);
    s[4 * n + 1] = exp2f(s[4 * n + 1] - m_a);
    s[4 * n + 2] = exp2f(s[4 * n + 2] - m_b);
    s[4 * n + 3] = exp2f(s[4 * n + 3] - m_b);
    l_a += s[4 * n] + s[4 * n + 1];
    l_b += s[4 * n + 2] + s[4 * n + 3];
  }
}

// The block: query tile gridDim.x - 1 - blockIdx.x (longest first) of
// (batch, head) blockIdx.y. o: bf16 contiguous (B, S, H, HD); lse: fp32
// (B, H, S).
template <int HD>
__global__ void __launch_bounds__(kThreads)
splash_attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int S, int H,
                            float scale_log2, int causal) {
  using L = FwdLayout<HD>;
  constexpr int NT_O = HD / 8;  // 8-column chunks of an output row block

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint64_t* q_bar =
      reinterpret_cast<uint64_t*>(smem_raw + (base - raw) + L::kBars);
  uint64_t* k_bar = q_bar + 1;
  uint64_t* v_bar = k_bar + kKStages;

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = q_tile * kBlockQ;
  const int n_kv = (S + kBlockKV - 1) / kBlockKV;
  const int kv_end = causal ? min(n_kv, q_tile + 1) : n_kv;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group of a fragment
  const int t = lane % 4;  // column pair within a fragment
  // This thread's two query rows.
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  const CUtensorMap* kmap = &k_map;
  const CUtensorMap* vmap = &v_map;
  // Buffers of KV tile n: K in n % kKStages, V in n % kVStages.
  auto load_k = [&](int n) {
    load_bf16_tile<HD>(base + L::kK + (n % kKStages) * L::kTile, kmap, h,
                       n * kBlockKV, b, k_bar + n % kKStages);
  };
  auto load_v = [&](int n) {
    load_bf16_tile<HD>(base + L::kV + (n % kVStages) * L::kTile, vmap, h,
                       n * kBlockKV, b, v_bar + n % kVStages);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < kKStages + kVStages; ++i) mbar_init(k_bar + i, 1);
    fence_mbar_init();
    load_bf16_tile<HD>(base + L::kQ, &q_map, h, q0, b, q_bar);
    for (int j = 0; j < kKStages && j < kv_end; ++j) load_k(j);
    for (int j = 0; j < kVStages && j < kv_end; ++j) load_v(j);
  }
  __syncthreads();

  const uint64_t q_desc = sw128_desc(base + L::kQ, 16, 1024);
  auto k_desc = [&](int n) {
    return sw128_desc(base + L::kK + (n % kKStages) * L::kTile, 16, 1024);
  };
  auto v_desc = [&](int n) {
    return sw128_desc(base + L::kV + (n % kVStages) * L::kTile, kBoxBytes,
                      1024);
  };

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_a = kMaskValue, m_b = kMaskValue;  // running max, base-2 units
  float l_a = 0.f, l_b = 0.f;                // this thread's share of the sum
  float s0[32], s1[32];  // the scores of even and of odd tiles

  // Tile 0's scores before the loop; its K buffer then takes the tile
  // kKStages ahead.
  mbar_wait(q_bar, 0);
  mbar_wait(k_bar, 0);
  qk_product<HD>(s0, q_desc, k_desc(0));
  wgmma_wait<0>();
  fence_regs(s0);
  if (kKStages < kv_end) {
    __syncthreads();
    if (threadIdx.x == 0) load_k(kKStages);
  }

  // Tile j, its scores in s0 or s1 by the parity of j; tile j + 1's land
  // in the other set. has_next (whether tile j + 1 exists) and the parity
  // are types, so that each instantiation issues and retires the same
  // wgmma groups on every path and has one call site (ptxas serialises
  // wgmma whose retirement it cannot follow). Every group is retired
  // within its tile: a p v left running into the next tile's softmax made
  // ptxas serialise all of them.
  auto tile = [&](int j, auto has_next, auto odd) {
    constexpr bool next = decltype(has_next)::value;
    float(&s)[32] = decltype(odd)::value ? s1 : s0;
    float(&s_next)[32] = decltype(odd)::value ? s0 : s1;
    if constexpr (next) {
      mbar_wait(k_bar + (j + 1) % kKStages, ((j + 1) / kKStages) & 1);
      qk_product<HD>(s_next, q_desc, k_desc(j + 1));
    }

    const int kv0 = j * kBlockKV;
    const bool edge = (kv0 + kBlockKV > S) || (causal && j == q_tile);
    float alpha_a, alpha_b;
    online_softmax(s, kv0, row_a, row_b, S, causal, edge, scale_log2, m_a,
                   m_b, l_a, l_b, alpha_a, alpha_b);

    if constexpr (next) {
      // The q k^T of tile j + 1 has finished: the output is rescaled while
      // no wgmma runs (ptxas serialises wgmma around other instructions
      // that define an accumulator inside a wgmma's pipeline stage).
      wgmma_wait<0>();
      fence_regs(s_next);
    }
#pragma unroll
    for (int d = 0; d < NT_O; ++d) {
      acc[4 * d] *= alpha_a;
      acc[4 * d + 1] *= alpha_a;
      acc[4 * d + 2] *= alpha_b;
      acc[4 * d + 3] *= alpha_b;
    }
    // The score chunks 2kt and 2kt + 1 are the A operand of k-step kt.
    uint32_t p[4][4];
#pragma unroll
    for (int kt = 0; kt < kBlockKV / 16; ++kt) {
      p[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
      p[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      p[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      p[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
    mbar_wait(v_bar + j % kVStages, (j / kVStages) & 1);
    pv_product<HD>(acc, p, v_desc(j));

    // Buffers every thread is done with take the tiles kKStages and
    // kVStages ahead: tile j + 1's K (its q k^T has run) and tile j's V.
    wgmma_wait<0>();
    fence_regs(acc);
    const int tk = j + 1 + kKStages;
    const int tv = j + kVStages;
    if (tk < kv_end || tv < kv_end) {
      __syncthreads();
      if (threadIdx.x == 0) {
        if (tk < kv_end) load_k(tk);
        if (tv < kv_end) load_v(tv);
      }
    }
  };
  using Yes = std::true_type;
  using No = std::false_type;
  for (int j = 0;; j += 2) {
    if (j + 1 == kv_end) {
      tile(j, No{}, No{});
      break;
    }
    tile(j, Yes{}, No{});
    if (j + 2 == kv_end) {
      tile(j + 1, No{}, Yes{});
      break;
    }
    tile(j + 1, Yes{}, Yes{});
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const long long o_ss = (long long)H * HD;
  __nv_bfloat16* op = o + (long long)b * S * o_ss + (long long)h * HD + 2 * t;
  if (row_a < S) {
#pragma unroll
    for (int d = 0; d < NT_O; ++d)
      *reinterpret_cast<uint32_t*>(op + row_a * o_ss + d * 8) =
          pack_bf16(acc[4 * d] * inv_a, acc[4 * d + 1] * inv_a);
    if (t == 0) lse[(long long)bh * S + row_a] = (m_a + log2f(l_a)) * kLn2;
  }
  if (row_b < S) {
#pragma unroll
    for (int d = 0; d < NT_O; ++d)
      *reinterpret_cast<uint32_t*>(op + row_b * o_ss + d * 8) =
          pack_bf16(acc[4 * d + 2] * inv_b, acc[4 * d + 3] * inv_b);
    if (t == 0) lse[(long long)bh * S + row_b] = (m_b + log2f(l_b)) * kLn2;
  }
}

// Returns go(the kernel, its dynamic shared bytes) for head_dim 64 or 128,
// cudaErrorInvalidValue for another.
template <typename Go>
int fwd_dispatch(int head_dim, Go go) {
  if (head_dim == 64)
    return go(splash_attention_fwd_kernel<64>, FwdLayout<64>::kBytes);
  if (head_dim == 128)
    return go(splash_attention_fwd_kernel<128>, FwdLayout<128>::kBytes);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry, bound with ctypes. Strides are in elements; o is written
// contiguous (B, S, H, hd) and lse contiguous (B, H, S). Launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// head dimension or grid, or inputs the tensor maps do not take).
extern "C" int splash_attention_fwd(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int B, int S, int H,
                                    int head_dim, long long q_sb, long long q_ss,
                                    long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss,
                                    long long v_sh, float scale, int causal,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return fwd_dispatch(head_dim, [&](auto kernel, int smem) {
    static bool allowed[2][64] = {};
    cudaError_t err = allow_smem(kernel, smem, allowed[head_dim == 128]);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap q_map, k_map, v_map;
    err = encode_bf16_tile_map(&q_map, q, B, S, H, head_dim, q_sb, q_ss, q_sh);
    if (err == cudaSuccess)
      err = encode_bf16_tile_map(&k_map, k, B, S, H, head_dim, k_sb, k_ss, k_sh);
    if (err == cudaSuccess)
      err = encode_bf16_tile_map(&v_map, v, B, S, H, head_dim, v_sb, v_ss, v_sh);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
    kernel<<<grid, kThreads, smem, st>>>(
        q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), S, H, scale * 1.4426950408889634f, causal);
    return (int)cudaGetLastError();
  });
}

// What the kernel holds on an SM (kernel_resources in mma_sm90.cuh:
// registers, spill bytes, static and dynamic shared bytes, resident blocks)
// at head_dim.
extern "C" int splash_attention_fwd_resources(int head_dim, int* out) {
  return fwd_dispatch(head_dim, [&](auto kernel, int smem) {
    return (int)kernel_resources(kernel, kThreads, smem, out);
  });
}
