// The flash-attention forward body of one ring step (ring_attention_fwd.cu,
// which says what it replaces, what bounds it and why it is built so); this
// header holds the code, written with mma.sync m16n8k16, cp.async and
// ldmatrix. The splash forward (splash_attention_fwd.cu) has its own body,
// built on wgmma and TMA loads, and takes only the constants below.
//
// The Mode tag (mma_sm90.cuh) picks, at compile time, the ring step's
// addressing and epilogue: blockIdx.z selects one (rank, source chunk) pair
// of the step, q is read at the rank's rows and k, v at the source chunk's,
// and the block merges its normalised output and lse into the rank's
// running fp32 (o, lse), whose tile the TMA moves between device and shared
// memory (RingFirstStepMode: the ring's step 0 writes them and reads
// nothing; RingStepMode: a later step). The tag is part of the kernel's
// name, so a profile tells them apart. The body is a device function;
// ring_attention_fwd.cu holds its kernel and launch bounds.

#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int kBlockQ = 64;      // query rows per block (16 per warp)
constexpr int kBlockKV = 64;     // key/value rows per tile
constexpr int kThreads = 128;    // four warps
constexpr int kPad = 8;          // bf16 elements of padding per shared row
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr float kLn2 = 0.6931471805599453f;
// The causal diagonal of query tile i is KV tile i.
static_assert(kBlockQ == kBlockKV, "query and KV tiles must be equal");

template <int HD>
__host__ __device__ constexpr int tile_elems() { return kBlockKV * (HD + kPad); }

// Shared memory of the ring body: K and V, two buffers each. The query tile
// is staged in the second K buffer before the loop starts.
template <int HD>
__host__ __device__ constexpr int smem_bytes() { return 4 * tile_elems<HD>() * 2; }

// The dynamic shared memory of a launch in mode Mode: a later ring step adds
// the running output's fp32 tile and its mbarrier past the K/V buffers (the
// first step stages its tile in the K/V buffers once the loop is done).
template <int HD, typename Mode>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return smem_bytes<HD>() +
         (Mode::kRing && !Mode::kFirst ? AccTile<HD>::kBytes + 16 : 0);
}
static_assert(2 * tile_elems<64>() * 2 >= AccTile<64>::kBytes &&
                  2 * tile_elems<128>() * 2 >= AccTile<128>::kBytes,
              "an fp32 accumulator tile fits in two bf16 tiles");

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Starts copying a tile of 64 rows of HD bf16 into shared memory with row
// stride HD + kPad, 16 bytes per thread per step. Rows at or past S become
// zeros: a zero V row times a zero probability stays zero, where stale
// shared memory could hold a NaN.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int row0, int S) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < kBlockKV * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool valid = row0 + r < S;
    const __nv_bfloat16* g =
        src + (long long)(valid ? row0 + r : 0) * row_stride + c;
    cp_async16(dst + r * (HD + kPad) + c, g, valid);
  }
}

// The ring step's epilogue for one query row: merges this thread's columns
// of the block's unnormalised output (acc[d][e0], acc[d][e0 + 1]), with
// base-2 running max m and row sum l, into the running fp32 output row and
// the row's running lse (natural log), read before as lse_old:
//   lse_new = logaddexp(lse_old, lse_b)
//   o_new   = o_old * exp(lse_old - lse_new) + (acc / l) * exp(lse_b - lse_new)
// From o = 0, lse = -1e30 the result is exactly the block's own (o_b, lse_b).
template <int NT_O>
__device__ __forceinline__ void ring_merge_row(uint32_t o_row, float* lse_row,
                                               float lse_old,
                                               float acc[NT_O][4],
                                               int e0, float m, float l,
                                               bool writes_lse) {
  const float lse_b = (m + log2f(l)) * kLn2;
  const float hi = fmaxf(lse_old, lse_b);
  const float lo = fminf(lse_old, lse_b);
  const float lse_new = hi + log1pf(expf(lo - hi));
  const float w_old = expf(lse_old - lse_new);
  const float w_new = l > 0.f ? expf(lse_b - lse_new) / l : 0.f;
#pragma unroll
  for (int d = 0; d < NT_O; ++d) {
    float2 x = lds2(o_row + d * 32);
    x.x = x.x * w_old + acc[d][e0] * w_new;
    x.y = x.y * w_old + acc[d][e0 + 1] * w_new;
    sts2(o_row + d * 32, x);
  }
  if (writes_lse) *lse_row = lse_new;
}

// The first ring step's epilogue for one query row: the block's own
// normalised output and lse, which is what ring_merge_row gives from o = 0,
// lse = -1e30, bit for bit (lse_new = lse_b, w_old = 0, w_new = 1 / l).
// Nothing is read.
template <int NT_O>
__device__ __forceinline__ void ring_write_row(uint32_t o_row, float* lse_row,
                                               float acc[NT_O][4], int e0,
                                               float m, float l,
                                               bool writes_lse) {
  const float w = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int d = 0; d < NT_O; ++d)
    sts2(o_row + d * 32, make_float2(acc[d][e0] * w, acc[d][e0 + 1] * w));
  if (writes_lse) *lse_row = (m + log2f(l)) * kLn2;
}

// The body of a block of one ring step. The running output, fp32
// (B, world * S, H, HD) with the rows of rank r from r * S, is reached
// through o_map (encode_acc_map); `o` is not read. lse: fp32
// (B, H, world * S). pairs: (rank, source chunk) of blockIdx.z; S is one
// shard's rows.
template <int HD, typename Mode>
__device__ __forceinline__ void attention_fwd_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, void* __restrict__ o,
    float* __restrict__ lse, int S, int H, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale_log2,
    int causal, const int* __restrict__ pairs, int world,
    const CUtensorMap* o_map) {
  constexpr int LD = HD + kPad;
  constexpr int TILE = tile_elems<HD>();
  constexpr int KSTEPS = HD / 16;     // k-steps of the q k^T product
  constexpr int NT_S = kBlockKV / 8;  // n-tiles of a score row block
  constexpr int NT_O = HD / 8;        // n-tiles of an output row block

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + 2 * TILE;

  // The last query tiles do the most causal work: issue them first.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = q_tile * kBlockQ;
  int rank = 0, src = 0;
  if constexpr (Mode::kRing) {
    rank = pairs[2 * blockIdx.z];
    src = pairs[2 * blockIdx.z + 1];
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within the 8-row group of a fragment
  const int t = lane % 4;   // column pair within a fragment
  const int mi = lane / 8;  // which ldmatrix matrix this lane addresses
  const int mr = lane % 8;  // which row of it

  const __nv_bfloat16* qp = q + b * q_sb + (long long)rank * S * q_ss + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + (long long)src * S * k_ss + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + (long long)src * S * v_ss + h * v_sh;

  const int n_kv = (S + kBlockKV - 1) / kBlockKV;
  const int kv_end = causal ? min(n_kv, q_tile + 1) : n_kv;
  // This thread's two query rows.
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  // Query tile into the second K buffer, KV tile 0 into the first buffers.
  load_tile_async<HD>(k_s + TILE, qp, q_ss, q0, S);
  load_tile_async<HD>(k_s, kp, k_ss, 0, S);
  load_tile_async<HD>(v_s, vp, v_ss, 0, S);
  cp_async_commit();

  // The ring step's running output: the block's 64 rows of head h of o_acc
  // (a tile of o_map) and its rows of lse_acc. At a later step the TMA reads
  // the tile into shared memory past the K/V buffers while the loop runs,
  // and each thread reads its rows' lse now. The first step reads neither
  // and stages its output in the K/V buffers once the loop is done.
  const int bw = b * world + rank;  // the rank's shard of batch b in o_map
  float* lp = nullptr;
  float old_a = 0.f, old_b = 0.f;
  AccTile<HD> o_tile = {{smem_addr(k_s), smem_addr(k_s + TILE)}};
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + smem_bytes<HD>() +
                                              AccTile<HD>::kBytes);
  if constexpr (Mode::kRing) {
    lp = lse + ((long long)bh * world + rank) * S;
    if constexpr (!Mode::kFirst) {
      const uint32_t tile = smem_addr(smem_raw + smem_bytes<HD>());
      o_tile = {{tile, tile + 32 * HD * 4}};
      if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        fence_mbar_init();
        o_tile.load(o_map, h, q0, bw, bar);
      }
      old_a = row_a < S ? lp[row_a] : 0.f;
      old_b = row_b < S ? lp[row_b] : 0.f;
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* r0 = k_s + TILE + (warp * 16 + g) * LD + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qa[kk][0] = ld32(r0 + kk * 16);
      qa[kk][1] = ld32(r1 + kk * 16);
      qa[kk][2] = ld32(r0 + kk * 16 + 8);
      qa[kk][3] = ld32(r1 + kk * 16 + 8);
    }
  }
  __syncthreads();  // the second buffers are free for tile 1

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = kMaskValue, m_b = kMaskValue;  // running max, base-2 units
  float l_a = 0.f, l_b = 0.f;                // this thread's share of the sum

  for (int j = 0; j < kv_end; ++j) {
    const int cur = j & 1;
    if (j + 1 < kv_end) {
      const int nxt = (j + 1) * kBlockKV;
      load_tile_async<HD>(k_s + (cur ^ 1) * TILE, kp, k_ss, nxt, S);
      load_tile_async<HD>(v_s + (cur ^ 1) * TILE, vp, v_ss, nxt, S);
      cp_async_commit();
      cp_async_wait<1>();  // tile j has landed; tile j+1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = k_s + cur * TILE;
    const __nv_bfloat16* vb = v_s + cur * TILE;
    const int kv0 = j * kBlockKV;

    // s = q k^T. One ldmatrix.x4 gives the B fragments of two n-tiles
    // (key rows) for one 16-wide k-step: matrices (n, lo), (n, hi),
    // (n+1, lo), (n+1, hi).
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT_S; n += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kb + ((n + (mi >> 1)) * 8 + mr) * LD + kk * 16 +
                            (mi & 1) * 8);
        mma_16816(s[n], qa[kk], bk[0], bk[1]);
        mma_16816(s[n + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // Scale into base-2 units, mask, and take the row maxima.
    const bool edge = (kv0 + kBlockKV > S) || (causal && j == q_tile);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= S || (causal && col > row)) x = kMaskValue;
        }
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));

    const float alpha_a = exp2f(m_a - mx_a);
    const float alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= alpha_a;
      acc[i][1] *= alpha_a;
      acc[i][2] *= alpha_b;
      acc[i][3] *= alpha_b;
    }
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = exp2f(s[n][0] - m_a);
      s[n][1] = exp2f(s[n][1] - m_a);
      s[n][2] = exp2f(s[n][2] - m_b);
      s[n][3] = exp2f(s[n][3] - m_b);
      l_a += s[n][0] + s[n][1];
      l_b += s[n][2] + s[n][3];
    }

    // o += p v: the score accumulators of n-tiles 2kt and 2kt+1 are exactly
    // the A fragment of the 16-wide k-step kt. V is row-major (key, d):
    // ldmatrix.trans of matrices (kt lo, d), (kt hi, d), (kt lo, d+8),
    // (kt hi, d+8) gives the B fragments of two 8-wide d tiles.
#pragma unroll
    for (int kt = 0; kt < kBlockKV / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int d = 0; d < NT_O; d += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + (kt * 16 + (mi & 1) * 8 + mr) * LD +
                                  (d + (mi >> 1)) * 8);
        mma_16816(acc[d], pa, bv[0], bv[1]);
        mma_16816(acc[d + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it refills
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);

  // Merge into the tile (the first step writes it), then the TMA writes
  // it back.
  const int r_a = warp * 16 + g;  // this thread's rows in the tile
  if constexpr (Mode::kFirst) {
    if (row_a < S)
      ring_write_row<NT_O>(o_tile.row(r_a) + 8 * t, lp + row_a, acc, 0, m_a,
                           l_a, t == 0);
    if (row_b < S)
      ring_write_row<NT_O>(o_tile.row(r_a + 8) + 8 * t, lp + row_b, acc, 2,
                           m_b, l_b, t == 0);
  } else {
    mbar_wait(bar, 0);
    if (row_a < S)
      ring_merge_row<NT_O>(o_tile.row(r_a) + 8 * t, lp + row_a, old_a, acc,
                           0, m_a, l_a, t == 0);
    if (row_b < S)
      ring_merge_row<NT_O>(o_tile.row(r_a + 8) + 8 * t, lp + row_b, old_b,
                           acc, 2, m_b, l_b, t == 0);
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) o_tile.store(o_map, h, q0, bw);
}

}  // namespace
