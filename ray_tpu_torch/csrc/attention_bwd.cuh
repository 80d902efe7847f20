// The flash-attention backward bodies of one ring step (ring_attention_bwd.cu,
// which says what it replaces, what bounds it and why it is built so); this
// header is the ring's alone and holds the code, written with mma.sync
// m16n8k16, cp.async and ldmatrix. The splash backward
// (splash_attention_bwd.cu) has its own kernels, built on wgmma and TMA
// loads.
//
// The Mode tag (mma_sm90.cuh) picks, at compile time, the ring step's kind:
// blockIdx.z selects one (rank, source chunk) pair of the step; q, do, lse
// and delta are read at the rank's rows and k, v at the chunk's; dq is added
// into the rank's rows and dk, dv into the chunk's rows of fp32
// accumulators, whose tiles the TMA moves between device and shared memory
// (RingFirstStepMode: the ring's step 0 writes them and reads nothing;
// RingStepMode: a later step). The tag is part of the kernel's name, so a
// profile tells them apart. The bodies are device functions;
// ring_attention_bwd.cu holds their kernels and launch bounds.

#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 64;      // rows of a query tile and of a KV tile
constexpr int kThreads = 128;   // four warps, 16 rows each
constexpr int kPad = 8;         // bf16 elements of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int tile_elems() { return kBlock * (HD + kPad); }

// Six tiles: the block's own two (K, V or Q, dO) and two double-buffered
// streamed ones; plus, for the dkv kernel, lse and delta of two query tiles.
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return 6 * tile_elems<HD>() * 2 + 4 * kBlock * 4;
}

// Where a later ring step reads its fp32 accumulator tiles (AccTile in
// mma_sm90.cuh) without losing a resident block. Both kernels hold 3
// blocks per SM at hd=64 (registers, capped at 168 by ring_min_blocks) and
// 2 at hd=128 (shared memory). At hd=64 one tile fits beside 3 blocks: the
// dq tile, or dk's, gets shared memory of its own past the kernel's and is
// read from the block's start. Every other tile is read into streamed
// buffers that the loop has freed: dv into the last iteration's free Q/dO
// buffers and (hd=128) dq into its free K/V buffers, one iteration ahead of
// the epilogue; dk (hd=128) into K/V once the last iteration's products
// with them are done. The first step stages its tiles in the streamed
// buffers once the loop is done.
template <int HD>
__host__ __device__ constexpr bool acc_early() { return HD == 64; }

// The dynamic shared memory of each kernel's launch in mode Mode: a later
// ring step adds its early tile (hd=64) and one mbarrier.
template <int HD, typename Mode>
__host__ __device__ constexpr int ring_extra_bytes() {
  return !Mode::kFirst
             ? (acc_early<HD>() ? AccTile<HD>::kBytes : 0) + 16
             : 0;
}
template <int HD, typename Mode>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return smem_bytes<HD>() + ring_extra_bytes<HD, Mode>();
}
template <int HD, typename Mode>
__host__ __device__ constexpr int dq_smem_bytes() {
  return smem_bytes<HD>() + ring_extra_bytes<HD, Mode>();
}
static_assert(2 * tile_elems<64>() * 2 >= AccTile<64>::kBytes &&
                  2 * tile_elems<128>() * 2 >= AccTile<128>::kBytes,
              "an fp32 accumulator tile fits in two bf16 tiles");

// A later ring step's early tile, past the kernel's own shared memory
// (hd=64), and its mbarrier after that.
template <int HD>
__device__ __forceinline__ AccTile<HD> extra_tile(unsigned char* smem) {
  const uint32_t p = smem_addr(smem + smem_bytes<HD>());
  return {{p, p + 32 * HD * 4}};
}
template <int HD>
__device__ __forceinline__ uint64_t* ring_bar(unsigned char* smem) {
  return reinterpret_cast<uint64_t*>(
      smem + smem_bytes<HD>() + (acc_early<HD>() ? AccTile<HD>::kBytes : 0));
}

// The tile made of two bf16 buffers.
template <int HD>
__device__ __forceinline__ AccTile<HD> buffer_tile(__nv_bfloat16* lo,
                                                   __nv_bfloat16* hi) {
  return {{smem_addr(lo), smem_addr(hi)}};
}

// Starts copying 64 rows of HD bf16 into shared memory with row stride
// HD + kPad. Rows at or past S become zeros.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int row0, int S) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < kBlock * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool valid = row0 + r < S;
    const __nv_bfloat16* g =
        src + (long long)(valid ? row0 + r : 0) * row_stride + c;
    cp_async16(dst + r * (HD + kPad) + c, g, valid);
  }
}

// B fragments of the n-tiles n0 and n0+8 for k-step kk, from a tile stored
// [n][k]: b[0], b[1] for n0; b[2], b[3] for n0+8.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const __nv_bfloat16* tile,
                                          int n0, int kk) {
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix_x4(b, tile + (n0 + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
}

// The same from a tile stored [k][n] (the product contracts over its rows).
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const __nv_bfloat16* tile,
                                          int kk, int n0) {
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix_x4_trans(b, tile + (kk * 16 + (mi & 1) * 8 + mr) * LD + n0 + (mi >> 1) * 8);
}

// acc (16 x 64) = A[r0:r0+16, :HD] * B[0:64, :HD]^T, B stored [n][k].
template <int HD>
__device__ __forceinline__ void product_nt(float acc[8][4], const __nv_bfloat16* a_tile,
                                           int r0, const __nv_bfloat16* b_tile) {
  constexpr int LD = HD + kPad;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, a_tile, r0, kk);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      load_b_nk<LD>(b, b_tile, n * 8, kk);
      mma_16816(acc[n], a, b[0], b[1]);
      mma_16816(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// out (16 x HD) += P (16 x 64, accumulator layout) * B (64 x HD), B stored
// [k][n]. The accumulators of n-tiles 2kt and 2kt+1 are exactly the A
// fragment of the 16-wide k-step kt.
template <int HD>
__device__ __forceinline__ void product_pn(float out[HD / 8][4], float p[8][4],
                                           const __nv_bfloat16* b_tile) {
  constexpr int LD = HD + kPad;
#pragma unroll
  for (int kt = 0; kt < kBlock / 16; ++kt) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kt][0], p[2 * kt][1]);
    pa[1] = pack_bf16(p[2 * kt][2], p[2 * kt][3]);
    pa[2] = pack_bf16(p[2 * kt + 1][0], p[2 * kt + 1][1]);
    pa[3] = pack_bf16(p[2 * kt + 1][2], p[2 * kt + 1][3]);
#pragma unroll
    for (int d = 0; d < HD / 8; d += 2) {
      uint32_t b[4];
      load_b_kn<LD>(b, b_tile, kt, d * 8);
      mma_16816(out[d], pa, b[0], b[1]);
      mma_16816(out[d + 1], pa, b[2], b[3]);
    }
  }
}

// Adds a warp's 16 x HD accumulator tile, times `scale`, into rows r_a
// and r_a + 8 of an fp32 tile in shared memory
// (writes them at the first step). Each thread owns its elements, so the
// addition needs no atomics. Rows past S hold zeros and the TMA writes none
// of them back.
template <int HD, bool kFirst>
__device__ __forceinline__ void add_rows(const AccTile<HD>& tile,
                                         float acc[HD / 8][4], int r_a,
                                         float scale) {
  const int t = (threadIdx.x % 32) % 4;
  const uint32_t pa = tile.row(r_a) + 8 * t;
  const uint32_t pb = tile.row(r_a + 8) + 8 * t;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    float2 x = kFirst ? make_float2(0.f, 0.f) : lds2(pa + d * 32);
    x.x += acc[d][0] * scale;
    x.y += acc[d][1] * scale;
    sts2(pa + d * 32, x);
    x = kFirst ? make_float2(0.f, 0.f) : lds2(pb + d * 32);
    x.x += acc[d][2] * scale;
    x.y += acc[d][3] * scale;
    sts2(pb + d * 32, x);
  }
}

// The (rank, chunk) pair of this block.
__device__ __forceinline__ int2 block_pair(const int* pairs) {
  return make_int2(pairs[2 * blockIdx.z], pairs[2 * blockIdx.z + 1]);
}

// dk, dv for one 64-row KV tile of one (batch, head): the body of a block.
// The ring step reaches its fp32 dk, dv through dk_map, dv_map
// (encode_acc_map).
template <int HD, typename Mode>
__device__ __forceinline__ void attention_bwd_dkv_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int S,
    int H, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh,
    float scale_log2, float scale, int causal, const int* __restrict__ pairs,
    int world, const CUtensorMap* dk_map, const CUtensorMap* dv_map) {
  constexpr int TILE = tile_elems<HD>();
  constexpr int NT_O = HD / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + TILE;
  __nv_bfloat16* q_s = v_s + TILE;     // two buffers
  __nv_bfloat16* do_s = q_s + 2 * TILE;  // two buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TILE);  // [2][64], base 2
  float* delta_s = lse_s + 2 * kBlock;                        // [2][64]

  // Causal: KV tile 0 walks every query tile; blocks go out in index order,
  // so the longest come first.
  const int kv_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = kv_tile * kBlock;
  const int2 pair = block_pair(pairs);  // x: rank (q side), y: chunk

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const __nv_bfloat16* qp = q + b * q_sb + (long long)pair.x * S * q_ss + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + (long long)pair.y * S * k_ss + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + (long long)pair.y * S * v_ss + h * v_sh;
  const __nv_bfloat16* dp_ = dout + b * d_sb + (long long)pair.x * S * d_ss + h * d_sh;
  // Row 0 of this (batch, head) and rank in lse and delta.
  const long long lrow0 = ((long long)bh * world + pair.x) * S;
  const float* lse_p = lse + lrow0;
  const float* delta_p = delta + lrow0;

  const int n_q = (S + kBlock - 1) / kBlock;
  const int q_begin = causal ? kv_tile : 0;

  auto load_q_tile = [&](int i, int buf) {
    const int q0 = i * kBlock;
    load_tile_async<HD>(q_s + buf * TILE, qp, q_ss, q0, S);
    load_tile_async<HD>(do_s + buf * TILE, dp_, d_ss, q0, S);
    if (threadIdx.x < kBlock) {
      const int r = q0 + threadIdx.x;
      lse_s[buf * kBlock + threadIdx.x] = r < S ? lse_p[r] * kLog2e : 0.f;
      delta_s[buf * kBlock + threadIdx.x] = r < S ? delta_p[r] : 0.f;
    }
  };

  load_tile_async<HD>(k_s, kp, k_ss, kv0, S);
  load_tile_async<HD>(v_s, vp, v_ss, kv0, S);
  load_q_tile(q_begin, 0);
  cp_async_commit();

  const int kvr_a = kv0 + warp * 16 + g;  // this thread's two key rows
  const int kvr_b = kvr_a + 8;

  // The ring step's dk and dv: the block's 64 rows of head h of each (tiles
  // of dk_map, dv_map), added in shared memory and written back by the TMA.
  // A later step reads them with the TMA, where acc_early says.
  const int bw = b * world + pair.y;             // the chunk's shard of batch b
  const int last = n_q - 1;                      // the loop's last query tile
  const int spare = ((last - q_begin) & 1) ^ 1;  // its free Q/dO buffers
  AccTile<HD> dk_tile = buffer_tile<HD>(q_s, q_s + TILE);
  AccTile<HD> dv_tile = buffer_tile<HD>(do_s, do_s + TILE);
  uint64_t* bar = ring_bar<HD>(smem_raw);
  if constexpr (!Mode::kFirst) {
    dk_tile = acc_early<HD>() ? extra_tile<HD>(smem_raw) : buffer_tile<HD>(k_s, v_s);
    dv_tile = buffer_tile<HD>(q_s + spare * TILE, do_s + spare * TILE);
    if (threadIdx.x == 0) {
      mbar_init(bar, 2);  // one arrival per tile
      fence_mbar_init();
      if constexpr (acc_early<HD>()) dk_tile.load(dk_map, h, kv0, bw, bar);
    }
  }

  float acc_dk[NT_O][4], acc_dv[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    acc_dk[i][0] = acc_dk[i][1] = acc_dk[i][2] = acc_dk[i][3] = 0.f;
    acc_dv[i][0] = acc_dv[i][1] = acc_dv[i][2] = acc_dv[i][3] = 0.f;
  }

  for (int i = q_begin; i < n_q; ++i) {
    const int cur = (i - q_begin) & 1;
    if (i + 1 < n_q) {
      load_q_tile(i + 1, cur ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if constexpr (!Mode::kFirst) {
        if (threadIdx.x == 0) dv_tile.load(dv_map, h, kv0, bw, bar);
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qb = q_s + cur * TILE;
    const __nv_bfloat16* dob = do_s + cur * TILE;
    const float* lseb = lse_s + cur * kBlock;
    const float* deltab = delta_s + cur * kBlock;
    const int q0 = i * kBlock;

    // p^T (16 key rows x 64 query columns) = exp2(k q^T * scale - lse).
    float s[8][4];
    product_nt<HD>(s, k_s, warp * 16, qb);
    const bool edge = (q0 + kBlock > S) || (kv0 + kBlock > S) ||
                      (causal && i == kv_tile);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float p = exp2f(s[n][e] * scale_log2 - lseb[col]);
        if (edge) {
          const int qi = q0 + col;
          const int row = e < 2 ? kvr_a : kvr_b;
          if (qi >= S || row >= S || (causal && row > qi)) p = 0.f;
        }
        s[n][e] = p;
      }
    }
    // dv += p^T do.
    product_pn<HD>(acc_dv, s, dob);
    // dp^T = v do^T, then ds^T = p^T (dp^T - delta).
    float dpt[8][4];
    product_nt<HD>(dpt, v_s, warp * 16, dob);
    if constexpr (!Mode::kFirst && !acc_early<HD>()) {
      if (i == last) {
        __syncthreads();  // every warp is done with K and V
        if (threadIdx.x == 0) dk_tile.load(dk_map, h, kv0, bw, bar);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        dpt[n][e] = s[n][e] * (dpt[n][e] - deltab[col]);
      }
    }
    // dk += ds^T q (scaled at the end).
    product_pn<HD>(acc_dk, dpt, qb);
    __syncthreads();  // every warp is done with buffer cur before it refills
  }

  if constexpr (!Mode::kFirst) mbar_wait(bar, 0);
  add_rows<HD, Mode::kFirst>(dk_tile, acc_dk, warp * 16 + g, scale);
  add_rows<HD, Mode::kFirst>(dv_tile, acc_dv, warp * 16 + g, 1.f);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) dk_tile.store(dk_map, h, kv0, bw);
  if (threadIdx.x == 32) dv_tile.store(dv_map, h, kv0, bw);
}

// dq for one 64-row query tile of one (batch, head): the body of a block.
// The ring step reaches its fp32 dq through dq_map (encode_acc_map).
template <int HD, typename Mode>
__device__ __forceinline__ void attention_bwd_dq_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int S,
    int H, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh,
    float scale_log2, float scale, int causal, const int* __restrict__ pairs,
    int world, const CUtensorMap* dq_map) {
  constexpr int TILE = tile_elems<HD>();
  constexpr int NT_O = HD / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + TILE;
  __nv_bfloat16* k_s = do_s + TILE;    // two buffers
  __nv_bfloat16* v_s = k_s + 2 * TILE;  // two buffers

  // The last query tiles do the most causal work: issue them first.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = q_tile * kBlock;
  const int2 pair = block_pair(pairs);  // x: rank (q side), y: chunk

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const __nv_bfloat16* qp = q + b * q_sb + (long long)pair.x * S * q_ss + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + (long long)pair.y * S * k_ss + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + (long long)pair.y * S * v_ss + h * v_sh;
  const __nv_bfloat16* dp_ = dout + b * d_sb + (long long)pair.x * S * d_ss + h * d_sh;

  const int n_kv = (S + kBlock - 1) / kBlock;
  const int kv_end = causal ? min(n_kv, q_tile + 1) : n_kv;

  load_tile_async<HD>(q_s, qp, q_ss, q0, S);
  load_tile_async<HD>(do_s, dp_, d_ss, q0, S);
  load_tile_async<HD>(k_s, kp, k_ss, 0, S);
  load_tile_async<HD>(v_s, vp, v_ss, 0, S);
  cp_async_commit();

  // The ring step's dq, as dk and dv in the dk/dv body: a later step reads
  // it at the block's start or into the last iteration's free K/V buffers
  // (acc_early).
  const int bw = b * world + pair.x;         // the rank's shard of batch b
  const int spare = ((kv_end - 1) & 1) ^ 1;  // the last iteration's free buffers
  AccTile<HD> dq_tile = buffer_tile<HD>(k_s, k_s + TILE);
  uint64_t* bar = ring_bar<HD>(smem_raw);
  if constexpr (!Mode::kFirst) {
    dq_tile = acc_early<HD>()
                  ? extra_tile<HD>(smem_raw)
                  : buffer_tile<HD>(k_s + spare * TILE, v_s + spare * TILE);
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      fence_mbar_init();
      if constexpr (acc_early<HD>()) dq_tile.load(dq_map, h, q0, bw, bar);
    }
  }

  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const long long lrow0 = ((long long)bh * world + pair.x) * S;
  const float* lse_p = lse + lrow0;
  const float* delta_p = delta + lrow0;
  const float lse_a = row_a < S ? lse_p[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < S ? lse_p[row_b] * kLog2e : 0.f;
  const float delta_a = row_a < S ? delta_p[row_a] : 0.f;
  const float delta_b = row_b < S ? delta_p[row_b] : 0.f;

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < kv_end; ++j) {
    const int cur = j & 1;
    if (j + 1 < kv_end) {
      const int nxt = (j + 1) * kBlock;
      load_tile_async<HD>(k_s + (cur ^ 1) * TILE, kp, k_ss, nxt, S);
      load_tile_async<HD>(v_s + (cur ^ 1) * TILE, vp, v_ss, nxt, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if constexpr (!Mode::kFirst && !acc_early<HD>()) {
        if (threadIdx.x == 0) dq_tile.load(dq_map, h, q0, bw, bar);
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = k_s + cur * TILE;
    const __nv_bfloat16* vb = v_s + cur * TILE;
    const int kv0 = j * kBlock;

    // p (16 query rows x 64 key columns) = exp2(q k^T * scale - lse).
    float s[8][4];
    product_nt<HD>(s, q_s, warp * 16, kb);
    const bool edge = (kv0 + kBlock > S) || (q0 + kBlock > S) ||
                      (causal && j == q_tile);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        float p = exp2f(s[n][e] * scale_log2 - (e < 2 ? lse_a : lse_b));
        if (edge) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          if (col >= S || row >= S || (causal && col > row)) p = 0.f;
        }
        s[n][e] = p;
      }
    }
    // dp = do v^T, then ds = p (dp - delta).
    float dp[8][4];
    product_nt<HD>(dp, do_s, warp * 16, vb);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      dp[n][0] = s[n][0] * (dp[n][0] - delta_a);
      dp[n][1] = s[n][1] * (dp[n][1] - delta_a);
      dp[n][2] = s[n][2] * (dp[n][2] - delta_b);
      dp[n][3] = s[n][3] * (dp[n][3] - delta_b);
    }
    // dq += ds k (scaled at the end).
    product_pn<HD>(acc, dp, kb);
    __syncthreads();
  }

  if constexpr (!Mode::kFirst) mbar_wait(bar, 0);
  add_rows<HD, Mode::kFirst>(dq_tile, acc, warp * 16 + g, scale);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) dq_tile.store(dq_map, h, q0, bw);
}

}  // namespace
