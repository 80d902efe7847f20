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
//
// What the design does about it: every kernel is a block that keeps one
// tile resident in shared memory and streams 32-row tiles of the other
// operand through two cp.async buffers, so the next tile's load overlaps this
// tile's math; the products run on the tensor cores through mma.sync
// m16n8k16 (bf16 operands, fp32 accumulators) with ldmatrix operand loads,
// eight warps a block.
//   fwd: 64 rows of x resident; W streams past in 32-row vocab tiles; each
//        warp owns 16 rows x 16 vocab columns of a tile and keeps an online
//        max and sum-exp (base 2) for its columns in registers; the two
//        column halves of a row merge once at the end.
//   dx:  32 rows of x resident; W streams past. Per tile the 32 x 32 logits
//        are recomputed, p - onehot goes through shared memory as bf16, and
//        dx += p W accumulates in registers: the 32 x D fp32 tile is split
//        over the eight warps (16 rows x D/4 columns each, 96 registers at
//        D = 768). A 64-row tile would need twice that, more than the
//        register file, and keeping it in shared memory (196 KB at D = 768)
//        would leave no room for the operands; splitting D across blocks
//        would recompute the logits once per split.
//   dW:  the same with the roles swapped: 32 vocab rows of W resident, x
//        streams past, dW += (p - onehot)^T x. Each block walks every row
//        tile itself, the counterpart of the TPU's sequential grid axis
//        (:141-147), so the sum over N needs no atomics and gives the same
//        bits on every run.
// Ragged N and V are masked: rows past N and vocab rows past V read as zeros,
// get p = 0 and are never written.
//
// Known slowness, for later work: W (77 MB in bf16) does not fit the 50 MB L2,
// and with 64-row tiles the forward re-reads it once per row tile (256 times
// at N = 16384; dx, with 32-row tiles, 512 times; dW re-reads x once per
// vocab tile). mma.sync with a 16 x 8 or 16 x 16 warp tile also reloads its
// A operand for every product; wgmma, TMA and larger warp tiles are the fix.
//
// D must be one of the instantiated widths: 768 (GPT-2 124M), 128
// (GPTConfig.tiny()) and 64 (the ragged test case). The accumulators are
// registers sized at compile time; the wrapper checks D.

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;   // eight warps
constexpr int kPad = 8;         // bf16 elements of padding per shared row
constexpr int kTile = 32;       // rows of a streamed tile (and of dx/dW's resident one)
constexpr int kFwdRows = 64;    // rows of x resident in the forward
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// Starts copying `rows` rows of a contiguous (n_total, D) bf16 matrix from
// row0 into shared memory with row stride D + kPad; rows at or past n_total
// become zeros.
template <int D>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n_total, int rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool valid = row0 + r < n_total;
    const __nv_bfloat16* g = src + (long long)(valid ? row0 + r : 0) * D + c;
    cp_async16(dst + r * (D + kPad) + c, g, valid);
  }
}

// c (16 x 8*NTW) = R[r0:r0+16, :D] * S[s0:s0+8*NTW, :D]^T, both row-major in
// shared memory with row stride D + kPad.
template <int D, int NTW>
__device__ __forceinline__ void tile_logits(float c[NTW][4], const __nv_bfloat16* R,
                                            int r0, const __nv_bfloat16* S, int s0) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int n = 0; n < NTW; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, R, r0, kk);
    if constexpr (NTW == 2) {
      uint32_t b[4];
      ldmatrix_x4(b, S + (s0 + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
      mma_16816(c[0], a, b[0], b[1]);
      mma_16816(c[1], a, b[2], b[3]);
    } else {
      uint32_t b[2];
      ldmatrix_x2(b, S + (s0 + mr) * LD + kk * 16 + (mi & 1) * 8);
      mma_16816(c[0], a, b[0], b[1]);
    }
  }
}

// acc (16 x D/4) += P[r0:r0+16, 0:32] * S[0:32, d0:d0+D/4]: P is the bf16
// (p - onehot) tile in shared memory (row stride kTile + kPad), S a streamed
// or resident tile stored [k][n] (row stride D + kPad).
template <int D>
__device__ __forceinline__ void tile_product(float acc[D / 32][4],
                                             const __nv_bfloat16* P, int r0,
                                             const __nv_bfloat16* S, int d0) {
  constexpr int LD = D + kPad;
  constexpr int PLD = kTile + kPad;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kt = 0; kt < kTile / 16; ++kt) {
    uint32_t a[4];
    load_a<PLD>(a, P, r0, kt);
#pragma unroll
    for (int d = 0; d < D / 32; d += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, S + (kt * 16 + (mi & 1) * 8 + mr) * LD + d0 + d * 8 +
                               (mi >> 1) * 8);
      mma_16816(acc[d], a, b[0], b[1]);
      mma_16816(acc[d + 1], a, b[2], b[3]);
    }
  }
}

// Writes a warp's 16 x D/4 fp32 accumulator tile into a contiguous (n, D)
// matrix at rows r (and r + 8), columns d0...; rows at or past n are skipped.
template <int D>
__device__ __forceinline__ void store_acc(float* out, float acc[D / 32][4], int r,
                                          int n, int d0) {
  const int t = (threadIdx.x % 32) % 4;
#pragma unroll
  for (int d = 0; d < D / 32; ++d) {
    const int col = d0 + d * 8 + 2 * t;
    if (r < n)
      *reinterpret_cast<float2*>(out + (long long)r * D + col) =
          make_float2(acc[d][0], acc[d][1]);
    if (r + 8 < n)
      *reinterpret_cast<float2*>(out + (long long)(r + 8) * D + col) =
          make_float2(acc[d][2], acc[d][3]);
  }
}

template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (kFwdRows + 2 * kTile) * (D + kPad) * 2 + 3 * kFwdRows * 4;
}

template <int D>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 3 * kTile * (D + kPad) * 2 + kTile * (kTile + kPad) * 2;
}

// Forward: lse[n] = logsumexp_v(x[n] . W[v]), tgt[n] = x[n] . W[t[n]].
template <int D>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const int* __restrict__ t, float* __restrict__ lse,
                    float* __restrict__ tgt, int N, int V) {
  constexpr int LD = D + kPad;
  constexpr int WT = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w_s = x_s + kFwdRows * LD;  // two buffers
  float* m_s = reinterpret_cast<float*>(w_s + 2 * WT);
  float* l_s = m_s + kFwdRows;
  float* g_s = l_s + kFwdRows;

  const int row0 = blockIdx.x * kFwdRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int rg = warp & 3;   // rows rg*16 .. of the resident tile
  const int cg = warp >> 2;  // vocab columns cg*16 .. of each tile

  load_rows_async<D>(x_s, x, row0, N, kFwdRows);
  load_rows_async<D>(w_s, w, 0, V, kTile);
  cp_async_commit();

  const int lr_a = rg * 16 + g;  // local rows of this thread
  const int lr_b = lr_a + 8;
  const int t_a = row0 + lr_a < N ? t[row0 + lr_a] : -1;
  const int t_b = row0 + lr_b < N ? t[row0 + lr_b] : -1;
  float m_a = kMaskValue, m_b = kMaskValue;  // running max, base 2
  float l_a = 0.f, l_b = 0.f;                // this thread's share of the sum
  float g_a = 0.f, g_b = 0.f;                // target logit, natural units

  const int n_vt = (V + kTile - 1) / kTile;
  for (int j = 0; j < n_vt; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_vt) {
      load_rows_async<D>(w_s + (cur ^ 1) * WT, w, (j + 1) * kTile, V, kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float c[2][4];
    tile_logits<D, 2>(c, x_s, rg * 16, w_s + cur * WT, cg * 16);
    const int v0 = j * kTile + cg * 16;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + n * 8 + 2 * tq + (e & 1);
        const float z = c[n][e];
        if (e < 2) {
          if (col == t_a) g_a += z;
        } else {
          if (col == t_b) g_b += z;
        }
        const float y = col < V ? z * kLog2e : kMaskValue;
        c[n][e] = y;
        if (e < 2) mx_a = fmaxf(mx_a, y); else mx_b = fmaxf(mx_b, y);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    l_a *= exp2f(m_a - mx_a);
    l_b *= exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + n * 8 + 2 * tq + (e & 1);
        if (col < V) {
          if (e < 2) l_a += exp2f(c[n][e] - m_a); else l_b += exp2f(c[n][e] - m_b);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer cur before it refills
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    g_a += __shfl_xor_sync(0xffffffffu, g_a, off);
    g_b += __shfl_xor_sync(0xffffffffu, g_b, off);
  }
  // Merge the two column halves of each row.
  if (cg == 1 && tq == 0) {
    m_s[lr_a] = m_a; l_s[lr_a] = l_a; g_s[lr_a] = g_a;
    m_s[lr_b] = m_b; l_s[lr_b] = l_b; g_s[lr_b] = g_b;
  }
  __syncthreads();
  if (cg == 0 && tq == 0) {
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int lr = hlf ? lr_b : lr_a;
      const float m0 = hlf ? m_b : m_a, l0 = hlf ? l_b : l_a, g0 = hlf ? g_b : g_a;
      const float m1 = m_s[lr], l1 = l_s[lr], g1 = g_s[lr];
      const float mm = fmaxf(m0, m1);
      const float l = l0 * exp2f(m0 - mm) + l1 * exp2f(m1 - mm);
      if (row0 + lr < N) {
        lse[row0 + lr] = (mm + log2f(l)) * kLn2;
        tgt[row0 + lr] = g0 + g1;
      }
    }
  }
}

// p - onehot for one 32 x 32 tile in the accumulator layout of a 16 x 8 warp
// tile, rounded to bf16 and stored row-major into P (row stride kTile +
// kPad). rows/cols: global indices of this thread's entries; lse_log2 and the
// target per row or per column as the caller lays them out.
__device__ __forceinline__ void store_p(__nv_bfloat16* P, int pr, int pc,
                                        const float c[4], const bool valid[4],
                                        const float lse_log2[4], const bool hot[4]) {
  float p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    p[e] = valid[e] ? exp2f(c[e] * kLog2e - lse_log2[e]) - (hot[e] ? 1.f : 0.f)
                    : 0.f;
  }
  constexpr int PLD = kTile + kPad;
  *reinterpret_cast<uint32_t*>(P + pr * PLD + pc) = pack_bf16(p[0], p[1]);
  *reinterpret_cast<uint32_t*>(P + (pr + 8) * PLD + pc) = pack_bf16(p[2], p[3]);
}

// dx[n] = sum_v (exp(x[n] . W[v] - lse[n]) - [v == t[n]]) W[v], fp32.
template <int D>
__global__ void __launch_bounds__(kThreads)
fused_ce_dx_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ t, const float* __restrict__ lse,
                   float* __restrict__ dx, int N, int V) {
  constexpr int LD = D + kPad;
  constexpr int TT = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w_s = x_s + TT;       // two buffers
  __nv_bfloat16* p_s = w_s + 2 * TT;   // (32 rows, 32 vocab)

  const int row0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int rg = warp & 1;   // rows rg*16 .. (both phases)
  const int cg = warp >> 1;  // logits: vocab columns cg*8 ..; product: D quarter

  load_rows_async<D>(x_s, x, row0, N, kTile);
  load_rows_async<D>(w_s, w, 0, V, kTile);
  cp_async_commit();

  const int r_a = row0 + rg * 16 + g;
  const int r_b = r_a + 8;
  const float lse_a = r_a < N ? lse[r_a] * kLog2e : 0.f;
  const float lse_b = r_b < N ? lse[r_b] * kLog2e : 0.f;
  const int t_a = r_a < N ? t[r_a] : -1;
  const int t_b = r_b < N ? t[r_b] : -1;

  float acc[D / 32][4];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_vt = (V + kTile - 1) / kTile;
  for (int j = 0; j < n_vt; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_vt) {
      load_rows_async<D>(w_s + (cur ^ 1) * TT, w, (j + 1) * kTile, V, kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* wb = w_s + cur * TT;

    float c[1][4];
    tile_logits<D, 1>(c, x_s, rg * 16, wb, cg * 8);
    const int col = j * kTile + cg * 8 + 2 * tq;
    const bool valid[4] = {r_a < N && col < V, r_a < N && col + 1 < V,
                           r_b < N && col < V, r_b < N && col + 1 < V};
    const float ls[4] = {lse_a, lse_a, lse_b, lse_b};
    const bool hot[4] = {col == t_a, col + 1 == t_a, col == t_b, col + 1 == t_b};
    store_p(p_s, rg * 16 + g, cg * 8 + 2 * tq, c[0], valid, ls, hot);
    __syncthreads();

    tile_product<D>(acc, p_s, rg * 16, wb, cg * (D / 4));
    __syncthreads();  // p_s and buffer cur are free for the next tile
  }

  store_acc<D>(dx, acc, r_a, N, cg * (D / 4));
}

// dW[v] = sum_n (exp(x[n] . W[v] - lse[n]) - [v == t[n]]) x[n], fp32.
template <int D>
__global__ void __launch_bounds__(kThreads)
fused_ce_dw_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ t, const float* __restrict__ lse,
                   float* __restrict__ dw, int N, int V) {
  constexpr int LD = D + kPad;
  constexpr int TT = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* x_s = w_s + TT;       // two buffers
  __nv_bfloat16* p_s = x_s + 2 * TT;   // (32 vocab, 32 rows): p^T

  const int v0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int rg = warp & 1;   // vocab rows rg*16 .. (both phases)
  const int cg = warp >> 1;  // logits: x rows cg*8 ..; product: D quarter

  load_rows_async<D>(w_s, w, v0, V, kTile);
  load_rows_async<D>(x_s, x, 0, N, kTile);
  cp_async_commit();

  const int v_a = v0 + rg * 16 + g;
  const int v_b = v_a + 8;

  float acc[D / 32][4];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_rt = (N + kTile - 1) / kTile;
  for (int j = 0; j < n_rt; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_rt) {
      load_rows_async<D>(x_s + (cur ^ 1) * TT, x, (j + 1) * kTile, N, kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xb = x_s + cur * TT;

    // logits^T (32 vocab x 32 rows) = W_tile x_tile^T.
    float c[1][4];
    tile_logits<D, 1>(c, w_s, rg * 16, xb, cg * 8);
    const int n = j * kTile + cg * 8 + 2 * tq;  // this thread's two rows of x
    const bool ok0 = n < N, ok1 = n + 1 < N;
    const float ls0 = ok0 ? lse[n] * kLog2e : 0.f;
    const float ls1 = ok1 ? lse[n + 1] * kLog2e : 0.f;
    const int t0 = ok0 ? t[n] : -1;
    const int t1 = ok1 ? t[n + 1] : -1;
    const bool valid[4] = {ok0 && v_a < V, ok1 && v_a < V, ok0 && v_b < V,
                           ok1 && v_b < V};
    const float ls[4] = {ls0, ls1, ls0, ls1};
    const bool hot[4] = {t0 == v_a, t1 == v_a, t0 == v_b, t1 == v_b};
    store_p(p_s, rg * 16 + g, cg * 8 + 2 * tq, c[0], valid, ls, hot);
    __syncthreads();

    tile_product<D>(acc, p_s, rg * 16, xb, cg * (D / 4));
    __syncthreads();
  }

  store_acc<D>(dw, acc, v_a, V, cg * (D / 4));
}

enum class Which { kFwd, kDx, kDw };

template <int D>
int launch(Which which, const void* x, const void* w, const void* t, void* a,
           void* b, int N, int V, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const int* tp = static_cast<const int*>(t);
  cudaError_t err;
  if (which == Which::kFwd) {
    static bool allowed[64] = {};
    err = allow_smem(fused_ce_fwd_kernel<D>, fwd_smem_bytes<D>(), allowed);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((N + kFwdRows - 1) / kFwdRows);
    fused_ce_fwd_kernel<D><<<blocks, kThreads, fwd_smem_bytes<D>(), stream>>>(
        xp, wp, tp, static_cast<float*>(a), static_cast<float*>(b), N, V);
  } else if (which == Which::kDx) {
    static bool allowed[64] = {};
    err = allow_smem(fused_ce_dx_kernel<D>, bwd_smem_bytes<D>(), allowed);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((N + kTile - 1) / kTile);
    fused_ce_dx_kernel<D><<<blocks, kThreads, bwd_smem_bytes<D>(), stream>>>(
        xp, wp, tp, static_cast<const float*>(a), static_cast<float*>(b), N, V);
  } else {
    static bool allowed[64] = {};
    err = allow_smem(fused_ce_dw_kernel<D>, bwd_smem_bytes<D>(), allowed);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((V + kTile - 1) / kTile);
    fused_ce_dw_kernel<D><<<blocks, kThreads, bwd_smem_bytes<D>(), stream>>>(
        xp, wp, tp, static_cast<const float*>(a), static_cast<float*>(b), N, V);
  }
  return (int)cudaGetLastError();
}

int dispatch(Which which, const void* x, const void* w, const void* t, void* a,
             void* b, int N, int V, int D, void* stream) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(which, x, w, t, a, b, N, V, st);
    case 128: return launch<128>(which, x, w, t, a, b, N, V, st);
    case 768: return launch<768>(which, x, w, t, a, b, N, V, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entries, bound with ctypes. x (N, D) and w (V, D) contiguous bf16,
// t (N,) int32, lse/tgt (N,) fp32, dx (N, D) and dw (V, D) fp32, all
// contiguous. Each launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported D or an empty input).
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
