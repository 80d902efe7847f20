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
// What bounds it on an H100: memory. At the serving shapes (S=1024, 12 heads,
// hd=64) the causal half of q k^T and p v is ~64 flops per byte of q, k, v and
// o, well below the ~295 flops per byte where the tensor cores become the
// limit. The least time is then reading q, k, v once and writing o once.
//
// What the design does about it: one block of four warps owns a 64-row query
// tile of one (batch, head) and streams 64-row K and V tiles through shared
// memory, keeping the scores, the running max and the running sum in registers
// (flash attention's online softmax). Neither the (S, S) scores nor the
// probabilities ever reach device memory, so q, k, v and o are the only
// traffic, with K and V re-read once per query tile from L2. A causal block
// stops its KV loop at the diagonal tile, so the upper triangle costs nothing;
// blocks are issued longest-first. The K and V tiles are double-buffered:
// cp.async brings tile j+1 into one buffer while the block computes on tile j
// in the other, so load latency overlaps the math. Products run on the tensor
// cores through mma.sync m16n8k16 (bf16 operands, fp32 accumulators), their K
// and V operands read from shared memory with ldmatrix (.trans for V, which
// stays row-major). The probabilities go from the score accumulators straight
// into the A operand of the p v product without leaving registers. Shared rows
// are padded by 16 bytes so the fragment loads are free of bank conflicts.
//
// Not yet done (later work): wgmma, TMA loads, warp specialisation, and a
// split over KV for small batches (at B=1 the longest causal block walks all
// S/64 KV tiles in series).
//
// Inputs may be strided views (q, k, v split from the fused qkv projection
// have a row stride of 3*D): every row of hd elements must be contiguous and
// 16-byte aligned, which the Python wrapper checks. Rows past S are read as
// zeros and never written.
//
// The code is in attention_fwd.cuh, shared with the ring step
// (ring_attention_fwd.cu).

#include "attention_fwd.cuh"

// Plain C entry, bound with ctypes. Strides are in elements; o is written
// contiguous (B, S, H, hd) and lse contiguous (B, H, S). Launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// head dimension or grid).
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
  if (head_dim == 64) {
    return launch_fwd<64, SplashMode>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh,
                                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                                      causal, nullptr, 1, 1, st);
  }
  if (head_dim == 128) {
    return launch_fwd<128, SplashMode>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh,
                                       k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                                       causal, nullptr, 1, 1, st);
  }
  return (int)cudaErrorInvalidValue;
}
