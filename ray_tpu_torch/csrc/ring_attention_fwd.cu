// One step of the ring attention forward for Hopper (sm_90a): every rank
// that computes at this step attends its bf16 query shard to one bf16 K/V
// chunk and merges the result into its running fp32 output and lse.
//
// Replaces: ray_tpu/ops/ring_attention.py:_fused_ring_fwd (:200-239), the
// per-rotation splash kernel with residuals (_block_kernel :148-173) and the
// logaddexp merge that follows it (:232-234).
//
//   o_b, lse_b = attention(q_r, k_c, v_c)        diag (causal) or full mask
//   lse_new    = logaddexp(lse_acc, lse_b)
//   o_acc      = o_acc * exp(lse_acc - lse_new) + o_b * exp(lse_b - lse_new)
//
// Layout: the seq axis of W ranks is folded onto one device. q, k, v are the
// whole (B, W * S, H, hd) sequence, rank r's shard being rows r*S .. r*S+S-1
// (S = one shard), and may be strided views of the fused qkv. The launch for
// one ring step covers every (rank, source chunk) pair that computes at that
// step: the host passes them as a device array `pairs`, one pair per
// blockIdx.z, so the grid is (query tiles, B * H, pairs) and the kernel adds
// rank * S and chunk * S rows to its offsets. No copy of q, k, v into a
// (W, B, S, H, hd) layout is made. Which chunk a rank holds at a
// step, and which ranks skip, is decided on the host
// (ray_tpu_torch/ops/ring_attention.py:ring_source), not here.
// o_acc is fp32 (B, W * S, H, hd) and lse_acc fp32 (B, H, W * S), both
// contiguous; the step reads and rewrites a rank's rows in place. Within one
// launch no two pairs share a rank, so no two blocks touch the same rows.
//
// What bounds it on an H100: memory. Per (rank, chunk) pair at the training
// shape (B=16, S=256, H=12, hd=64) it reads q, k, v (18.9 MB of bf16) and
// reads and writes the fp32 o_acc and lse_acc (25.6 MB), against 1.6e9 flops
// (diag) or 3.2e9 (full): 36 to 72 flops per byte, far below the ~295 where
// the tensor cores become the limit.
//
// What the design does about it: the block is the splash forward's
// (attention_fwd.cuh, the design note in splash_attention_fwd.cu): scores and
// probabilities stay in registers and shared memory. Its epilogue does the
// merge: the block's unnormalised output and its row sums never reach
// device memory, and the running output is read and written once per step in
// fp32, where the JAX merge makes five elementwise passes over it and rounds
// the block's output to bf16 first. From o_acc = 0, lse_acc = -1e30 a step
// gives exactly the block's own (o_b, lse_b).
//
// Not yet done (later work): wgmma, TMA, and one launch that walks all W
// steps of a rank with its accumulator in registers (it would read and write
// o_acc once instead of once per step; the step-per-launch form is the one
// an NCCL ring across processes needs).

#include "attention_fwd.cuh"

// Plain C entry, bound with ctypes. q, k, v strides (batch, seq, head) in
// elements; `pairs` a device array of n_pairs (rank, chunk) int pairs;
// `causal` the diagonal mask (the step where each rank holds its own chunk).
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported head dimension or grid).
extern "C" int ring_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o_acc, void* lse_acc, const void* pairs,
                                  int n_pairs, int world, int B, int S, int H,
                                  int head_dim, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb,
                                  long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss,
                                  long long v_sh, float scale, int causal,
                                  void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || n_pairs <= 0 ||
      n_pairs > world || world > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* pr = static_cast<const int*>(pairs);
  if (head_dim == 64) {
    return launch_fwd<64, RingStepMode>(q, k, v, o_acc, lse_acc, B, S, H, q_sb,
                                        q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                        v_sh, scale, causal, pr, n_pairs, world,
                                        st);
  }
  if (head_dim == 128) {
    return launch_fwd<128, RingStepMode>(q, k, v, o_acc, lse_acc, B, S, H, q_sb,
                                         q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                         v_sh, scale, causal, pr, n_pairs, world,
                                         st);
  }
  return (int)cudaErrorInvalidValue;
}
