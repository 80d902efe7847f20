// One step of the ring attention backward for Hopper (sm_90a): for every
// (rank, chunk) pair that computes at this step, the dq, dk, dv of the rank's
// queries against the chunk's keys and values, added into fp32 accumulators.
//
// Replaces: ray_tpu/ops/ring_attention.py:_fused_ring_bwd (:242-312), the
// per-rotation fused splash dq/dk/dv kernel (sk._splash_attention_bwd_dkv,
// :270-278) and the accumulation that follows it (:302-308).
//
//   s = q_r k_c^T * scale + mask,  p = exp(s - lse_r),  delta_r given
//   dv_c += p^T do_r,  dp = do_r v_c^T,  ds = p * (dp - delta_r)
//   dq_r += scale * ds k_c,  dk_c += scale * ds^T q_r
//
// lse and delta are the ring forward's global ones (the merged lse, and
// rowsum(o * do) of the merged fp32 o), so the blocks' gradients sum to the
// exact gradient of the whole attention. dk and dv land in the chunk's own
// rows: where the JAX ring rotates the running dk, dv with their chunk so
// that after W steps they are back home (:302-308), the folded ring adds them
// there directly.
//
// Layout: as ring_attention_fwd.cu. q, k, v, do are the whole (B, W * S, H,
// hd) sequence in bf16 (strided views allowed); lse and delta fp32 (B, H,
// W * S); dq, dk, dv fp32 (B, W * S, H, hd), contiguous. `pairs` holds the
// step's (rank, chunk) pairs, one per blockIdx.z. Two launches: one block per
// (64-row KV tile, batch * head, pair) adds into dk and dv of the chunk, then
// one block per (64-row query tile, batch * head, pair) adds into dq of the
// rank. Within a launch no two pairs share a rank or a chunk, so every block
// owns the rows it adds into: no atomics, and the same bits on every run.
//
// What bounds it on an H100: memory, narrowly. Per pair at the training
// shape (B=16, S=256, H=12, hd=64, full mask) the work is 10 * hd flops per
// (query, key) pair, 8.1e9 flops (8.2 us at 989 TFLOP/s), against reading q,
// k, v, do (25.2 MB) and reading and writing the fp32 dq, dk, dv (75.5 MB):
// 30 us at 3.35 TB/s. The fp32 accumulators set the bound.
//
// What the design does about it: the blocks are the splash backward's
// (attention_bwd.cuh, the design note in splash_attention_bwd.cu): s, p and
// ds stay in registers and shared memory, at 14 * hd flops per pair (the dq
// launch recomputes s and dp). The accumulators are read and written once
// per step, in the blocks' epilogues. The delta pass of the splash backward
// does not run: the caller computes delta once from the fp32 merged o.
//
// Not yet done (later work): wgmma, TMA, and a dk/dv launch that walks all
// the ranks a chunk meets with its accumulator in registers.

#include "attention_bwd.cuh"

// Plain C entry, bound with ctypes. q, k, v, do strides (batch, seq, head) in
// elements; `pairs` a device array of n_pairs (rank, chunk) int pairs;
// `causal` the diagonal mask. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported head dimension
// or grid).
extern "C" int ring_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, void* dk_acc,
    void* dv_acc, const void* pairs, int n_pairs, int world, int B, int S,
    int H, int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long d_sb, long long d_ss,
    long long d_sh, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || n_pairs <= 0 ||
      n_pairs > world || world > 65535)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, d_sb, d_ss, d_sh};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lsep = static_cast<const float*>(lse);
  const float* deltap = static_cast<const float*>(delta);
  const int* pr = static_cast<const int*>(pairs);
  cudaStream_t sm = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return launch_bwd_dkv_dq<64, RingStepMode>(
        qp, kp, vp, dop, lsep, deltap, dq_acc, dk_acc, dv_acc, B, S, H, st,
        scale, causal, pr, n_pairs, world, sm);
  }
  if (head_dim == 128) {
    return launch_bwd_dkv_dq<128, RingStepMode>(
        qp, kp, vp, dop, lsep, deltap, dq_acc, dk_acc, dv_acc, B, S, H, st,
        scale, causal, pr, n_pairs, world, sm);
  }
  return (int)cudaErrorInvalidValue;
}
