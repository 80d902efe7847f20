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
// W * S); dq, dk, dv fp32 (B, W * S, H, hd), contiguous and 16-byte
// aligned. `pairs` holds the step's (rank, chunk) pairs, one per
// blockIdx.z. Two launches: one block per (64-row KV tile, batch * head,
// pair) adds into dk and dv of the chunk, then one block per (64-row query
// tile, batch * head, pair) adds into dq of the rank. Within a launch no two
// pairs share a rank or a chunk, so every block owns the rows it adds into:
// no atomics, and the same bits on every run.
//
// What bounds it on an H100: memory, narrowly, and most of it the fp32
// accumulators. Per pair at the training shape (B=16, S=256, H=12, hd=64,
// full mask) the work is 10 * hd flops per (query, key) pair, 8.1e9 flops
// (8.2 us at 989 TFLOP/s), against reading q, k, v, do (25.2 MB) and reading
// and writing the fp32 dq, dk, dv (75.5 MB): 30 us at 3.35 TB/s, about 80
// flops per byte. The first step reads no accumulator (63.3 MB per pair);
// one layer's 4 launches move 860 MB, 0.257 ms (chip_smoke.py:ring_bound).
//
// What the design does about it: the blocks are the splash backward's
// (attention_bwd.cuh, the design note in splash_attention_bwd.cu): s, p and
// ds stay in registers and shared memory, at 14 * hd flops per pair (the dq
// launch recomputes s and dp). The delta pass of the splash backward does
// not run: the caller computes delta once from the fp32 merged o. The
// accumulator bytes themselves:
// - The first step (`first`) writes dq, dk and dv and reads none of them
//   (adding into zeros is the block's own gradient), so the caller
//   allocates them uninitialised and nothing fills them.
// - At a later step the TMA reads each block's 64 x hd fp32 tiles (two boxes
//   of a 4D tensor map each, encode_acc_map in mma_sm90.cuh, grid constants
//   of the launch) into shared memory while the loop runs; the epilogue
//   waits on one mbarrier, adds there, and the TMA writes the tiles back
//   after a proxy fence and a barrier. Rows past a ragged S lie outside the
//   maps and are neither read nor written.
// - Occupancy is kept at 3 blocks per SM at hd=64 (registers capped at 168,
//   the parent design's count; the dk/dv kernel spills 8 bytes a thread,
//   16 at the first step) and 2 at hd=128 (shared memory). At hd=64 one
//   tile fits beside 3 blocks: the dq tile, or dk's, gets shared memory of
//   its own and is read before the main loop. dv, and at hd=128 every
//   tile, go into streamed buffers that the loop has freed, one iteration
//   ahead of the epilogue (dk at hd=128: once the last iteration's products
//   with K and V are done). attention_bwd.cuh:acc_early says where.
//
// Not yet done (later work): wgmma; TMA loads of the Q/K/V/dO tiles;
// persistent or warp-specialised blocks; a dk/dv launch that walks all the
// ranks a chunk meets with its accumulator in registers (one launch for all
// W steps, which the NCCL ring across processes cannot use); a kernel for
// the ring's fp32 delta (ring_delta in ops/ring_attention.py).

#include "attention_bwd.cuh"

namespace {

// Resident blocks per SM that the ring kernels keep: the parent design's 3
// at hd=64 (registers capped at 168) and 2 at hd=128 (shared memory).
template <int HD>
constexpr int kMinBlocks = HD == 64 ? 3 : 2;

// The ring step's kernels: the backward bodies (attention_bwd.cuh) over the
// step's (rank, chunk) pairs, with the fp32 accumulators' tensor maps as
// grid constants.
template <int HD, typename Mode>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
ring_attention_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int S,
    int H, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh,
    float scale_log2, float scale, int causal, const int* __restrict__ pairs,
    int world, const __grid_constant__ CUtensorMap dk_map,
    const __grid_constant__ CUtensorMap dv_map) {
  attention_bwd_dkv_body<HD, Mode>(q, k, v, dout, lse, delta, nullptr, nullptr,
                                   S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                   v_sb, v_ss, v_sh, d_sb, d_ss, d_sh,
                                   scale_log2, scale, causal, pairs, world,
                                   &dk_map, &dv_map);
}

template <int HD, typename Mode>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
ring_attention_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int S,
    int H, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh,
    float scale_log2, float scale, int causal, const int* __restrict__ pairs,
    int world, const __grid_constant__ CUtensorMap dq_map) {
  attention_bwd_dq_body<HD, Mode>(q, k, v, dout, lse, delta, nullptr, S, H,
                                  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                  v_ss, v_sh, d_sb, d_ss, d_sh, scale_log2,
                                  scale, causal, pairs, world, &dq_map);
}

}  // namespace

// Plain C entry, bound with ctypes. q, k, v, do strides (batch, seq, head) in
// elements; `pairs` a device array of n_pairs (rank, chunk) int pairs;
// `causal` the diagonal mask; `first` the ring's step 0, which writes dq, dk
// and dv and reads none of them. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported head dimension
// or grid).
extern "C" int ring_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, void* dk_acc,
    void* dv_acc, const void* pairs, int n_pairs, int world, int B, int S,
    int H, int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long d_sb, long long d_ss,
    long long d_sh, float scale, int causal, int first, void* stream) {
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
  return ring_dispatch(head_dim, first, [&](auto hd, auto mode) {
    constexpr int HD = decltype(hd)::value;
    using Mode = decltype(mode);
    auto dkv_kernel = ring_attention_bwd_dkv_kernel<HD, Mode>;
    auto dq_kernel = ring_attention_bwd_dq_kernel<HD, Mode>;
    constexpr int kSmemDkv = dkv_smem_bytes<HD, Mode>();
    constexpr int kSmemDq = dq_smem_bytes<HD, Mode>();
    static bool allowed_dkv[64] = {};
    static bool allowed_dq[64] = {};
    cudaError_t err = allow_smem(dkv_kernel, kSmemDkv, allowed_dkv);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(dq_kernel, kSmemDq, allowed_dq);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap dq_map, dk_map, dv_map;
    if ((err = encode_acc_map(&dq_map, dq_acc, B, world, S, H, HD)) != cudaSuccess ||
        (err = encode_acc_map(&dk_map, dk_acc, B, world, S, H, HD)) != cudaSuccess ||
        (err = encode_acc_map(&dv_map, dv_acc, B, world, S, H, HD)) != cudaSuccess)
      return (int)err;
    const dim3 grid((S + kBlock - 1) / kBlock, B * H, n_pairs);
    const float scale_log2 = scale * kLog2e;
    dkv_kernel<<<grid, kThreads, kSmemDkv, sm>>>(
        qp, kp, vp, dop, lsep, deltap, S, H, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2, scale,
        causal, pr, world, dk_map, dv_map);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dq_kernel<<<grid, kThreads, kSmemDq, sm>>>(
        qp, kp, vp, dop, lsep, deltap, S, H, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2, scale,
        causal, pr, world, dq_map);
    return (int)cudaGetLastError();
  });
}

// What the two kernels a step launches hold on an SM (kernel_resources in
// mma_sm90.cuh), the dk/dv kernel's five numbers then the dq kernel's, for
// head_dim and the first step or a later one.
extern "C" int ring_attention_bwd_resources(int head_dim, int first, int* out) {
  return ring_dispatch(head_dim, first, [&](auto hd, auto mode) {
    constexpr int HD = decltype(hd)::value;
    using Mode = decltype(mode);
    cudaError_t err = kernel_resources(ring_attention_bwd_dkv_kernel<HD, Mode>,
                                       kThreads, dkv_smem_bytes<HD, Mode>(), out);
    if (err != cudaSuccess) return (int)err;
    return (int)kernel_resources(ring_attention_bwd_dq_kernel<HD, Mode>,
                                 kThreads, dq_smem_bytes<HD, Mode>(), out + 5);
  });
}
