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
// contiguous and 16-byte aligned; a later step reads and rewrites a rank's
// rows in place. Within one launch no two pairs share a rank, so no two
// blocks touch the same rows.
//
// What bounds it on an H100: memory, and most of it the fp32 accumulators.
// Per (rank, chunk) pair at the training shape (B=16, S=256, H=12, hd=64) a
// later step reads q, k, v (18.9 MB of bf16) and reads and writes o_acc and
// lse_acc (25.6 MB), against 1.6e9 flops (diag) or 3.2e9 (full): 36 to 72
// flops per byte, far below the ~295 where the tensor cores become the
// limit. The first step reads no accumulator: 31.7 MB per pair. One layer's
// 4 launches (4 first-step and 6 later pairs) move 393 MB, 0.117 ms at
// 3.35 TB/s (chip_smoke.py:ring_bound).
//
// What the design does about it: the block is the splash forward's
// (attention_fwd.cuh, the design note in splash_attention_fwd.cu): scores and
// probabilities stay in registers and shared memory. Its epilogue does the
// merge: the block's unnormalised output and its row sums never reach
// device memory, and the running output moves once per step in fp32, where
// the JAX merge makes five elementwise passes over it and rounds the block's
// output to bf16 first. The accumulator bytes themselves:
// - The first step (`first`) writes o_acc and lse_acc and reads neither:
//   merging into o = 0, lse = -1e30 gives exactly the block's own (acc / l,
//   lse_b), so the caller allocates them uninitialised and nothing fills
//   them. The ring's outputs are equal bit for bit to the form that merged
//   into zeros.
// - At a later step one thread has the TMA read the block's 64 x hd fp32
//   tile of o_acc (two boxes of a 4D tensor map, encode_acc_map in
//   mma_sm90.cuh, a grid constant of the launch) into shared memory past
//   the K/V buffers before the main loop starts, and each thread reads its
//   rows' lse; the epilogue waits on the tile's mbarrier and merges there.
//   So the read overlaps the QK/PV loop instead of following it.
// - The merged tile (the first step stages its tile in the freed K/V
//   buffers) goes back by TMA stores after a proxy fence and a barrier:
//   whole boxes, no thread's registers on the copy. Rows past a ragged S
//   lie outside the map and are neither read nor written.
// - Occupancy: 3 blocks per SM at hd=64 (registers; 52 KB of shared memory
//   at a later step) and 2 at hd=128, as in the design without the tile
//   (ring_attention_fwd_resources); the first step, 128 registers, keeps 4.
//
// Not yet done (later work): wgmma; TMA loads of the Q/K/V tiles;
// persistent or warp-specialised blocks; one launch that walks all W steps
// of a rank with its accumulator in registers (it would move o_acc once
// instead of once per step, but the step-per-launch form is the one an NCCL
// ring across processes needs, and at this form's bound, 0.117 ms per
// layer, it stays above SDPA's 0.084 ms); a swizzled tile, whose dense rows
// give the epilogue's float2 accesses 4-way bank conflicts.

#include "attention_fwd.cuh"

namespace {

// The ring step's kernel: the attention body (attention_fwd.cuh) over the
// step's (rank, chunk) pairs, with the running output's tensor map as a
// grid constant.
template <int HD, typename Mode>
__global__ void __launch_bounds__(kThreads)
ring_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          float* __restrict__ lse, int S, int H,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          float scale_log2, int causal,
                          const int* __restrict__ pairs, int world,
                          const __grid_constant__ CUtensorMap o_map) {
  attention_fwd_body<HD, Mode>(q, k, v, nullptr, lse, S, H, q_sb, q_ss, q_sh,
                               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale_log2,
                               causal, pairs, world, &o_map);
}

}  // namespace

// Plain C entry, bound with ctypes. q, k, v strides (batch, seq, head) in
// elements; `pairs` a device array of n_pairs (rank, chunk) int pairs;
// `causal` the diagonal mask (the step where each rank holds its own chunk);
// `first` the ring's step 0, which writes o_acc and lse_acc and reads
// neither. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported head dimension or grid).
extern "C" int ring_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o_acc, void* lse_acc, const void* pairs,
                                  int n_pairs, int world, int B, int S, int H,
                                  int head_dim, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb,
                                  long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss,
                                  long long v_sh, float scale, int causal,
                                  int first, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || n_pairs <= 0 ||
      n_pairs > world || world > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  return ring_dispatch(head_dim, first, [&](auto hd, auto mode) {
    constexpr int HD = decltype(hd)::value;
    using Mode = decltype(mode);
    auto kernel = ring_attention_fwd_kernel<HD, Mode>;
    constexpr int kSmem = fwd_smem_bytes<HD, Mode>();
    static bool allowed[64] = {};
    cudaError_t err = allow_smem(kernel, kSmem, allowed);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap o_map;
    err = encode_acc_map(&o_map, o_acc, B, world, S, H, HD);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H, n_pairs);
    kernel<<<grid, kThreads, kSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<float*>(lse_acc), S, H, q_sb,
        q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
        scale * 1.4426950408889634f, causal, static_cast<const int*>(pairs),
        world, o_map);
    return (int)cudaGetLastError();
  });
}

// What the kernel a step launches holds on an SM (kernel_resources in
// mma_sm90.cuh: registers, spill bytes, static and dynamic shared bytes,
// resident blocks), for head_dim and the first step or a later one.
extern "C" int ring_attention_fwd_resources(int head_dim, int first, int* out) {
  return ring_dispatch(head_dim, first, [&](auto hd, auto mode) {
    constexpr int HD = decltype(hd)::value;
    using Mode = decltype(mode);
    return (int)kernel_resources(ring_attention_fwd_kernel<HD, Mode>, kThreads,
                                 fwd_smem_bytes<HD, Mode>(), out);
  });
}
