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
// What bounds it on an H100: operations, narrowly. At the training shape
// (B=16, S=1024, 12 heads, hd=64, causal) the work is 10*hd flops for each
// kept (query, key) pair (the four products of the gradient and the score
// recompute), 6.5e10 flops, against ~2e8 bytes of q, k, v, o, do, dq, dk, dv,
// lse and delta: both are ~0.06 ms on the card.
//
// What the design does about it: the TPU kernel carries the dq sum along its
// sequential grid; Hopper runs blocks in no order, so the work is split into
// three launches that need no atomics and give the same bits on every run:
//   (a) delta: rowsum(o * do) in fp32, (B, H, S); skipped when the caller
//       passes its own delta (the ring backward does);
//   (b) dk, dv: one block per (64-row KV tile, batch*head) walks the query
//       tiles from the causal diagonal on, recomputing s, p and dp per tile
//       and keeping dk and dv in registers;
//   (c) dq: one block per (64-row query tile, batch*head) walks the KV tiles
//       up to the diagonal, keeping dq in registers.
// Neither s, p nor ds ever reaches device memory. The cost is one more score
// and dp product per pair than a kernel that accumulates dq with atomics
// (14*hd flops per pair instead of 10*hd). Products run on the tensor cores
// through mma.sync m16n8k16 (bf16 operands, fp32 accumulators), operands read
// from shared memory with ldmatrix (.trans where the product contracts over
// rows); p and ds go from accumulators straight into A operands as bf16, as
// the forward does with p. The streamed tiles are double-buffered with
// cp.async, so the next tile's load overlaps this tile's math.
//
// Numerics: the forward's lse is natural-log; the kernels work in base 2
// (exp2 of s * scale * log2(e) - lse * log2(e)). A masked (query, key) pair
// gets p = 0 by assignment, never by exp of the mask value, so no inf or NaN
// can leak from a masked score. The port scales the fp32 scores, where JAX
// scales q in bf16 before the kernel, so dq and dk carry the scale explicitly.
//
// Not yet done (later work): wgmma, TMA loads, warp specialisation, and one
// fused dkv+dq pass with fp32 atomics for dq.
//
// Inputs may be strided views (q, k, v split from the fused qkv have a row
// stride of 3*D): every row of hd elements must be contiguous and 16-byte
// aligned, which the Python wrapper checks. Rows past S are read as zeros and
// never written.

//
// The code is in attention_bwd.cuh, shared with the ring step
// (ring_attention_bwd.cu).

#include "attention_bwd.cuh"

namespace {

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int S, int H, const long long st[15], float scale,
           int causal, int compute_delta, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* op = static_cast<const bf16*>(o);
  const bf16* dop = static_cast<const bf16*>(dout);
  float* deltap = static_cast<float*>(delta);
  // st: q, k, v, o, do strides (batch, seq, head), in elements.
  if (compute_delta) {
    const long long threads = (long long)B * S * H * (HD / 8);
    const unsigned blocks = (unsigned)((threads + 255) / 256);
    attention_bwd_delta_kernel<HD><<<blocks, 256, 0, stream>>>(
        op, dop, deltap, B, S, H, st[9], st[10], st[11], st[12], st[13], st[14]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long qkvd[12] = {st[0], st[1], st[2],  st[3],  st[4],  st[5],
                              st[6], st[7], st[8], st[12], st[13], st[14]};
  return launch_bwd_dkv_dq<HD, SplashMode>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), dop, static_cast<const float*>(lse), deltap,
      dq, dk, dv, B, S, H, qkvd, scale, causal, nullptr, 1, 1, stream);
}

}  // namespace

// Plain C entry, bound with ctypes. Strides are in elements; dq, dk, dv are
// written contiguous (B, S, H, hd); lse and delta are contiguous (B, H, S)
// fp32. With compute_delta the kernel writes delta = rowsum(o * do) first;
// otherwise it reads the caller's delta (and never reads o). Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported head dimension or grid).
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
  const long long st[15] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                            v_sh, o_sb, o_ss, o_sh, d_sb, d_ss, d_sh};
  cudaStream_t sm = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, st,
                      scale, causal, compute_delta, sm);
  }
  if (head_dim == 128) {
    return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, st,
                       scale, causal, compute_delta, sm);
  }
  return (int)cudaErrorInvalidValue;
}
