// Warp-level building blocks shared by the port's Hopper (sm_90a) kernels:
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators), ldmatrix operand
// loads from shared memory, cp.async global -> shared copies, bf16 packing,
// and the once-per-device opt-in to more than 48 KB of shared memory.
//
// Included by each source under csrc/; every source is its own translation
// unit and shared library, so the helpers live in an unnamed namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Mode tags of the attention bodies (attention_fwd.cuh, attention_bwd.cuh):
// the splash kernel over one whole sequence, or one ring step over (rank,
// chunk) pairs. A tag is a type, so that it shows in the kernel's name.
struct SplashMode { static constexpr bool kRing = false; };
struct RingStepMode { static constexpr bool kRing = true; };

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 b16 matrices; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed (for a product that contracts over
// the rows of a row-major tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Two floats into one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (rows r0..r0+15, k-step kk) of a row-major shared tile with row
// stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* tile,
                                       int r0, int kk) {
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
  ldmatrix_x4(a, tile + (r0 + (mi & 1) * 8 + mr) * LD + kk * 16 + (mi >> 1) * 8);
}

// Above 48 KB a block's shared memory must be allowed explicitly. Once per
// device and kernel (`allowed` is the kernel's own flag array), so that no
// launch inside a CUDA-graph capture makes the call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool allowed[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
