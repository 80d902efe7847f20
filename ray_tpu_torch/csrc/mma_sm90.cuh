// Warp-level building blocks shared by the port's Hopper (sm_90a) kernels:
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators), ldmatrix operand
// loads from shared memory, cp.async global -> shared copies, bf16 packing,
// the once-per-device opt-in to more than 48 KB of shared memory, and what
// the ring step kernels add: TMA tensor copies and their mbarriers, tensor
// maps (an fp32 accumulator's among them), the accumulator's shared-memory
// tile, and a kernel's registers, shared memory and resident blocks.
//
// Included by each source under csrc/; every source is its own translation
// unit and shared library, so the helpers live in an unnamed namespace.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Mode tags of the ring step's attention bodies (attention_fwd.cuh,
// attention_bwd.cuh), which run over (rank, chunk) pairs. A tag is a type,
// so that it shows in the kernel's name. kFirst: the ring's step 0, where
// every rank holds its own chunk, so the step covers every row and writes
// the accumulators without reading them.
struct RingStepMode { static constexpr bool kRing = true, kFirst = false; };
struct RingFirstStepMode { static constexpr bool kRing = true, kFirst = true; };

// Returns go(std::integral_constant<int, HD>{}, Mode{}) for head_dim (64 or
// 128) and the ring step's kind; cudaErrorInvalidValue for another head_dim.
template <typename Go>
int ring_dispatch(int head_dim, int first, Go go) {
  using HD64 = std::integral_constant<int, 64>;
  using HD128 = std::integral_constant<int, 128>;
  if (head_dim == 64)
    return first ? go(HD64{}, RingFirstStepMode{}) : go(HD64{}, RingStepMode{});
  if (head_dim == 128)
    return first ? go(HD128{}, RingFirstStepMode{}) : go(HD128{}, RingStepMode{});
  return (int)cudaErrorInvalidValue;
}

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

// Hopper's Tensor Memory Accelerator (TMA) and the mbarrier it reports to:
// one thread asks for a whole box to be copied between device memory and
// shared memory and spends no registers on the data.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes an mbarrier's initialisation visible to the copy engine.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on the barrier and adds `bytes` to the transfer it waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Tensor-map copies of one box (cp.async.bulk.tensor, 4D tile mode).
// global -> shared, completing the box's bytes of the barrier's transfer;
// elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tensor_load(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in the issuing thread's current bulk group; elements
// outside the tensor are not written.
__device__ __forceinline__ void tensor_store(const CUtensorMap* map, int c0,
                                             int c1, int c2, int c3,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(src)
      : "memory");
}

// Closes the issuing thread's bulk group and waits until the copy engine
// has read its sources, so that the shared memory may be left or reused.
__device__ __forceinline__ void bulk_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n"
               "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Two floats at a shared-window address.
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts2(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

// Orders this thread's ordinary shared-memory accesses before later bulk
// copies (the copy engine is another proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 4D tiled tensor map of `type` elements at `base`: dims innermost first,
// strides in bytes of dims 1-3, `box` the elements of one copy, `swizzle`
// the layout the box takes in shared memory. Elements outside dims are read
// as zeros and never written. Encoded on the host through
// cudaGetDriverEntryPoint, so that nothing links libcuda.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type,
                              void* base, const cuuint64_t dims[4],
                              const cuuint64_t strides[3],
                              const cuuint32_t box[4],
                              CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, type, 4, base, dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A ring accumulator, fp32 contiguous (B, world * S, H, HD), as the 4D
// tensor {HD, H, S, B * world} whose boxes are 32 rows of one head
// {HD, 1, 32, 1}: the rows of one rank's shard end at S, so the copy engine
// reads rows past a ragged S as zeros and writes none of them.
inline cudaError_t encode_acc_map(CUtensorMap* map, void* base, int B,
                                  int world, int S, int H, int HD) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B * world};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 4, (cuuint64_t)H * HD * 4,
                                 (cuuint64_t)S * H * HD * 4};
  const cuuint32_t box[4] = {(cuuint32_t)HD, 1, 32, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// A ring step's fp32 accumulator tile in shared memory: 64 rows of HD
// floats of one head, rows 0-31 at half[0] and rows 32-63 at half[1]
// (shared-window addresses, 32 bits each), each half one box of
// encode_acc_map (dense rows, 128-byte aligned). A half fits in one 64-row
// bf16 tile of the attention bodies (HD + 8 bf16 per row), so a tile also
// fits in two bf16 buffers that a loop has freed.
template <int HD>
struct AccTile {
  static constexpr int kBytes = 64 * HD * 4;
  uint32_t half[2];

  // The address of row r. (A select, not half[r >> 5]: an indexed array
  // would live in local memory.)
  __device__ __forceinline__ uint32_t row(int r) const {
    return (r < 32 ? half[0] : half[1]) + (r & 31) * HD * 4;
  }

  // One thread: starts reading rows row0 .. row0 + 63 of head h of shard
  // bw = batch * world + rank, as one arrival on `bar` that expects them.
  __device__ __forceinline__ void load(const CUtensorMap* map, int h, int row0,
                                       int bw, uint64_t* bar) const {
    mbar_expect_tx(bar, kBytes);
    tensor_load(half[0], map, 0, h, row0, bw, bar);
    tensor_load(half[1], map, 0, h, row0 + 32, bw, bar);
  }

  // One thread, after every writer's fence_proxy_async() and a barrier:
  // writes the rows back and waits until the copy engine has read them.
  __device__ __forceinline__ void store(const CUtensorMap* map, int h, int row0,
                                        int bw) const {
    tensor_store(map, 0, h, row0, bw, half[0]);
    tensor_store(map, 0, h, row0 + 32, bw, half[1]);
    bulk_store_drain();
  }
};

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

// What a kernel holds on an SM, launched with `threads` threads and `smem`
// bytes of dynamic shared memory: out = {registers per thread, local
// (spill) bytes per thread, static shared bytes, dynamic shared bytes,
// resident blocks per SM}.
template <typename Kernel>
cudaError_t kernel_resources(Kernel kernel, int threads, int smem, int out[5]) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = smem;
  out[4] = blocks;
  return err;
}

}  // namespace
