// Hopper's warpgroup matrix multiply (wgmma) and the TMA tile loads that
// feed it, for the kernels written around them (splash_attention_fwd.cu,
// splash_attention_bwd.cu, and the fused-CE forward and backward in
// fused_ce.cu):
// - the tensor map of a bf16 (B, S, H, hd) operand, strided views of a
//   fused qkv included, whose boxes of 64 rows by 64 columns of one head
//   land in shared memory with the 128-byte swizzle that wgmma reads;
// - the shared-memory matrix descriptor of such a tile, read K-major (the
//   contracted dimension along the rows) or MN-major (the transposed read of
//   a row-major tile);
// - m64n32k16, m64n64k16 and m64n256k16 with both operands in shared
//   memory, m64n64k16 and m64n128k16 with A in registers, bf16 operands and
//   fp32 accumulators, and the fence, commit and wait that order them;
// - for thread-block clusters: the block's rank, the cluster-wide barrier,
//   an mbarrier arrival on another block of the cluster, and the TMA copy
//   that multicasts one box into several blocks' shared memory.
// A warpgroup (four consecutive warps, 128 threads) issues each product
// together, and it runs asynchronously until a wait. The accumulator of a
// m64nNk16 gives warp w rows 16w .. 16w + 15 and, in each 8-column chunk c,
// d[4c .. 4c + 3] = (row g, cols 2t, 2t + 1), (row g + 8, the same cols)
// for lane 4g + t: the C fragment of mma.sync m16n8k16 per chunk. The A
// operand from registers is the m16n8k16 A fragment of the warp's 16 rows.

#pragma once

#include "mma_sm90.cuh"

namespace {

// A box: 64 rows of 64 bf16, one 128-byte swizzled row each, 8 KB (eight
// 1024-byte swizzle atoms). A tile of hd columns is hd / 64 boxes side by
// side, kBoxBytes apart.
constexpr int kBoxCols = 64;
constexpr int kBoxRows = 64;
constexpr int kBoxBytes = kBoxRows * kBoxCols * 2;

// q, k or v, bf16 (B, S, H, HD) with element strides (sb, ss, sh) and
// contiguous rows, as the tensor {HD, H, S, B}: the strides need only be
// multiples of 16 bytes, so a view split from the fused qkv needs no copy.
// Rows past S lie outside the tensor.
inline cudaError_t encode_bf16_tile_map(CUtensorMap* map, const void* base,
                                        int B, int S, int H, int HD,
                                        long long sb, long long ss,
                                        long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBoxRows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    const_cast<void*>(base), dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// One thread: starts loading rows row0 .. row0 + 63 of head h of batch b,
// all HD columns, into the tile at shared address dst (1024-byte aligned),
// as one arrival on `bar` that expects them. Rows past S arrive as zeros.
template <int HD>
__device__ __forceinline__ void load_bf16_tile(uint32_t dst,
                                               const CUtensorMap* map, int h,
                                               int row0, int b,
                                               uint64_t* bar) {
  mbar_expect_tx(bar, HD / kBoxCols * kBoxBytes);
#pragma unroll
  for (int c = 0; c < HD / kBoxCols; ++c)
    tensor_load(dst + c * kBoxBytes, map, c * kBoxCols, h, row0, b, bar);
}

// The wgmma descriptor of a 128-byte-swizzled bf16 tile at shared address
// addr: 8-row atoms `sbo` bytes apart; for an MN-major operand, 64-column
// atoms side by side `lbo` bytes apart (a K-major operand ignores lbo).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// A descriptor moved `bytes` further into shared memory (bytes % 16 == 0).
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// K-major tile of HD columns: descriptor of its k-step kk (columns
// 16kk .. 16kk + 15), in box kk / 4, 32 bytes per k-step within the box.
__device__ __forceinline__ uint64_t kmajor_step(uint64_t tile, int kk) {
  return desc_at(tile, (kk / 4) * kBoxBytes + (kk % 4) * 32);
}

// Orders this warpgroup's register and shared-memory accesses before the
// wgmma that follow; needed before the first and after any write of their
// accumulator or A registers.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Closes the wgmma issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of r across the asm around it:
// a wgmma reads its accumulator and A registers and writes the accumulator
// asynchronously, so they are written before wgmma_fence() and read after
// the wait that retires it.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

// d (64 x 64, fp32) = a b, or d + a b when `accumulate`: a (64 x 16) and
// b (16 x 64) bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_64x64x16_ss(float (&d)[32], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, fp32) = a b, or d + a b when `accumulate`: a (64 x 16) and
// b (16 x 32) bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_64x32x16_ss(float (&d)[16], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256, fp32) = a b, or d + a b when `accumulate`: a (64 x 16) and
// b (16 x 256) bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_64x256x16_ss(float (&d)[128], uint64_t a,
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += a b: a (64 x 16, bf16) in registers, b (16 x 64,
// bf16) MN-major in shared memory.
__device__ __forceinline__ void wgmma_64x64x16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += a b: a (64 x 16, bf16) in registers, b (16 x 128,
// bf16) MN-major in shared memory.
__device__ __forceinline__ void wgmma_64x128x16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x HD) += a b for HD 64 or 128, a in registers, b MN-major.
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  if constexpr (HD == 64)
    wgmma_64x64x16_rs(d, a, b);
  else
    wgmma_64x128x16_rs(d, a, b);
}

// ---- Thread-block clusters (the fused-CE forward) ----

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: this block's earlier shared
// writes and barrier initialisations are visible to the others after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Arrives on the mbarrier at `bar`'s shared offset in block `cta` of the
// cluster (this block's own included). The release is the default, at CTA
// scope, as CUTLASS's cluster pipeline has it: what it orders before a
// peer's copy into the buffer (wgmma's reads) is complete at
// wgmma.wait_group. `.release.cluster` here, with an `.acquire.cluster`
// wait, cost a cluster-wide fence per buffer: the fused-CE forward took
// twice as long (PERF.md, Findings).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(cta) : "memory");
}

// As tensor_load, the box landing at shared offset dst of every block in
// `mask` (bit r: cluster rank r), each block's barrier at `bar`'s offset
// completing the box's bytes.
__device__ __forceinline__ void tensor_load_multicast(
    uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// 2^x by the SFU's approximation (relative error ~2^-22), subnormals
// flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Threads `count` (a multiple of 32) of the block wait for each other at
// named barrier `id` (1-15; 0 is __syncthreads()).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Arrives at named barrier `id` without waiting: the threads that wait there
// with named_barrier_sync(id, count) go on once `count` threads in all have
// come.
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

}  // namespace
