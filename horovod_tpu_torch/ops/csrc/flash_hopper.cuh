// Hopper building blocks for the port's kernels: mbarriers, TMA tile and
// bulk loads, shared-memory matrix descriptors and the warpgroup matrix
// products (wgmma) the flash-attention kernels use: bf16 or f16 operands,
// and tf32 with the operand split of the f32 kernels.  Inline PTX only, so
// the build needs nothing but nvcc; wgmma needs the sm_90a target
// (_build.NVCC_FLAGS).
//
// Shared-memory tiles.  An [R, D] tile of ES-byte elements (2: bf16 or
// f16; 4: f32) is stored as D / BOX boxes of [R, BOX] (W = min(128, D ES)
// bytes per row, BOX = W / ES columns), each box laid out by TMA with the
// W-byte swizzle, one box after the other.  wgmma reads such a tile two
// ways through its matrix descriptor:
// * K-major (the reduction runs along D, as for Q and K in Q.K^T): rows
//   are W bytes apart, 8-row groups 8 W apart (SBO); a 32-byte step kk
//   (16 values of bf16, 8 of tf32) starts (32 kk / W) boxes and (32 kk mod
//   W) bytes in.
// * MN-major (the reduction runs along the rows, as for V in P.V; 16-bit
//   types only): a 16-deep step starts 16 kk rows in; the next BOX columns
//   sit one box further (LBO = R W), the next 8 rows 8 W further (SBO).
// Every tile starts on a 1024-byte boundary, the period of the widest
// swizzle, so the descriptors' base offset stays 0.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hop {

template <int D, int ES = 2>
struct Swizzle {
  static constexpr int W = D * ES >= 128 ? 128 : D * ES;  // bytes per row
  static constexpr int BOX = W / ES;                      // columns per box
  static constexpr int NBOX = D / BOX;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte.
  static constexpr int LAYOUT = W == 128 ? 1 : (W == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle TMA =
      W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
  static_assert(D % BOX == 0 && W >= 32, "an extent of 32 bytes or more");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// Rows [r0, r0 + 64) of an R-row tile as the K-major operand of step kk.
template <int D, int R, int ES = 2>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int r0, int kk) {
  using S = Swizzle<D, ES>;
  const uint32_t off =
      (kk * 32 / S::W) * R * S::W + r0 * S::W + (kk * 32) % S::W;
  return desc(tile + off, 16, 8 * S::W, S::LAYOUT);
}

// Rows [16 kk, 16 kk + 16) of an R-row tile, all D columns, as the
// MN-major B operand of step kk.
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using S = Swizzle<D>;
  return desc(tile + kk * 16 * S::W, R * S::W, 8 * S::W, S::LAYOUT);
}

// The shared address of the 16-byte chunk c of row r of an R-row tile
// (columns [8 c, 8 c + 8) of a 2-byte type, [4 c, 4 c + 4) of f32), for
// plain loads and stores: the swizzle XORs the chunk's index in its W-byte
// row with bits of the row (CUTLASS's Swizzle<B, 4, 3>, which is what TMA
// writes).
template <int D, int R, int ES = 2>
__device__ __forceinline__ uint32_t chunk_addr(uint32_t tile, int r, int c) {
  using S = Swizzle<D, ES>;
  constexpr int CPB = S::W / 16;  // chunks per box row
  const uint32_t off = r * S::W + (c % CPB) * 16;
  return tile + (c / CPB) * R * S::W + (off ^ ((off >> 3) & ((CPB - 1) << 4)));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of the given parity to complete.  A wait that lasts
// about ten seconds can only be a lost arrival or a lost copy: it traps, so
// the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA: one [R, D] tile, as D / BOX box loads of a 4-D map (d, t, h, b)
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so the libraries link no -lcuda.  The caller makes a context
// current first (any runtime call on the device does).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// Orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy ones (wgmma reads, TMA writes): after threads
// write an operand tile that wgmma will read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One contiguous run of bytes (16-byte aligned at both ends, a multiple
// of 16 long) from device memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

template <int D, int R, int ES = 2>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int t0, int h, int b) {
  using S = Swizzle<D, ES>;
#pragma unroll
  for (int i = 0; i < S::NBOX; ++i)
    tma_load_4d(dst + i * R * S::W, map, bar, i * S::BOX, t0, h, b);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers,
// or reusing the registers of A operands, across the asynchronous
// products' commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// A barrier among the `threads` threads (a multiple of 32) that name the
// same id (1-15; 0 is __syncthreads), e.g. one warpgroup.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Register reallocation between warpgroups (sm_90a): a producer gives
// registers back, consumers take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The element types of the Hopper kernels' operands: bf16 and f16, each
// with its TMA data type, its conversions and its wgmma type name (the
// HOP_* macros below take it as a string to splice into the instruction).
template <typename E>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // Two floats rounded to the element type, packed (lo in the low half).
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ float to_float(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename E>
constexpr bool is_f16 = std::is_same<E, __half>::value;

#define HOP_SS32(TY)                                                         \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15])                                                          \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOP_SS64(TY)                                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
      "%30, %31"                                                              \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOP_SS128(TY)                                                         \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
      "%58, %59, %60, %61, %62, %63"                                          \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOP_RS16(TY)                                                \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7"                              \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
        "r"(scale_d))

#define HOP_RS32(TY)                                                         \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15])                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                 \
        "r"(scale_d))

#define HOP_RS64(TY)                                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
      "%30, %31"                                                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                  \
        "r"(scale_d))

#define HOP_RS128(TY)                                                         \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
      "%58, %59, %60, %61, %62, %63"                                          \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                  \
        "r"(scale_d))

// d (m64nNk16, f32) = A . B (+ d if scale_d), A and B of element type E,
// K-major in shared memory.  d[i] is row 16 w + lane / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64-row block
// (w the warp in the warpgroup).  N is 32, 64 or 128.
template <int N, typename E>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss width");
  if constexpr (N == 32) {
    if constexpr (is_f16<E>) HOP_SS32("f16"); else HOP_SS32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (is_f16<E>) HOP_SS64("f16"); else HOP_SS64("bf16");
  } else {
    if constexpr (is_f16<E>) HOP_SS128("f16"); else HOP_SS128("bf16");
  }
}

// d (m64nNk16, f32) += A . B, A of element type E in registers (the
// accumulator layout of 16 columns, packed in pairs by Elem<E>::pack), B
// MN-major in shared memory.  N is 16, 32, 64 or 128.
template <int N, typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_rs width");
  if constexpr (N == 16) {
    if constexpr (is_f16<E>) HOP_RS16("f16"); else HOP_RS16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (is_f16<E>) HOP_RS32("f16"); else HOP_RS32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (is_f16<E>) HOP_RS64("f16"); else HOP_RS64("bf16");
  } else {
    if constexpr (is_f16<E>) HOP_RS128("f16"); else HOP_RS128("bf16");
  }
}

#define HOP_TF32_SS32                                                    \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"      \
      "%14, %15"                                                         \
      "}, %16, %17, p, 1, 1;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15])                                                      \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOP_TF32_SS64                                                         \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"           \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27," \
      "%28, %29, %30, %31"                                                    \
      "}, %32, %33, p, 1, 1;\n}\n"                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOP_TF32_RS8                                         \
  asm volatile(                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"            \
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {" \
      "%0, %1, %2, %3"                                       \
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
        "r"(scale_d))

#define HOP_TF32_RS16                                               \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7"                              \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
        "r"(scale_d))

#define HOP_TF32_RS32                                                    \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"      \
      "%14, %15"                                                         \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15])                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
        "r"(scale_d))

#define HOP_TF32_RS64                                                         \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"           \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27," \
      "%28, %29, %30, %31"                                                    \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                  \
        "r"(scale_d))

#define HOP_TF32_RS128                                                        \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"           \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27," \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41," \
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55," \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                  \
        "r"(scale_d))

// d (m64nNk8, f32) = A . B (+ d if scale_d), tf32 operands: A from
// registers, B K-major in shared memory (tf32 takes no MN-major operand).
// A's fragment: a[0] row 16 w + lane / 4, column lane % 4 of the 8-deep
// step; a[1] 8 rows further; a[2] and a[3] as a[0] and a[1], 4 columns
// further (CUTLASS's ALayout_64x8).  d is laid out as in wgmma_ss.  N is
// 8, 16, 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_tf32 width");
  if constexpr (N == 8) {
    HOP_TF32_RS8;
  } else if constexpr (N == 16) {
    HOP_TF32_RS16;
  } else if constexpr (N == 32) {
    HOP_TF32_RS32;
  } else if constexpr (N == 64) {
    HOP_TF32_RS64;
  } else {
    HOP_TF32_RS128;
  }
}

// d (m64nNk8, f32) = A . B (+ d if scale_d), tf32 operands, A and B
// K-major in shared memory; d as in wgmma_ss.  N is 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma_tf32_ss width");
  if constexpr (N == 32) {
    HOP_TF32_SS32;
  } else {
    HOP_TF32_SS64;
  }
}

// The split of an f32 value into two tf32 parts: big = x rounded to tf32
// (cvt.rna: to nearest, ties away from zero, 10 bits of mantissa), small =
// x - big (exact in f32) rounded the same way.  big * y_big + big * y_small
// + small * y_big keeps a product to about f32 accuracy (the dropped
// small * y_small and the roundings are near 2^-21 of it).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

#undef HOP_SS32
#undef HOP_SS64
#undef HOP_SS128
#undef HOP_RS16
#undef HOP_RS32
#undef HOP_RS64
#undef HOP_RS128
#undef HOP_TF32_SS32
#undef HOP_TF32_SS64
#undef HOP_TF32_RS8
#undef HOP_TF32_RS16
#undef HOP_TF32_RS32
#undef HOP_TF32_RS64
#undef HOP_TF32_RS128

}  // namespace hop
