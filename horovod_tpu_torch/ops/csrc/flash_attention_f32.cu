// Flash attention on f32 operands, f32 softmax state: the forward, dQ and
// dK/dV kernels on Hopper's tensor cores (three TF32 passes on wgmma).
//
// Replaces the three TPU kernels of horovod_tpu/ops/flash_attention.py on
// f32 inputs (the kernels of flash_attention.cu take bf16 and f16):
//   _fwd_kernel     (:108) -> flash_f32_fwd_kernel
//   _bwd_dq_kernel  (:173) -> flash_f32_dq_kernel
//   _bwd_dkv_kernel (:226) -> flash_f32_dkv_kernel
// up to head dim 256, and above it (D a multiple of 256 at run time) the
// wide instances wide::flash_f32_{fwd,dq,dkv}_wide_kernel: f32 FMA on the
// CUDA cores, chunked over the head dim (see their section; shared
// memory 68,608 / 94,720 / 104,960 B whatever D).
// The reference upcasts its operands to f32 and multiplies them with
// preferred_element_type=f32, so an f32 call keeps f32 products.
//
// What bounds them: operations.  At the LM shape (B=4, T=2048, H=24,
// D=128, causal) the forward does 1.03e11 FLOP, dQ 1.55e11 and dK/dV
// 2.06e11: 1.5, 2.3 and 3.1 ms on the CUDA cores (67 TFLOP/s of f32).  The
// tensor cores take f32 only as TF32 (10 bits of mantissa, 495 TFLOP/s
// dense), and one pass would round every operand to about three decimal
// digits.  Three passes on a split of each operand, x = big + small
// (flash_hopper.cuh's tf32_split), keep about f32 accuracy at a third of
// that rate, small terms first:
//   a . b ~= a_small . b_big + a_big . b_small + a_big . b_big
// so the forward's bound is 1.03e11 * 3 / 495e12 = 0.625 ms, dQ's 0.938
// and dK/dV's 1.250; the bytes never bound them (0.21 ms at most).
//
// The three kernels: one block per 64 rows (q rows in the forward and dQ,
// keys in dK/dV), two consumer warpgroups and a producer warpgroup that
// gives them its registers (setmaxnreg); one block per SM.
// * The block's own rows (Q; K and V) land once by TMA (dQ's Q and dO are
//   read into registers, or at D = 256 into shared memory as the threads'
//   own fragments).  The forward (up to D = 128) splits Q once into
//   shared memory and reads both operands of S = Q.K^T from there.  dQ,
//   dK/dV and the forward at D = 256 keep them raw: they are the A
//   operand of the head-dim products (S = Q.K^T and dP = dO.V^T; S^T =
//   K.Q^T and dP^T = V.dO^T), which wgmma reads from registers, each
//   8-deep step's fragment loaded raw and split in registers.
// * The streamed tiles (K and V in the forward and dQ; Q and dO in dK/dV)
//   land by TMA in a ring of stages.  B operands come from shared memory,
//   so the producer warpgroup writes each one's big and small parts
//   there: a tile reduced along the head dim (K in S; V in dP; Q and dO in
//   S^T and dP^T) splits in place (big) with its small part beside it; a
//   tile reduced along its rows (V in O += P.V; K in dQ += dS.K; dO and Q
//   in dV += P^T.dO and dK += dS^T.Q) is transposed as well, because wgmma
//   takes tf32 operands K-major only.  The producer then fences the async
//   proxy and arrives on the stage's `full` barrier; the consumers free
//   the stage after their products.
// * S, P, the softmax state (and dS) stay in registers.  P and dS are the
//   A operands of the second products straight from the accumulator: a
//   thread holds accumulator columns 2t and 2t + 1 (t = lane % 4) of each
//   8-column block, where the tf32 A fragment wants columns t and t + 4,
//   so the transposed tiles permute the reduction index in each group of
//   8 (position p holds row 2p for p < 4, 2 (p - 4) + 1 after), and a
//   thread's accumulator values are its A fragment as they stand.
// * Forward: the two consumer warpgroups share the block's 64 q rows and
//   take alternate key tiles, each through its own stage and with an
//   online softmax of its own; the two states merge at the end (at D = 256
//   one consumer, whose O alone takes 128 registers).  dQ: warpgroup 0
//   computes S and warpgroup 1 dP, they swap them through the stage's
//   spent K and V tiles, and each accumulates half of dQ's columns; di
//   comes from the same products on the block's rows of O (the dQ
//   section).  dK/dV: the same with S^T and dP^T, swapped through the
//   spent Q and dO tiles, and half of dK's and dV's columns each.
// * The tensor cores truncate when they add into an f32 accumulator, so no
//   chain of products into one accumulator is long (PARTS).
// * Tiles (Tiles<D>): forward key tiles of 64 (32 at D = 128, 16 at D =
//   256) through two stages; dQ key tiles of 32 (16 at D = 256) through
//   three stages (two at D = 128, one at 256); dK/dV q tiles of 32 (16 at
//   D >= 128) through two.  At D = 256 dK/dV keeps one stage and splits
//   its output columns over two blocks (blockIdx.z), each computing S^T
//   and dP^T over the whole head dim.  Shared memory (fwd_smem_bytes,
//   dq_smem_bytes, dkv_smem_bytes), forward / dQ / dK/dV: D = 16 50,240 /
//   88,152 / 75,832 B; 32 99,392 / 75,864 / 84,024; 64 197,696 / 149,592
//   / 165,944; 128 230,464 / 198,720 / 198,200; 256 230,464 / 231,464 /
//   230,688.
//
// The trouble spots of flash_attention.cu hold here: -inf guards (safe_m,
// p = 0 for a masked score, corr = 0 from an empty row, denom = 1 for l =
// 0), causal tile skipping, rows past T read as zeros (TMA fills them) and
// never written, the scale after the products, di = rowsum(dO * O) from
// the stored o, and a NaN-propagating row max.  exp is expf of the
// difference, as the plain version computes it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

constexpr int BR = 64;   // q rows of a forward or dQ block; keys of dK/dV
// The opt-in shared memory of one block.
constexpr int SMEM_LIMIT = 232448;

struct Geometry {
  int H;                 // heads in the batch*head index (1 for [B*H, T, D])
  int seg_heads;         // batch*head rows per segment-id row
  int T;
  long long sb, st, sh;  // element strides of batch, time and head
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;  // NaN in either operand wins
}

__device__ __forceinline__ long long base_offset(const Geometry& g, int y) {
  return (long long)(y / g.H) * g.sb + (long long)(y % g.H) * g.sh;
}

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

constexpr int WG = 128;  // a warpgroup: one consumer, or the producer

// What varies with the head dim (see the head of the file).
template <int D>
struct Tiles {
  // Up to D = 128 the forward splits Q once into shared memory and takes
  // both operands of S = Q.K^T from there; at D = 256, and in dK/dV, the
  // block's own rows stay raw and A is split step by step in registers.
  static constexpr bool FWD_SPLIT = D <= 128;
  static constexpr int FWD_BC = D >= 128 ? 4096 / D : 64;
  // Forward consumer warpgroups (alternate key tiles, one stage each); at
  // D = 256 one, whose O alone takes 128 registers.
  static constexpr int FWD_WGS = D <= 128 ? 2 : 1;
  static constexpr int FWD_THREADS = (FWD_WGS + 1) * WG;
  static constexpr int FWD_STAGES = 2;
  // dQ: key tiles of 32 (16 at D = 256, whose A operands take 128 KB of
  // shared memory), three stages (two at D = 128, one at 256).
  static constexpr int DQ_BK = D > 128 ? 16 : 32;
  static constexpr int DQ_STAGES = D > 128 ? 1 : (D == 128 ? 2 : 3);
  static constexpr bool DQ_A_REGS = D <= 128;
  // dQ's consumers' registers (setmaxnreg; the producer keeps 504 - 2
  // REGS): at D = 128, where Q or dO takes 64 of them, 232 (224 spilled
  // more), 224 elsewhere (the producer's 40 would spill below D = 64).
  static constexpr int DQ_REGS = D == 128 ? 232 : 224;
  static constexpr int DKV_BQ = D >= 128 ? 16 : 32;
  static constexpr int DKV_COLS = D > 128 ? 128 : D;  // dK/dV columns a block
  static constexpr int DKV_STAGES = D > 128 ? 1 : 2;
};

// The first 1024-aligned byte of the dynamic shared memory (its shared
// address and its generic pointer); launches ask for 1024 bytes more.
struct SmemBase {
  uint32_t addr;
  unsigned char* ptr;
};

__device__ __forceinline__ SmemBase smem_base(unsigned char* raw) {
  const uint32_t a = hop::smem_u32(raw);
  const uint32_t aligned = (a + 1023u) & ~1023u;
  return {aligned, raw + (aligned - a)};
}

// Element (r, c) of a raw f32 tile of R rows and E columns, as TMA lays it
// out (flash_hopper.cuh's swizzled boxes).
template <int E, int R>
__device__ __forceinline__ float tile_at(const unsigned char* tile, int r,
                                         int c) {
  return *reinterpret_cast<const float*>(
      tile + hop::chunk_addr<E, R, 4>(0u, r, c / 4) + 4 * (c % 4));
}

__device__ __forceinline__ void split4(float4 x, uint4& big, uint4& small) {
  hop::tf32_split(x.x, big.x, small.x);
  hop::tf32_split(x.y, big.y, small.y);
  hop::tf32_split(x.z, big.z, small.z);
  hop::tf32_split(x.w, big.w, small.w);
}

// A landed tile of BYTES bytes split in place: its big parts replace it
// and its small parts go to the same offsets of `small` (the layout is
// the tile's own, so the wgmma descriptors of both are alike).  The
// producer warpgroup's threads (pt) share the work.
template <int BYTES>
__device__ __forceinline__ void split_tile(unsigned char* big,
                                           unsigned char* small, int pt) {
  for (int i = pt * 16; i < BYTES; i += WG * 16) {
    uint4 b, s;
    split4(*reinterpret_cast<const float4*>(big + i), b, s);
    *reinterpret_cast<uint4*>(big + i) = b;
    *reinterpret_cast<uint4*>(small + i) = s;
  }
}

// The transpose of columns [c0, c0 + N) of a landed tile `raw` of E rows
// and D columns, split: [N, E] tiles (K-major, extent E) of big and small
// parts, the rows of each group of 8 permuted so that position p holds
// row 2p (p < 4) or 2 (p - 4) + 1 (the head of the file).  A unit of work
// reads four 16-byte chunks (columns 4 dq to 4 dq + 3 of rows r0, r0 + 2,
// r0 + 4 and r0 + 6) and writes output chunk c of those four columns' rows.
template <int D, int E, int N>
__device__ __forceinline__ void transpose_split(const unsigned char* raw,
                                                unsigned char* big,
                                                unsigned char* small, int c0,
                                                int pt) {
  constexpr int UNITS = (N / 4) * (E / 4);
  for (int u = pt; u < UNITS; u += WG) {
    const int c = u % (E / 4), dq = u / (E / 4);
    const int r0 = 8 * (c / 2) + c % 2;
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(
          raw + hop::chunk_addr<D, E, 4>(0u, r0 + 2 * i, c0 / 4 + dq));
    const float4 col[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                           make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                           make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                           make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint4 bg, sm;
      split4(col[e], bg, sm);
      const uint32_t at = hop::chunk_addr<E, N, 4>(0u, 4 * dq + e, c);
      *reinterpret_cast<uint4*>(big + at) = bg;
      *reinterpret_cast<uint4*>(small + at) = sm;
    }
  }
}

// The split tf32 A fragment of 8-deep step kk for the warpgroup's 64 rows
// of a raw [64, D] tile (the layout of hop::wgmma_tf32's a).
template <int D>
__device__ __forceinline__ void a_fragment(const unsigned char* tile, int kk,
                                           int lane, int warp,
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  const int r = warp * 16 + lane / 4, c = 8 * kk + lane % 4;
  hop::tf32_split(tile_at<D, BR>(tile, r, c), big[0], small[0]);
  hop::tf32_split(tile_at<D, BR>(tile, r + 8, c), big[1], small[1]);
  hop::tf32_split(tile_at<D, BR>(tile, r, c + 4), big[2], small[2]);
  hop::tf32_split(tile_at<D, BR>(tile, r + 8, c + 4), big[3], small[3]);
}

// The swap of the two consumer warpgroups' [64, R] products (S and dP in
// dQ, S^T and dP^T in dK/dV): each writes its product in its threads' own
// order (the two warpgroups' fragments match) over the pair of [R, D]
// tiles its product read, or, where those are smaller (D = 16), into a
// slot of its own at the end of the stage, and reads the other's.
__host__ __device__ constexpr int swap_bytes(int rows) {
  return BR * rows * 4;
}

__host__ __device__ constexpr bool swap_in_tiles(int D) {
  return 2 * D >= BR;
}

// The producer's statistics of R q rows (dQ's block, a dK/dV q tile):
// safe_m, denom, di (from the stored o) and the q-side segment id (0
// without segments).
template <int R>
struct RowStats {
  float m[R];
  float l[R];
  float di[R];
  int seg[R];
};

// The tensor cores add each product's partial sums into the f32
// accumulator truncating, not rounding (toward zero), so a long chain of
// products into one accumulator drifts by about its length times 2^-24 of
// the sum: 768 products a row at T = 2048 put dK and dV rows at about
// twice the f32 row limit (phase 6's main shape).  So no chain is long:
// the head-dim products spread their products over PARTS fresh
// accumulators (a chain of at most 24; mma_head_dim_by keeps the small
// passes apart), added in f32 (rounded) at the end, and the second
// products start fresh each tile.  dQ's S and dP take as many as its
// registers allow (dq_parts): dP's error is all of dS's where dP - di
// nearly cancels (a row whose weight sits on one or two keys).
constexpr int PARTS = 4;
constexpr int SS_PARTS = 2;  // the forward's S, whose accumulators are wider
// Steps of a register-A product in flight (their fragments live at once).
constexpr int IN_FLIGHT = 4;

// acc (64 x N) = A . B^T over the head dim D in three passes a step: A
// the warpgroup's [64, D] tile (big at a_big, small at a_small), B an [N,
// D] tile (b_big, b_small), both split in shared memory.
template <int D, int N>
__device__ __forceinline__ void mma_head_dim_ss(float (&acc)[N / 2],
                                                uint32_t a_big,
                                                uint32_t a_small,
                                                uint32_t b_big,
                                                uint32_t b_small) {
  // The first product into each accumulator overwrites it (scale-d 0):
  // none is zeroed, since registers zeroed between asynchronous products
  // make the compiler wait on them.
  static_assert(D / 8 * 3 / SS_PARTS <= 24, "chains of at most 24 products");
  float part[SS_PARTS][N / 2];
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ab = hop::kmajor<D, BR, 4>(a_big, 0, kk);
    const uint64_t as = hop::kmajor<D, BR, 4>(a_small, 0, kk);
    const uint64_t bb = hop::kmajor<D, N, 4>(b_big, 0, kk);
    const uint64_t bs = hop::kmajor<D, N, 4>(b_small, 0, kk);
    hop::wgmma_tf32_ss<N>(part[(3 * kk) % SS_PARTS], as, bb,
                          3 * kk >= SS_PARTS);
    hop::wgmma_tf32_ss<N>(part[(3 * kk + 1) % SS_PARTS], ab, bs,
                          3 * kk + 1 >= SS_PARTS);
    hop::wgmma_tf32_ss<N>(part[(3 * kk + 2) % SS_PARTS], ab, bb,
                          3 * kk + 2 >= SS_PARTS);
  }
  hop::wgmma_commit();
  hop::wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < SS_PARTS; ++c) hop::fence_regs(part[c]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[i] = part[0][i];
#pragma unroll
    for (int c = 1; c < SS_PARTS; ++c) acc[i] += part[c][i];
  }
}

// The same with A the warpgroup's [64, D] operand in registers, its split
// fragment of step kk given by load(kk, big, small) (IN_FLIGHT steps in
// flight), over at most NP accumulators, for the operands that keep no
// split copy.  The two small passes of every step go into the first
// accumulator and the big passes in turn into the others (as many as
// there are steps, up to NP - 1): a truncation costs a unit in the last
// place of the larger of the accumulator and its addends, so small terms
// added to a sum of big ones lose as much as big terms do, while in a sum
// of their own (2^-11 of the big pass's) they lose nothing that shows.
template <int D, int N, int NP, typename Load>
__device__ __forceinline__ void mma_head_dim_by(float (&acc)[N / 2],
                                                Load load, uint32_t b_big,
                                                uint32_t b_small) {
  constexpr int NB = NP - 1 < D / 8 ? NP - 1 : D / 8;  // big-pass sums
  static_assert(NB >= 1 && D / 8 <= 24 * NB,
                "big-pass chains of at most 24 products");
  uint32_t big[IN_FLIGHT][4], small[IN_FLIGHT][4];
  float part[1 + NB][N / 2];  // overwritten first, as in mma_head_dim_ss
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int f = kk % IN_FLIGHT;
    if (kk >= IN_FLIGHT) {
      // Step kk - IN_FLIGHT, the last reader of these fragments, is done.
      hop::wgmma_wait<IN_FLIGHT - 1>();
      hop::fence_regs(big);
      hop::fence_regs(small);
    }
    load(kk, big[f], small[f]);
    const uint64_t db = hop::kmajor<D, N, 4>(b_big, 0, kk);
    const uint64_t ds = hop::kmajor<D, N, 4>(b_small, 0, kk);
    hop::wgmma_fence();
    hop::wgmma_tf32<N>(part[0], small[f], db, kk > 0);
    hop::wgmma_tf32<N>(part[0], big[f], ds, 1);
    hop::wgmma_tf32<N>(part[1 + kk % NB], big[f], db, kk >= NB);
    hop::wgmma_commit();
  }
  hop::wgmma_wait_all();
  hop::fence_regs(big);
  hop::fence_regs(small);
#pragma unroll
  for (int c = 0; c <= NB; ++c) hop::fence_regs(part[c]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[i] = part[0][i];
#pragma unroll
    for (int c = 1; c <= NB; ++c) acc[i] += part[c][i];
  }
}

// The A fragments (big, small) of each 8-deep step of a [64, K] operand
// held as an accumulator (P, P^T or dS^T): values 4 kk, 4 kk + 2, 4 kk + 1
// and 4 kk + 3, which the permuted B tiles match.
template <int K>
__device__ __forceinline__ void acc_fragments(const float (&x)[K / 2],
                                              uint32_t (&big)[K / 8][4],
                                              uint32_t (&small)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    hop::tf32_split(x[4 * kk], big[kk][0], small[kk][0]);
    hop::tf32_split(x[4 * kk + 2], big[kk][1], small[kk][1]);
    hop::tf32_split(x[4 * kk + 1], big[kk][2], small[kk][2]);
    hop::tf32_split(x[4 * kk + 3], big[kk][3], small[kk][3]);
  }
}

// Issues acc (64 x N, N <= 128) = A . B over K rows (acc is overwritten,
// not zeroed: mma_head_dim_ss), three passes a step: A's fragments from
// acc_fragments, B rows [n0, n0 + N) of a transposed [R, K] tile (big at
// b_big, small at b_small).  The caller fences before and commits and
// waits after.
template <int K, int R, int N>
__device__ __forceinline__ void mma_rows(float (&acc)[N / 2],
                                         const uint32_t (&big)[K / 8][4],
                                         const uint32_t (&small)[K / 8][4],
                                         uint32_t b_big, uint32_t b_small,
                                         int n0) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint64_t db = hop::kmajor<K, R, 4>(b_big, n0, kk);
    const uint64_t ds = hop::kmajor<K, R, 4>(b_small, n0, kk);
    hop::wgmma_tf32<N>(acc, small[kk], db, kk > 0);
    hop::wgmma_tf32<N>(acc, big[kk], ds, 1);
    hop::wgmma_tf32<N>(acc, big[kk], db, 1);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (64-row q tile, batch*head).  Up to D = 128 two
// consumer warpgroups share the 64 rows: warpgroup w takes the key tiles
// i = w mod 2 through stage w with an online softmax of its own, and the
// two states merge at the end, as the online softmax merges key blocks.
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + (Tiles<D>::FWD_SPLIT ? 2 : 1) * BR * D * 4 +
         Tiles<D>::FWD_STAGES * 5 * Tiles<D>::FWD_BC * D * 4 +
         8 * (2 + 3 * Tiles<D>::FWD_STAGES);
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::FWD_THREADS, 1)
    flash_f32_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         float* __restrict__ o, float* __restrict__ m_out,
                         float* __restrict__ l_out,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, Geometry g, int causal,
                         float scale) {
  constexpr int FBC = Tiles<D>::FWD_BC;
  constexpr int STAGES = Tiles<D>::FWD_STAGES;
  constexpr int WGS = Tiles<D>::FWD_WGS, CONSUMERS = WGS * WG;
  constexpr int Q_BYTES = BR * D * 4;
  constexpr int TILE = FBC * D * 4;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  auto generic = [&](uint32_t addr) { return sm.ptr + (addr - sm.addr); };
  // Q (landed, then its big part in place) and, where split, its small
  // part; then stage s, five tiles: K (landed, then its big part in
  // place), K's small part, V (landed), V^T big and V^T small.
  constexpr bool SPLIT = Tiles<D>::FWD_SPLIT;
  const uint32_t sQ = sm.addr;
  const uint32_t sStages = sQ + (SPLIT ? 2 : 1) * Q_BYTES;
  auto stage = [&](int s) { return sStages + s * 5 * TILE; };
  // Barriers: Q landed, Q ready (split where it is); per stage, K and V
  // landed (TMA), split (the producer warpgroup) and freed (the
  // consumers).
  const uint32_t q_full = sStages + STAGES * 5 * TILE, q_ready = q_full + 8;
  const uint32_t loaded = q_ready + 8, full = loaded + 8 * STAGES;
  const uint32_t empty = full + 8 * STAGES;

  // Under causal masking the last q tiles do the most work: blockIdx.y = 0
  // takes the last tile of every batch*head, so the long blocks start
  // first and the short ones fill the tail.
  const int T = g.T, y = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int kend = causal ? min(T, q0 + BR) : T;
  const int n_tiles = (kend + FBC - 1) / FBC;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    hop::mbar_init(q_ready, WG);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(loaded + 8 * s, 1);
      hop::mbar_init(full + 8 * s, WG);
      hop::mbar_init(empty + 8 * s, WG);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: gives registers to two consumers; its first
    // thread issues the TMA loads; all 128 split Q (once, where SPLIT) and
    // K in place and transpose and split V.
    if constexpr (WGS == 2) hop::setmaxnreg_dec<56>();
    const int pt = threadIdx.x - CONSUMERS;
    const int h = y % g.H, b = y / g.H;
    if (pt == 0) {
      hop::mbar_arrive_expect_tx(q_full, Q_BYTES);
      hop::tma_tile<D, BR, 4>(sQ, &tm_q, q_full, q0, h, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const uint32_t sK = stage(s), sV = sK + 2 * TILE;
      hop::mbar_wait(empty + 8 * s, parity ^ 1);
      if (pt == 0) {
        hop::fence_proxy_async();
        hop::mbar_arrive_expect_tx(loaded + 8 * s, 2 * TILE);
        hop::tma_tile<D, FBC, 4>(sK, &tm_k, loaded + 8 * s, i * FBC, h, b);
        hop::tma_tile<D, FBC, 4>(sV, &tm_v, loaded + 8 * s, i * FBC, h, b);
      }
      if (i == 0) {
        hop::mbar_wait(q_full, 0);
        if constexpr (SPLIT) {
          split_tile<Q_BYTES>(generic(sQ), generic(sQ + Q_BYTES), pt);
          hop::fence_proxy_async();
        }
        hop::mbar_arrive(q_ready);
      }
      hop::mbar_wait(loaded + 8 * s, parity);
      split_tile<TILE>(generic(sK), generic(sK + TILE), pt);
      transpose_split<D, FBC, D>(generic(sV), generic(sV + TILE),
                                 generic(sV + 2 * TILE), 0, pt);
      hop::fence_proxy_async();
      hop::mbar_arrive(full + 8 * s);
    }
    return;
  }

  // Consumer warpgroup wg: this thread holds rows row[0] and row[1] =
  // row[0] + 8 of S and O.
  if constexpr (WGS == 2) hop::setmaxnreg_inc<224>();
  const int wg = threadIdx.x / WG, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % WG) / 32;
  int row[2];
  row[0] = q0 + warp * 16 + lane / 4;
  row[1] = row[0] + 8;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  int my_seg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) my_seg[r] = (qs && row[r] < T) ? qs[row[r]] : 0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};

  hop::mbar_wait(q_ready, 0);
  for (int i = wg; i < n_tiles; i += WGS) {
    const int s = i % STAGES, k0 = i * FBC;
    const uint32_t sK = stage(s), sVt = sK + 3 * TILE;
    hop::mbar_wait(full + 8 * s, (i / STAGES) & 1);

    // S = Q . K^T, then the scale and the mask (trouble spots 2 and 3):
    // only tiles that cross the diagonal, the end of the sequence or a
    // segment need the test.
    float sc[FBC / 2];
    if constexpr (SPLIT)
      mma_head_dim_ss<D, FBC>(sc, sQ, sQ + Q_BYTES, sK, sK + TILE);
    else
      mma_head_dim_by<D, FBC, PARTS>(
          sc,
          [&](int kk, uint32_t(&big)[4], uint32_t(&small)[4]) {
            a_fragment<D>(generic(sQ), kk, lane, warp, big, small);
          },
          sK, sK + TILE);
    const bool need_mask = k0 + FBC > T || ks != nullptr ||
                           (causal && k0 + FBC - 1 > q0);
#pragma unroll
    for (int j = 0; j < FBC / 2; ++j) {
      sc[j] *= scale;
      if (need_mask) {
        const int r = (j / 2) % 2;
        const int kc = k0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        const bool ok = kc < T && (!causal || kc <= row[r]) &&
                        (!ks || ks[kc] == my_seg[r]);
        if (!ok) sc[j] = -INFINITY;
      }
    }

    // Online softmax in registers.  Four lanes share a row: the row max is
    // reduced over them by shuffles; the row sum stays a per-thread
    // partial until the end (every term of a row is rescaled alike).
    float corr[2], safe_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < FBC / 2; ++j)
        if ((j / 2) % 2 == r) mx = max_nan(mx, sc[j]);
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = max_nan(m_i[r], mx);
      safe_m[r] = (m_new == -INFINITY) ? 0.f : m_new;
      corr[r] = (m_i[r] == -INFINITY) ? 0.f : expf(m_i[r] - safe_m[r]);
      m_i[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < FBC / 2; ++j) {
      const int r = (j / 2) % 2;
      const float p = (sc[j] == -INFINITY) ? 0.f : expf(sc[j] - safe_m[r]);
      sum[r] += p;
      sc[j] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_part[r] = l_part[r] * corr[r] + sum[r];

    // O = O corr + P . V: P's fragments from its accumulator, V^T from
    // the stage, the product into a fresh accumulator (PARTS' note), 128
    // columns at a time (64 at D = 256, where O alone takes 128 registers).
    constexpr int NN = D > 128 ? 64 : D;
    uint32_t pb[FBC / 8][4], ps[FBC / 8][4];
    acc_fragments<FBC>(sc, pb, ps);
#pragma unroll
    for (int h = 0; h < D / NN; ++h) {
      float pv[NN / 2];
      hop::wgmma_fence();
      mma_rows<FBC, D, NN>(pv, pb, ps, sVt, sVt + TILE, h * NN);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(pv);
#pragma unroll
      for (int j = 0; j < NN / 2; ++j)
        acc[h * NN / 2 + j] =
            fmaf(acc[h * NN / 2 + j], corr[(j / 2) % 2], pv[j]);
    }
    hop::fence_regs(pb);
    hop::fence_regs(ps);
    hop::mbar_arrive(empty + 8 * s);
  }

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = l_part[r];
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  if constexpr (WGS == 2) {
    // Warpgroup 1 leaves O, m and l in its stage (its last tile is done);
    // warpgroup 0 merges them into its own (the -inf guards of trouble
    // spot 1 as in the loop) and writes the rows.
    float* const buf = reinterpret_cast<float*>(generic(stage(1)));
    const int t = threadIdx.x % WG;
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) buf[j * WG + t] = acc[j];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        buf[(D / 2 + r) * WG + t] = m_i[r];
        buf[(D / 2 + 2 + r) * WG + t] = l_row[r];
      }
    }
    hop::named_barrier(2, CONSUMERS);
    if (wg == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = buf[(D / 2 + r) * WG + t];
      const float l1 = buf[(D / 2 + 2 + r) * WG + t];
      const float m_new = max_nan(m_i[r], m1);
      const float safe_m = (m_new == -INFINITY) ? 0.f : m_new;
      const float c0 = (m_i[r] == -INFINITY) ? 0.f : expf(m_i[r] - safe_m);
      const float c1 = (m1 == -INFINITY) ? 0.f : expf(m1 - safe_m);
      l_row[r] = l_row[r] * c0 + l1 * c1;
      m_i[r] = m_new;
#pragma unroll
      for (int j = 0; j < D / 2; ++j)
        if ((j / 2) % 2 == r) acc[j] = acc[j] * c0 + buf[j * WG + t] * c1;
    }
  }

  // Epilogue (trouble spot 1): l == 0 divides by 1, so a fully masked row
  // gives o = 0 with m = -inf and l = 0.
  const long long off = base_offset(g, y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = l_row[r];
    if (row[r] >= T) continue;
    const float denom = (l == 0.f) ? 1.f : l;
    float* dst = o + off + (long long)row[r] * g.st + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(
          acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    if (lane % 4 == 0) {
      m_out[(long long)y * T + row[r]] = m_i[r];
      l_out[(long long)y * T + row[r]] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (64-key tile, batch*head, column half at D = 256);
// walks q tiles of BQ rows on the transposed scores S^T = K . Q^T.  Two
// consumer warpgroups share the block's 64 keys: warpgroup 0 computes S^T
// and warpgroup 1 dP^T, they swap them through shared memory, and each
// accumulates its half of the block's columns of dK and dV.
// ---------------------------------------------------------------------------

constexpr int DKV_CONSUMERS = 2 * WG;
constexpr int DKV_THREADS = DKV_CONSUMERS + WG;

template <int D>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 4 * Tiles<D>::DKV_BQ * D * 4 +
         4 * Tiles<D>::DKV_COLS * Tiles<D>::DKV_BQ * 4 +
         (swap_in_tiles(D) ? 0 : 2 * swap_bytes(Tiles<D>::DKV_BQ));
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * BR * D * 4 +
         Tiles<D>::DKV_STAGES *
             (dkv_stage_bytes<D>() +
              (int)sizeof(RowStats<Tiles<D>::DKV_BQ>)) +
         8 * (1 + 3 * Tiles<D>::DKV_STAGES);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_f32_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ o,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Geometry g, int causal, float scale) {
  constexpr int BQ = Tiles<D>::DKV_BQ;
  constexpr int COLS = Tiles<D>::DKV_COLS;
  constexpr int HALF = COLS / 2;  // columns of one consumer warpgroup
  constexpr int STAGES = Tiles<D>::DKV_STAGES;
  constexpr int KV_BYTES = BR * D * 4;
  constexpr int QT = BQ * D * 4;     // a q-side tile, [BQ, D]
  constexpr int TT = COLS * BQ * 4;  // a transposed one, [COLS, BQ]
  constexpr int STAGE = dkv_stage_bytes<D>();
  using Stats = RowStats<BQ>;
  // This block's columns of dK and dV: [c0, c0 + COLS).
  const int c0 = blockIdx.z * COLS;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  auto generic = [&](uint32_t addr) { return sm.ptr + (addr - sm.addr); };
  // K and V, raw; then stage s, eight tiles: Q (landed, then its big part
  // in place), Q small, dO (landed, then big), dO small, Q^T big, Q^T
  // small, dO^T big, dO^T small (and at D = 16 the two swap slots); then
  // the stages' statistics.
  const uint32_t sK = sm.addr, sV = sK + KV_BYTES;
  const uint32_t sStages = sV + KV_BYTES;
  const uint32_t sStats = sStages + STAGES * STAGE;
  auto stats = [&](int s) {
    return reinterpret_cast<Stats*>(generic(sStats + s * sizeof(Stats)));
  };
  // Barriers: K/V landed; per stage, Q and dO landed (TMA), split with
  // their statistics (the producer warpgroup) and freed (the consumers).
  const uint32_t kv_full = sStats + STAGES * sizeof(Stats);
  const uint32_t loaded = kv_full + 8, full = loaded + 8 * STAGES;
  const uint32_t empty = full + 8 * STAGES;

  // Under causal masking the first key tiles do the most work: they come
  // first (blockIdx.y = 0 for every batch*head).  A key tile at k0 visits
  // the q tiles from the one holding row k0 (BQ divides 64).
  const int T = g.T, y = blockIdx.x, k0 = blockIdx.y * BR;
  const int q_first = causal ? k0 / BQ : 0;
  const int n_tiles = (T + BQ - 1) / BQ - q_first;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(loaded + 8 * s, 1);
      hop::mbar_init(full + 8 * s, WG);
      hop::mbar_init(empty + 8 * s, DKV_CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= DKV_CONSUMERS) {
    // Producer warpgroup: gives registers to the consumers; its first
    // thread issues the TMA loads; all 128 compute the q tile's
    // statistics, TPR threads a row (di from the landed dO and O's row in
    // device memory, trouble spot 4), transpose and split Q and dO, and,
    // once every thread has read them raw, split them in place.
    hop::setmaxnreg_dec<56>();
    constexpr int TPR = WG / BQ;
    const int pt = threadIdx.x - DKV_CONSUMERS, rr = pt / TPR, part = pt % TPR;
    const int h = y % g.H, b = y / g.H;
    const long long off = base_offset(g, y);
    if (pt == 0) {
      hop::mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
      hop::tma_tile<D, BR, 4>(sK, &tm_k, kv_full, k0, h, b);
      hop::tma_tile<D, BR, 4>(sV, &tm_v, kv_full, k0, h, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, q0 = (q_first + i) * BQ, qr = q0 + rr;
      const uint32_t parity = (i / STAGES) & 1;
      const uint32_t sQ = sStages + s * STAGE, sdO = sQ + 2 * QT;
      const uint32_t sQt = sQ + 4 * QT, sdOt = sQt + 2 * TT;
      float m = -INFINITY, l = 0.f;
      int seg = 0;
      if (part == 0 && qr < T) {
        m = m_in[(long long)y * T + qr];
        l = l_in[(long long)y * T + qr];
        if (qs) seg = qs[qr];
      }
      // This thread's chunks of O's row, read before the waits so that
      // their latency passes meanwhile (rows past T: zeros).
      const float* const orow = o + off + (long long)qr * g.st;
      float4 w[D / 4 / TPR];
#pragma unroll
      for (int u = 0; u < D / 4 / TPR; ++u)
        w[u] = qr < T ? *reinterpret_cast<const float4*>(
                            orow + 4 * (part + TPR * u))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      hop::mbar_wait(empty + 8 * s, parity ^ 1);
      if (pt == 0) {
        hop::fence_proxy_async();
        hop::mbar_arrive_expect_tx(loaded + 8 * s, 2 * QT);
        hop::tma_tile<D, BQ, 4>(sQ, &tm_q, loaded + 8 * s, q0, h, b);
        hop::tma_tile<D, BQ, 4>(sdO, &tm_do, loaded + 8 * s, q0, h, b);
      }
      hop::mbar_wait(loaded + 8 * s, parity);
      float di = 0.f;
#pragma unroll
      for (int u = 0; u < D / 4 / TPR; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(
            generic(sdO) + hop::chunk_addr<D, BQ, 4>(0u, rr, part + TPR * u));
        di = fmaf(x.x, w[u].x, di);
        di = fmaf(x.y, w[u].y, di);
        di = fmaf(x.z, w[u].z, di);
        di = fmaf(x.w, w[u].w, di);
      }
#pragma unroll
      for (int w = 1; w < TPR; w <<= 1)
        di += __shfl_xor_sync(0xffffffffu, di, w);
      transpose_split<D, BQ, COLS>(generic(sQ), generic(sQt),
                                   generic(sQt + TT), c0, pt);
      transpose_split<D, BQ, COLS>(generic(sdO), generic(sdOt),
                                   generic(sdOt + TT), c0, pt);
      hop::named_barrier(1, WG);
      split_tile<QT>(generic(sQ), generic(sQ + QT), pt);
      split_tile<QT>(generic(sdO), generic(sdO + QT), pt);
      if (part == 0) {
        Stats* st = stats(s);
        st->m[rr] = (m == -INFINITY) ? 0.f : m;
        st->l[rr] = (l == 0.f) ? 1.f : l;
        st->di[rr] = di;
        st->seg[rr] = seg;
      }
      hop::fence_proxy_async();
      hop::mbar_arrive(full + 8 * s);
    }
    return;
  }

  hop::setmaxnreg_inc<224>();
  // Consumer warpgroup wg: this thread holds keys key[0] and key[1] =
  // key[0] + 8 (rows of S^T, dP^T, dK and dV) and columns [n0, n0 +
  // HALF) of the block's.
  const int wg = threadIdx.x / WG, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % WG) / 32, n0 = wg * HALF;
  int key[2], key_seg[2];
  key[0] = k0 + warp * 16 + lane / 4;
  key[1] = key[0] + 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) key_seg[r] = (ks && key[r] < T) ? ks[key[r]] : 0;

  // The sums over the q tiles, each tile's products added in f32 (PARTS'
  // note).
  float acc_dk[HALF / 2], acc_dv[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  hop::mbar_wait(kv_full, 0);
  // Warpgroup 0's product is S^T = K . Q^T, warpgroup 1's dP^T = V . dO^T.
  const unsigned char* a_tile = generic(wg == 0 ? sK : sV);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, q0 = (q_first + i) * BQ;
    const uint32_t sQ = sStages + s * STAGE, sdO = sQ + 2 * QT;
    const uint32_t sQt = sQ + 4 * QT, sdOt = sQt + 2 * TT;
    hop::mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const Stats* st = stats(s);

    // This warpgroup's product, then the swap (swap_bytes).
    const uint32_t b_tile = wg == 0 ? sQ : sdO;
    uint32_t mine = b_tile, theirs = wg == 0 ? sdO : sQ;
    if constexpr (!swap_in_tiles(D)) {
      mine = sQt + 4 * TT + wg * swap_bytes(BQ);
      theirs = sQt + 4 * TT + (1 - wg) * swap_bytes(BQ);
    }
    float x[BQ / 2], other[BQ / 2];
    mma_head_dim_by<D, BQ, PARTS>(
        x,
        [&](int kk, uint32_t(&big)[4], uint32_t(&small)[4]) {
          a_fragment<D>(a_tile, kk, lane, warp, big, small);
        },
        b_tile, b_tile + QT);
    float* const out = reinterpret_cast<float*>(generic(mine)) +
                       (threadIdx.x % WG) * (BQ / 2);
    const float* const in = reinterpret_cast<const float*>(generic(theirs)) +
                            (threadIdx.x % WG) * (BQ / 2);
#pragma unroll
    for (int j = 0; j < BQ / 2; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    hop::named_barrier(2, DKV_CONSUMERS);
#pragma unroll
    for (int j = 0; j < BQ / 2; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(in + j);
      other[j] = t.x, other[j + 1] = t.y, other[j + 2] = t.z,
      other[j + 3] = t.w;
    }
    float sT[BQ / 2], dpT[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      sT[j] = wg == 0 ? x[j] : other[j];
      dpT[j] = wg == 0 ? other[j] : x[j];
    }

    // P^T = exp(S^T scale - m) / l and dS^T = P^T (dP^T - di), with the
    // mask (trouble spots 1-3) where the tile needs one.
    const bool need_mask = q0 + BQ > T || k0 + BR > T || qs != nullptr ||
                           (causal && q0 < k0 + BR - 1);
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int r = (j / 2) % 2;
      const int qc = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
      bool ok = true;
      if (need_mask) {
        const int qr = q0 + qc;
        ok = qr < T && key[r] < T && (!causal || qr >= key[r]) &&
             (!qs || st->seg[qc] == key_seg[r]);
      }
      const float p = ok ? expf(sT[j] * scale - st->m[qc]) / st->l[qc] : 0.f;
      sT[j] = p;
      dpT[j] = p * (dpT[j] - st->di[qc]);
    }

    // dV += P^T . dO and dK += dS^T . Q over the tile's rows, this
    // warpgroup's columns, the transposed tiles as B, each into a fresh
    // accumulator.
    uint32_t pb[BQ / 8][4], ps[BQ / 8][4], db[BQ / 8][4], ds[BQ / 8][4];
    acc_fragments<BQ>(sT, pb, ps);
    acc_fragments<BQ>(dpT, db, ds);
    float tile_dv[HALF / 2], tile_dk[HALF / 2];
    hop::wgmma_fence();
    mma_rows<BQ, COLS, HALF>(tile_dv, pb, ps, sdOt, sdOt + TT, n0);
    mma_rows<BQ, COLS, HALF>(tile_dk, db, ds, sQt, sQt + TT, n0);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(tile_dv);
    hop::fence_regs(tile_dk);
    hop::fence_regs(pb);
    hop::fence_regs(ps);
    hop::fence_regs(db);
    hop::fence_regs(ds);
    // The swap's writes precede the producer's next TMA into the stage.
    hop::fence_proxy_async();
    hop::mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int j = 0; j < HALF / 2; ++j) {
      acc_dv[j] += tile_dv[j];
      acc_dk[j] += tile_dk[j];
    }
  }

  // The scale multiplies dK after its products (trouble spot 3).
  const long long off = base_offset(g, y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= T) continue;
    const long long at =
        off + (long long)key[r] * g.st + c0 + n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int e = 4 * j + 2 * r;
      *reinterpret_cast<float2*>(dk + at + 8 * j) =
          make_float2(acc_dk[e] * scale, acc_dk[e + 1] * scale);
      *reinterpret_cast<float2*>(dv + at + 8 * j) =
          make_float2(acc_dv[e], acc_dv[e + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (64-row q tile, batch*head); walks key tiles of BK on
// the scores S = Q . K^T.  Two consumer warpgroups share the block's 64
// rows: warpgroup 0 computes S and warpgroup 1 dP = dO . V^T, they swap
// them through the spent K and V tiles, and each accumulates its half of
// dQ's columns, dQ += dS . K with the stage's transposed K.
// * The head-dim products are m64nBKk8: a narrow one costs the tensor
//   cores about as much to issue as a wide one, so the key tiles are as
//   long as shared memory allows: 32 keys up to D = 128, where each
//   consumer keeps its A operand (Q or dO, raw) in registers (64 at D =
//   128), and 16 at D = 256, where the two take 128 KB of shared memory
//   as their threads' own fragments (thread t's step kk at (kk WG + t)
//   16 bytes, one vector load a step).  Split in registers as loaded.
// * di = rowsum(dO * O) is computed as dP is: the producer streams the
//   block's own rows of O through the V slots first (BR / BK tiles, before
//   the key tiles), and warpgroup 1 takes the diagonal of dO . O^T from
//   the same three-pass products.  A row whose one visible key is itself
//   (a sequence's or a segment's first query) has o = v there, so dP - di
//   is 0 as in exact arithmetic; a di summed apart (FFMA) left the tensor
//   cores' dP error there, about 1e-5.
// * Stages: the producer's loads run STAGES - 1 tiles ahead of its split.
//   At D = 256 the one stage frees in two parts, its K and V tiles once
//   the swap is read (the next loads and V's split overlap the dQ
//   product), K^T after the dQ product.
// ---------------------------------------------------------------------------

constexpr int DQ_CONSUMERS = 2 * WG;
constexpr int DQ_THREADS = DQ_CONSUMERS + WG;

// The head-dim products' accumulators (PARTS' note; one takes the small
// passes): three at D = 128, big-pass chains of 8, where A holds 64
// registers (two, chains of 16, ran a little faster and further from an
// f64 reference: PERF.md); eight at D = 256, where a second query with
// nearly all its weight on one key leaves dP - di nearly cancelling.
template <int D>
__host__ __device__ constexpr int dq_parts() {
  return D == 128 ? 3 : (D == 256 ? 8 : 4);
}

// The key tiles a dQ block at q0 visits (trouble spot 2): under causal
// masking none past its last row.  The producer and the consumers share
// it.
template <int BK>
__device__ __forceinline__ int dq_key_tiles(int q0, int T, int causal) {
  return ((causal ? min(T, q0 + BR) : T) + BK - 1) / BK;
}

template <int D>
__host__ __device__ constexpr int dq_stage_bytes() {
  return 6 * Tiles<D>::DQ_BK * D * 4 +
         (swap_in_tiles(D) ? 0 : 2 * swap_bytes(Tiles<D>::DQ_BK));
}

template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + (Tiles<D>::DQ_A_REGS ? 0 : 2 * BR * D * 4) +
         Tiles<D>::DQ_STAGES * dq_stage_bytes<D>() +
         (int)sizeof(RowStats<BR>) + 8 * (2 + 3 * Tiles<D>::DQ_STAGES);
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_f32_dq_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_o,
                        const float* __restrict__ q,
                        const float* __restrict__ dout,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg, float* __restrict__ dq,
                        Geometry g, int causal, float scale) {
  constexpr int BK = Tiles<D>::DQ_BK;
  constexpr int O_TILES = BR / BK;  // the block's rows of O, for di
  constexpr bool A_REGS = Tiles<D>::DQ_A_REGS;
  constexpr int COLS = D / 2;  // dQ columns of a consumer warpgroup
  constexpr int STAGES = Tiles<D>::DQ_STAGES;
  constexpr int A_BYTES = BR * D * 4;  // one consumer's A fragments
  constexpr int KT = BK * D * 4;  // a key tile, [BK, D], or its [D, BK]
  constexpr int STAGE = dq_stage_bytes<D>();
  using Stats = RowStats<BR>;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  auto generic = [&](uint32_t addr) { return sm.ptr + (addr - sm.addr); };
  // At D = 256 the consumers' A fragments (Q's, then dO's); then stage s,
  // six tiles: K (landed, then its big part in place), K small, V or a
  // tile of O (landed, then big), its small part, K^T big, K^T small (and
  // at D = 16 the two swap slots); then the rows' statistics.
  const uint32_t sA = sm.addr, sStages = sA + (A_REGS ? 0 : 2 * A_BYTES);
  auto stage = [&](int s) { return sStages + s * STAGE; };
  Stats* const stats = reinterpret_cast<Stats*>(
      generic(sStages + STAGES * STAGE));
  // Barriers: m, l and the segment ids ready (the producer warpgroup);
  // per stage, K and V (or O) landed (TMA), split (the producer) and
  // freed (the consumers); at one stage, its K and V tiles freed once the
  // swap is read (kv_free), before K^T is (empty).
  const uint32_t q_ready = sStages + STAGES * STAGE + sizeof(Stats);
  const uint32_t kv_free = q_ready + 8, loaded = kv_free + 8;
  const uint32_t full = loaded + 8 * STAGES, empty = full + 8 * STAGES;

  // Under causal masking the last q tiles do the most work: blockIdx.y = 0
  // takes the last tile of every batch*head, so the long blocks start
  // first and the short ones fill the tail.
  const int T = g.T, y = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int n_tiles = O_TILES + dq_key_tiles<BK>(q0, T, causal);
  const long long off = base_offset(g, y);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_ready, WG);
    hop::mbar_init(kv_free, DQ_CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(loaded + 8 * s, 1);
      hop::mbar_init(full + 8 * s, WG);
      hop::mbar_init(empty + 8 * s, DQ_CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= DQ_CONSUMERS) {
    // Producer warpgroup: gives registers to the consumers; reads the
    // rows' m, l and segment ids; its first thread issues the TMA loads,
    // STAGES - 1 tiles ahead of the split (at one stage, as soon as the
    // consumers have read the K and V tiles); all 128 split the tiles of
    // O and V in place, and for a key tile, once K^T is free, transpose
    // and split K and, once every thread has read it raw, split it in
    // place.
    hop::setmaxnreg_dec<504 - 2 * Tiles<D>::DQ_REGS>();
    constexpr int AHEAD = STAGES - 1;
    const int pt = threadIdx.x - DQ_CONSUMERS;
    const int h = y % g.H, b = y / g.H;
    // Tile i's loads, once the consumers have freed what they overwrite.
    auto issue = [&](int i) {
      const int s = i % STAGES;
      const uint32_t sK = stage(s), sV = sK + 2 * KT;
      if (AHEAD > 0)
        hop::mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
      else if (i > 0)
        hop::mbar_wait(kv_free, (i - 1) & 1);
      hop::fence_proxy_async();
      if (i < O_TILES) {
        hop::mbar_arrive_expect_tx(loaded + 8 * s, KT);
        hop::tma_tile<D, BK, 4>(sV, &tm_o, loaded + 8 * s, q0 + i * BK, h, b);
      } else {
        const int k0 = (i - O_TILES) * BK;
        hop::mbar_arrive_expect_tx(loaded + 8 * s, 2 * KT);
        hop::tma_tile<D, BK, 4>(sK, &tm_k, loaded + 8 * s, k0, h, b);
        hop::tma_tile<D, BK, 4>(sV, &tm_v, loaded + 8 * s, k0, h, b);
      }
    };
    if (pt == 0)
      for (int i = 0; i < AHEAD && i < n_tiles; ++i) issue(i);
    if (pt < BR) {
      const int qr = q0 + pt;
      const float m = qr < T ? m_in[(long long)y * T + qr] : -INFINITY;
      const float l = qr < T ? l_in[(long long)y * T + qr] : 0.f;
      stats->m[pt] = (m == -INFINITY) ? 0.f : m;
      stats->l[pt] = (l == 0.f) ? 1.f : l;
      stats->seg[pt] = (qs && qr < T) ? qs[qr] : 0;
    }
    hop::mbar_arrive(q_ready);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t sK = stage(s), sV = sK + 2 * KT, sKt = sK + 4 * KT;
      if (AHEAD == 0 && pt == 0) issue(i);
      hop::mbar_wait(loaded + 8 * s, (i / STAGES) & 1);
      // At one stage V first: K^T may still be in use.
      if (AHEAD == 0) split_tile<KT>(generic(sV), generic(sV + KT), pt);
      if (i >= O_TILES) {
        if (AHEAD == 0 && i > 0) hop::mbar_wait(empty, (i - 1) & 1);
        transpose_split<D, BK, D>(generic(sK), generic(sKt),
                                  generic(sKt + KT), 0, pt);
        hop::named_barrier(1, WG);
        split_tile<KT>(generic(sK), generic(sK + KT), pt);
      }
      if (AHEAD > 0) split_tile<KT>(generic(sV), generic(sV + KT), pt);
      hop::fence_proxy_async();
      hop::mbar_arrive(full + 8 * s);
      if (AHEAD > 0 && pt == 0 && i + AHEAD < n_tiles) issue(i + AHEAD);
    }
    return;
  }

  hop::setmaxnreg_inc<Tiles<D>::DQ_REGS>();
  // Consumer warpgroup wg: this thread holds rows row[0] and row[1] =
  // row[0] + 8 of S, dP and dQ (of dQ's columns [n0, n0 + COLS)).
  const int wg = threadIdx.x / WG, t = threadIdx.x % WG, lane = t % 32;
  const int warp = t / 32, n0 = wg * COLS;
  int row[2];
  row[0] = q0 + warp * 16 + lane / 4;
  row[1] = row[0] + 8;
  // This warpgroup's A operand (warpgroup 0's Q, warpgroup 1's dO) as its
  // threads' fragments, raw (hop::wgmma_tf32's a: rows row[0] and row[1],
  // columns lane % 4 and lane % 4 + 4 of each step), rows past T zero:
  // in registers up to D = 128, else in shared memory at frags[kk WG + t],
  // read back by this thread only.
  float4 a_regs[A_REGS ? D / 8 : 1];
  float4* const frags =
      reinterpret_cast<float4*>(generic(sA)) + wg * (BR * D / 4);
  {
    const float* const src = (wg == 0 ? q : dout) + off + lane % 4;
    const bool in0 = row[0] < T, in1 = row[1] < T;
    const float* const r0 = src + (long long)row[0] * g.st;
    const float* const r1 = src + (long long)row[1] * g.st;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float4 a = make_float4(
          in0 ? r0[8 * kk] : 0.f, in1 ? r1[8 * kk] : 0.f,
          in0 ? r0[8 * kk + 4] : 0.f, in1 ? r1[8 * kk + 4] : 0.f);
      if constexpr (A_REGS)
        a_regs[kk] = a;
      else
        frags[kk * WG + t] = a;
    }
  }
  auto load_a = [&](int kk, uint32_t(&big)[4], uint32_t(&small)[4]) {
    float4 a;
    if constexpr (A_REGS)
      a = a_regs[kk];
    else
      a = frags[kk * WG + t];
    hop::tf32_split(a.x, big[0], small[0]);
    hop::tf32_split(a.y, big[1], small[1]);
    hop::tf32_split(a.z, big[2], small[2]);
    hop::tf32_split(a.w, big[3], small[3]);
  };

  hop::mbar_wait(q_ready, 0);
  float safe_m[2], denom[2], di[2];
  int my_seg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    safe_m[r] = stats->m[row[r] - q0];
    denom[r] = stats->l[row[r] - q0];
    my_seg[r] = stats->seg[row[r] - q0];
  }

  // di from the tiles of O: warpgroup 1 computes dO . O^T of each, and
  // the thread holding a row's diagonal entry stores it; warpgroup 0
  // frees the stages beside it.
#pragma unroll 1
  for (int i = 0; i < O_TILES; ++i) {
    const int s = i % STAGES;
    const uint32_t sV = stage(s) + 2 * KT;
    hop::mbar_wait(full + 8 * s, (i / STAGES) & 1);
    if (wg == 1) {
      float x[BK / 2];
      mma_head_dim_by<D, BK, dq_parts<D>()>(x, load_a, sV, sV + KT);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j / 2) % 2;
        const int col = i * BK + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        if (col == row[r] - q0) stats->di[col] = x[j];
      }
    }
    if constexpr (STAGES == 1) hop::mbar_arrive(kv_free);
    hop::mbar_arrive(empty + 8 * s);
  }
  hop::named_barrier(2, DQ_CONSUMERS);
#pragma unroll
  for (int r = 0; r < 2; ++r) di[r] = stats->di[row[r] - q0];

  // The sum over the key tiles, each tile's product added in f32 (PARTS'
  // note).
  float acc[COLS / 2];
#pragma unroll
  for (int j = 0; j < COLS / 2; ++j) acc[j] = 0.f;

  // Warpgroup 0's product is S = Q . K^T, warpgroup 1's dP = dO . V^T.
  for (int i = O_TILES; i < n_tiles; ++i) {
    const int s = i % STAGES, k0 = (i - O_TILES) * BK;
    const uint32_t sK = stage(s), sV = sK + 2 * KT, sKt = sK + 4 * KT;
    hop::mbar_wait(full + 8 * s, (i / STAGES) & 1);

    // This warpgroup's product, then the swap (swap_bytes).
    const uint32_t b_tile = wg == 0 ? sK : sV;
    uint32_t mine = b_tile, theirs = wg == 0 ? sV : sK;
    if constexpr (!swap_in_tiles(D)) {
      mine = sK + 6 * KT + wg * swap_bytes(BK);
      theirs = sK + 6 * KT + (1 - wg) * swap_bytes(BK);
    }
    float x[BK / 2], other[BK / 2];
    mma_head_dim_by<D, BK, dq_parts<D>()>(x, load_a, b_tile, b_tile + KT);
    float* const out = reinterpret_cast<float*>(generic(mine)) + t * (BK / 2);
    const float* const in =
        reinterpret_cast<const float*>(generic(theirs)) + t * (BK / 2);
#pragma unroll
    for (int j = 0; j < BK / 2; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    hop::named_barrier(2, DQ_CONSUMERS);
#pragma unroll
    for (int j = 0; j < BK / 2; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(in + j);
      other[j] = v.x, other[j + 1] = v.y, other[j + 2] = v.z,
      other[j + 3] = v.w;
    }
    // The swap's writes precede the producer's next TMA into the stage.
    hop::fence_proxy_async();
    if constexpr (STAGES == 1) hop::mbar_arrive(kv_free);

    // P = exp(S scale - m) / l and dS = P (dP - di), with the mask
    // (trouble spots 1-3) where the tile needs one.
    const bool need_mask = k0 + BK > T || ks != nullptr ||
                           (causal && k0 + BK - 1 > q0);
    float ds[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = (j / 2) % 2;
      const float sc = wg == 0 ? x[j] : other[j];
      const float dp = wg == 0 ? other[j] : x[j];
      bool ok = true;
      if (need_mask) {
        const int kc = k0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        ok = kc < T && (!causal || kc <= row[r]) &&
             (!ks || ks[kc] == my_seg[r]);
      }
      const float p = ok ? expf(sc * scale - safe_m[r]) / denom[r] : 0.f;
      ds[j] = p * (dp - di[r]);
    }

    // dQ += dS . K over the tile's keys, this warpgroup's columns, K^T as
    // B, into a fresh accumulator.
    uint32_t db[BK / 8][4], dsm[BK / 8][4];
    acc_fragments<BK>(ds, db, dsm);
    float tile_dq[COLS / 2];
    hop::wgmma_fence();
    mma_rows<BK, D, COLS>(tile_dq, db, dsm, sKt, sKt + KT, n0);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(tile_dq);
    hop::fence_regs(db);
    hop::fence_regs(dsm);
    hop::mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int j = 0; j < COLS / 2; ++j) acc[j] += tile_dq[j];
  }

  // The scale multiplies dQ after its products (trouble spot 3).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const long long at = off + (long long)row[r] * g.st + n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      const int e = 4 * j + 2 * r;
      *reinterpret_cast<float2*>(dq + at + 8 * j) =
          make_float2(acc[e] * scale, acc[e + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 256: the wide instances (D a multiple of 256, any size;
// the wrapper pads the others), every product in f32 FMA on the CUDA
// cores, so they keep f32 accuracy as the plain versions do.  A block of
// 256 threads, a 16 x 16 grid (ty, tx), owns 64 rows (q rows in the
// forward and dQ, keys in dK/dV) and the output columns [c0, c0 + COLS)
// (blockIdx.z; COLS 256 for O and dQ, 128 for dK and dV), and walks tiles
// of 32 of the other side.  No tile holds a whole row: the products that
// reduce over the head dim (S = Q.K^T and dP = dO.V^T, or their
// transposes) give each thread 4 rows by 2 columns of the 64 x 32 score
// tile and accumulate over chunks of 64 columns of both operands staged in
// shared memory (rows of 68 floats, float4 reads free of bank conflicts);
// the products that reduce over the tile's rows (O += P.V, dQ += dS.K, dV
// += P^T.dO, dK += dS^T.Q) read the score tile (64 x 36 floats) and the
// block's columns of the other operand (rows of COLS + 4 floats), each
// thread accumulating its 4 rows by COLS / 16 columns.  Each row's di
// sums dO * O over the whole head dim from device memory in the order the
// dP products sum (one thread a row, d ascending), so dP - di is exactly
// 0 where a row's one visible key is itself, as in exact arithmetic (the
// plain dQ forms it in f64; a strided f32 di left noise there at 2.2x the
// f32 row floor at [24, 2048, 512]).  What bounds them: the CUDA cores'
// f32 rate (67 TFLOP/s), against which every column block recomputes the
// scores.
// ---------------------------------------------------------------------------

namespace wide {

constexpr int THREADS = 256;
constexpr int BR = 64;             // q rows (forward, dQ) or keys (dK/dV)
constexpr int BC = 32;             // keys (forward, dQ) or q rows (dK/dV)
constexpr int DC = 64;             // columns of a head-dim chunk
constexpr int LDC = DC + 4;        // shared row length of a chunk
constexpr int LDP = BC + 4;        // shared row length of the score tile
constexpr int COLS = 256;          // O or dQ columns a block
constexpr int DKV_COLS = 128;      // dK and dV columns a block

// ROWS rows [r0, r0 + ROWS) and NCOLS columns [col0, col0 + NCOLS) of an
// operand (rows st floats apart from src) into shared rows of ld floats;
// rows past T read as zeros.
template <int ROWS, int NCOLS>
__device__ __forceinline__ void load(float* dst, int ld, const float* src,
                                     int r0, int T, long long st, int col0) {
  constexpr int V4 = NCOLS / 4;
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += THREADS) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * st +
                                           col0 + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// acc[i][j] += a_i . b_j over one chunk: a the rows ty * 4 + i of chunk A,
// b the rows tx + 16 j of chunk B.
__device__ __forceinline__ void dot_chunk(float (&acc)[4][2], const float* A,
                                          const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < DC; d += 4) {
    float4 a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LDC + d);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LDC + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 n + e] += sum_c P[ty * 4 + i][c] * B[c][64 n + 4 tx + e] over
// the BC rows of B (rows of N + 4 floats): this thread's columns of an
// N-column block.
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[4][N / 16],
                                           const float* P, const float* B,
                                           int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < BC; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * LDP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int n = 0; n < N / 64; ++n) {
        const float4 b = *reinterpret_cast<const float4*>(
            B + (c + cc) * (N + 4) + 64 * n + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                                            : cc == 2 ? p[i].z : p[i].w;
          acc[i][4 * n] = fmaf(pv, b.x, acc[i][4 * n]);
          acc[i][4 * n + 1] = fmaf(pv, b.y, acc[i][4 * n + 1]);
          acc[i][4 * n + 2] = fmaf(pv, b.z, acc[i][4 * n + 2]);
          acc[i][4 * n + 3] = fmaf(pv, b.w, acc[i][4 * n + 3]);
        }
      }
    }
  }
}

// This thread's rows (ty * 4 + i, below T from row r0) of an N-column
// accumulator, times `mul`, into columns [c0, c0 + N) of device memory.
template <int N>
__device__ __forceinline__ void store(float* dst, const float (&acc)[4][N / 16],
                                      int r0, int T, long long st, int c0,
                                      int ty, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= T) continue;
#pragma unroll
    for (int n = 0; n < N / 64; ++n)
      *reinterpret_cast<float4*>(dst + (long long)r * st + c0 + 64 * n +
                                 4 * tx) =
          make_float4(acc[i][4 * n] * mul, acc[i][4 * n + 1] * mul,
                      acc[i][4 * n + 2] * mul, acc[i][4 * n + 3] * mul);
  }
}

// A sum and a NaN-propagating max over the 16 threads of a row (tx).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// di of the row at `at` over the whole head dim, one FMA a column in
// ascending order (dot_chunk's).
__device__ __forceinline__ float row_di(const float* dout, const float* o,
                                        long long at, int D) {
  float part = 0.f;
  for (int d = 0; d < D; ++d) part = fmaf(dout[at + d], o[at + d], part);
  return part;
}

constexpr int fwd_smem_bytes() {
  return ((BR + BC) * LDC + BC * (COLS + 4) + BR * LDP) * 4;
}

constexpr int dq_smem_bytes() {
  return ((2 * BR + 2 * BC) * LDC + BC * (COLS + 4) + BR * LDP) * 4;
}

constexpr int dkv_smem_bytes() {
  return ((2 * BR + 2 * BC) * LDC + 2 * BC * (DKV_COLS + 4) +
          2 * BR * LDP + 4 * BC) * 4;
}


// Forward: one block per (64-row q tile, batch*head, 256 columns of O).
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_fwd_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ o,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out,
                              const int* __restrict__ qseg,
                              const int* __restrict__ kseg, Geometry g,
                              int D, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* const sQ = reinterpret_cast<float*>(smem4);  // a chunk of Q
  float* const sK = sQ + BR * LDC;                    // a chunk of K
  float* const sV = sK + BC * LDC;                    // V's columns
  float* const sP = sV + BC * (COLS + 4);
  const int T = g.T, y = blockIdx.x, c0 = blockIdx.z * COLS;
  // The last q tiles do the most work under causal masking: they start
  // first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long off = base_offset(g, y);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  int row[4], my_seg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty * 4 + i;
    my_seg[i] = (qs && row[i] < T) ? qs[row[i]] : 0;
  }
  float acc[4][COLS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < COLS / 16; ++n) acc[i][n] = 0.f;
  float m_i[4], l_part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_i[i] = -INFINITY, l_part[i] = 0.f;

  const int kend = causal ? min(T, q0 + BR) : T;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    float s[4][2] = {};
    for (int dc = 0; dc < D; dc += DC) {
      __syncthreads();  // the previous chunk (and tile) is no longer read
      load<BR, DC>(sQ, LDC, q + off, q0, T, g.st, dc);
      load<BC, DC>(sK, LDC, k + off, k0, T, g.st, dc);
      __syncthreads();
      dot_chunk(s, sQ, sK, ty, tx);
    }
    load<BC, COLS>(sV, COLS + 4, v + off, k0, T, g.st, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = kc < T && (!causal || kc <= row[i]) &&
                        (!ks || ks[kc] == my_seg[i]);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = max_nan(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = max_nan(m_i[i], mx);
      const float safe_m = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr =
          (m_i[i] == -INFINITY) ? 0.f : expf(m_i[i] - safe_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - safe_m);
        sum += p;
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
      l_part[i] = l_part[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int n = 0; n < COLS / 16; ++n) acc[i][n] *= corr;
    }
    __syncthreads();
    accumulate<COLS>(acc, sP, sV, ty, tx);
  }

  // Epilogue: l == 0 divides by 1 (a fully masked row: o = 0, m = -inf,
  // l = 0); every column block computes the same m and l, the first one
  // writes them.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum(l_part[i]);
    const float denom = (l == 0.f) ? 1.f : l;
    if (row[i] >= T) continue;
#pragma unroll
    for (int n = 0; n < COLS / 64; ++n)
      *reinterpret_cast<float4*>(o + off + (long long)row[i] * g.st + c0 +
                                 64 * n + 4 * tx) =
          make_float4(acc[i][4 * n] / denom, acc[i][4 * n + 1] / denom,
                      acc[i][4 * n + 2] / denom, acc[i][4 * n + 3] / denom);
    if (blockIdx.z == 0 && tx == 0) {
      m_out[(long long)y * T + row[i]] = m_i[i];
      l_out[(long long)y * T + row[i]] = l;
    }
  }
}

// dQ: one block per (64-row q tile, batch*head, 256 columns of dQ); walks
// key tiles of 32.
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_dq_wide_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ o,
                             const float* __restrict__ dout,
                             const float* __restrict__ m_in,
                             const float* __restrict__ l_in,
                             const int* __restrict__ qseg,
                             const int* __restrict__ kseg,
                             float* __restrict__ dq, Geometry g, int D,
                             int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* const sQ = reinterpret_cast<float*>(smem4);  // chunks of Q, dO
  float* const sdO = sQ + BR * LDC;
  float* const sK = sdO + BR * LDC;                   // chunks of K, V
  float* const sV = sK + BC * LDC;
  float* const sKc = sV + BC * LDC;                   // K's columns
  float* const sS = sKc + BC * (COLS + 4);
  const int T = g.T, y = blockIdx.x, c0 = blockIdx.z * COLS;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long off = base_offset(g, y);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  // di = rowsum(dO * O) from the stored o, one thread a row, summed in
  // the order dot_chunk sums dP (d ascending, one FMA each): where a row's
  // one visible key is itself (o = v there) dP - di is then exactly 0, as
  // in exact arithmetic (the score tile holds them until the loop).
  if (threadIdx.x < BR) {
    const int r = q0 + threadIdx.x;
    sS[threadIdx.x] =
        r < T ? row_di(dout, o, off + (long long)r * g.st, D) : 0.f;
  }
  __syncthreads();
  // Each row's statistics: safe_m, denom (trouble spot 1) and di.
  int row[4], my_seg[4];
  float safe_m[4], denom[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty * 4 + i;
    float m = -INFINITY, l = 0.f;
    my_seg[i] = 0;
    if (row[i] < T) {
      m = m_in[(long long)y * T + row[i]];
      l = l_in[(long long)y * T + row[i]];
      if (qs) my_seg[i] = qs[row[i]];
    }
    di[i] = sS[ty * 4 + i];
    safe_m[i] = (m == -INFINITY) ? 0.f : m;
    denom[i] = (l == 0.f) ? 1.f : l;
  }

  float acc[4][COLS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < COLS / 16; ++n) acc[i][n] = 0.f;

  const int kend = causal ? min(T, q0 + BR) : T;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    float s[4][2] = {}, dp[4][2] = {};
    for (int dc = 0; dc < D; dc += DC) {
      __syncthreads();
      load<BR, DC>(sQ, LDC, q + off, q0, T, g.st, dc);
      load<BR, DC>(sdO, LDC, dout + off, q0, T, g.st, dc);
      load<BC, DC>(sK, LDC, k + off, k0, T, g.st, dc);
      load<BC, DC>(sV, LDC, v + off, k0, T, g.st, dc);
      __syncthreads();
      dot_chunk(s, sQ, sK, ty, tx);
      dot_chunk(dp, sdO, sV, ty, tx);
    }
    load<BC, COLS>(sKc, COLS + 4, k + off, k0, T, g.st, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = kc < T && (!causal || kc <= row[i]) &&
                        (!ks || ks[kc] == my_seg[i]);
        const float p = ok ? expf(s[i][j] * scale - safe_m[i]) / denom[i]
                           : 0.f;
        sS[(ty * 4 + i) * LDP + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    __syncthreads();
    accumulate<COLS>(acc, sS, sKc, ty, tx);
  }
  // The scale multiplies dQ after its products (trouble spot 3).
  store<COLS>(dq + off, acc, q0, T, g.st, c0, ty, tx, scale);
}

// dK/dV: one block per (64-key tile, batch*head, 128 columns of dK and
// dV); walks q tiles of 32 on the transposed scores S^T = K . Q^T.
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_dkv_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ o,
                              const float* __restrict__ dout,
                              const float* __restrict__ m_in,
                              const float* __restrict__ l_in,
                              const int* __restrict__ qseg,
                              const int* __restrict__ kseg,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Geometry g, int D, int causal, float scale) {
  constexpr int N = DKV_COLS;
  extern __shared__ float4 smem4[];
  float* const sK = reinterpret_cast<float*>(smem4);  // chunks of K, V
  float* const sV = sK + BR * LDC;
  float* const sQ = sV + BR * LDC;                    // chunks of Q, dO
  float* const sdO = sQ + BC * LDC;
  float* const sQc = sdO + BC * LDC;                  // Q's columns
  float* const sdOc = sQc + BC * (N + 4);             // dO's columns
  float* const sP = sdOc + BC * (N + 4);              // P^T, [key][q row]
  float* const sdS = sP + BR * LDP;                   // dS^T
  float* const st_m = sdS + BR * LDP;     // per q row of the tile: safe_m,
  float* const st_l = st_m + BC;          // denom,
  float* const st_di = st_l + BC;         // di
  int* const st_seg = reinterpret_cast<int*>(st_di + BC);  // and segment
  const int T = g.T, y = blockIdx.x, k0 = blockIdx.y * BR;
  const int c0 = blockIdx.z * N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long off = base_offset(g, y);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  int key[4], key_seg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = k0 + ty * 4 + i;
    key_seg[i] = (ks && key[i] < T) ? ks[key[i]] : 0;
  }
  float acc_dk[4][N / 16], acc_dv[4][N / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < N / 16; ++n) acc_dk[i][n] = acc_dv[i][n] = 0.f;

  // Causal: the q tiles from the first one holding a row q >= k0.
  const int q_start = causal ? (k0 / BC) * BC : 0;
  for (int q0 = q_start; q0 < T; q0 += BC) {
    float s[4][2] = {}, dp[4][2] = {};
    for (int dc = 0; dc < D; dc += DC) {
      __syncthreads();  // the previous chunk (and tile) is no longer read
      load<BR, DC>(sK, LDC, k + off, k0, T, g.st, dc);
      load<BR, DC>(sV, LDC, v + off, k0, T, g.st, dc);
      load<BC, DC>(sQ, LDC, q + off, q0, T, g.st, dc);
      load<BC, DC>(sdO, LDC, dout + off, q0, T, g.st, dc);
      __syncthreads();
      dot_chunk(s, sK, sQ, ty, tx);
      dot_chunk(dp, sV, sdO, ty, tx);
    }
    load<BC, N>(sQc, N + 4, q + off, q0, T, g.st, c0);
    load<BC, N>(sdOc, N + 4, dout + off, q0, T, g.st, c0);
    if (threadIdx.x < BC) {
      // The tile's statistics, one thread a row; di from the stored o,
      // summed in the order dot_chunk sums dP^T (see the dQ kernel).
      const int rr = threadIdx.x, qr = q0 + rr;
      float m = -INFINITY, l = 0.f, di = 0.f;
      int seg = 0;
      if (qr < T) {
        m = m_in[(long long)y * T + qr];
        l = l_in[(long long)y * T + qr];
        if (qs) seg = qs[qr];
        di = row_di(dout, o, off + (long long)qr * g.st, D);
      }
      st_m[rr] = (m == -INFINITY) ? 0.f : m;
      st_l[rr] = (l == 0.f) ? 1.f : l;
      st_di[rr] = di;
      st_seg[rr] = seg;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qc = tx + 16 * j, qr = q0 + qc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = qr < T && key[i] < T && (!causal || qr >= key[i]) &&
                        (!qs || st_seg[qc] == key_seg[i]);
        const float p =
            ok ? expf(s[i][j] * scale - st_m[qc]) / st_l[qc] : 0.f;
        sP[(ty * 4 + i) * LDP + qc] = p;
        sdS[(ty * 4 + i) * LDP + qc] = p * (dp[i][j] - st_di[qc]);
      }
    }
    __syncthreads();
    accumulate<N>(acc_dv, sP, sdOc, ty, tx);
    accumulate<N>(acc_dk, sdS, sQc, ty, tx);
  }
  // The scale multiplies dK after its products (trouble spot 3).
  store<N>(dk + off, acc_dk, k0, T, g.st, c0, ty, tx, scale);
  store<N>(dv + off, acc_dv, k0, T, g.st, c0, ty, tx, 1.f);
}

}  // namespace wide

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

Geometry make_geometry(int H, int seg_heads, int T, long long sb,
                       long long st, long long sh) {
  Geometry g;
  g.H = H;
  g.seg_heads = seg_heads;
  g.T = T;
  g.sb = sb;
  g.st = st;
  g.sh = sh;
  return g;
}

// A 4-D map (d, t, h, b) over one f32 operand, boxes of [rows, BOX] with
// the head dim's swizzle; rows past T read as zeros.  The folded [B*H, T,
// D] layout is H = 1 (its head stride is never stepped: any legal value).
// The launches call prepare first, which makes the device's primary
// context current in the calling thread, as the encoder needs.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH,
                     const Geometry& g, int rows) {
  auto encode = hop::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  using S = hop::Swizzle<D, 4>;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)g.T, (cuuint64_t)g.H,
                        (cuuint64_t)(BH / g.H)};
  cuuint64_t strides[3] = {(cuuint64_t)g.st * 4,
                           (cuuint64_t)(g.H == 1 ? g.sb : g.sh) * 4,
                           (cuuint64_t)g.sb * 4};
  cuuint32_t box[4] = {(cuuint32_t)S::BOX, (cuuint32_t)rows, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      const_cast<void*>(ptr), dims, strides, box, step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, S::TMA,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, const void* qseg, const void* kseg,
                       int BH, const Geometry& g, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  static_assert(smem <= SMEM_LIMIT, "forward tiles fit a block");
  constexpr int FBC = Tiles<D>::FWD_BC;
  CUtensorMap tq, tk, tv;
  cudaError_t err = prepare(flash_f32_fwd_kernel<D>, smem);
  if (err == cudaSuccess) err = make_map<D>(&tq, q, BH, g, BR);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, BH, g, FBC);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, BH, g, FBC);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + BR - 1) / BR);
  flash_f32_fwd_kernel<D><<<grid, Tiles<D>::FWD_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), g, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* m,
                      const void* l, const void* qseg, const void* kseg,
                      void* dq, int BH, const Geometry& g, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  static_assert(smem <= SMEM_LIMIT, "dQ tiles fit a block");
  constexpr int BK = Tiles<D>::DQ_BK;
  CUtensorMap tk, tv, to;
  cudaError_t err = prepare(flash_f32_dq_kernel<D>, smem);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, BH, g, BK);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, BH, g, BK);
  if (err == cudaSuccess) err = make_map<D>(&to, o, BH, g, BK);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + BR - 1) / BR);
  flash_f32_dq_kernel<D><<<grid, DQ_THREADS, smem, stream>>>(
      tk, tv, to, static_cast<const float*>(q),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<float*>(dq), g, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* m,
                       const void* l, const void* qseg, const void* kseg,
                       void* dk, void* dv, int BH, const Geometry& g,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  static_assert(smem <= SMEM_LIMIT, "dK/dV tiles fit a block");
  constexpr int BQ = Tiles<D>::DKV_BQ;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = prepare(flash_f32_dkv_kernel<D>, smem);
  if (err == cudaSuccess) err = make_map<D>(&tq, q, BH, g, BQ);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, BH, g, BR);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, BH, g, BR);
  if (err == cudaSuccess) err = make_map<D>(&tdo, dout, BH, g, BQ);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + BR - 1) / BR, D / Tiles<D>::DKV_COLS);
  flash_f32_dkv_kernel<D><<<grid, DKV_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(o),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<float*>(dk), static_cast<float*>(dv), g, causal, scale);
  return cudaGetLastError();
}


// The wide launches: grids of (batch*head, row tiles, column blocks).
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* o, void* m, void* l, const void* qseg,
                            const void* kseg, int BH, const Geometry& g,
                            int D, int causal, float scale,
                            cudaStream_t stream) {
  constexpr int smem = wide::fwd_smem_bytes();
  cudaError_t err = prepare(wide::flash_f32_fwd_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + wide::BR - 1) / wide::BR, D / wide::COLS);
  wide::flash_f32_fwd_wide_kernel<<<grid, wide::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg), g, D,
      causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* m,
                           const void* l, const void* qseg, const void* kseg,
                           void* dq, int BH, const Geometry& g, int D,
                           int causal, float scale, cudaStream_t stream) {
  constexpr int smem = wide::dq_smem_bytes();
  cudaError_t err = prepare(wide::flash_f32_dq_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + wide::BR - 1) / wide::BR, D / wide::COLS);
  wide::flash_f32_dq_wide_kernel<<<grid, wide::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<float*>(dq), g, D, causal,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* m,
                            const void* l, const void* qseg,
                            const void* kseg, void* dk, void* dv, int BH,
                            const Geometry& g, int D, int causal,
                            float scale, cudaStream_t stream) {
  constexpr int smem = wide::dkv_smem_bytes();
  cudaError_t err = prepare(wide::flash_f32_dkv_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + wide::BR - 1) / wide::BR, D / wide::DKV_COLS);
  wide::flash_f32_dkv_wide_kernel<<<grid, wide::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<float*>(dk),
      static_cast<float*>(dv), g, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes, with the signatures of
// flash_attention.cu's: every tensor f32 ([BH, T] m and l), segment ids
// int32 ([BH / seg_heads, T], or null).  D is 16, 32, 64, 128 or 256, or
// a multiple of 256 above it (the wide instances).

#define HVD_SWITCH_D(CALL, WIDE_CALL)                               \
  switch (D) {                                                      \
    case 16: return (int)CALL(16);                                  \
    case 32: return (int)CALL(32);                                  \
    case 64: return (int)CALL(64);                                  \
    case 128: return (int)CALL(128);                                \
    case 256: return (int)CALL(256);                                \
    default:                                                        \
      if (D > 256 && D % wide::COLS == 0) return (int)WIDE_CALL;    \
      return (int)cudaErrorInvalidValue;                            \
  }

extern "C" int hvd_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* m, void* l, const void* qseg,
                                 const void* kseg, int BH, int H,
                                 int seg_heads, int T, int D, long long sb,
                                 long long st, long long sh, int causal,
                                 float scale, void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD) \
  launch_fwd<DD>(q, k, v, o, m, l, qseg, kseg, BH, g, causal, scale, s)
  HVD_SWITCH_D(CALL, launch_fwd_wide(q, k, v, o, m, l, qseg, kseg, BH, g, D,
                                     causal, scale, s))
#undef CALL
}

extern "C" int hvd_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* m,
                                    const void* l, const void* qseg,
                                    const void* kseg, void* dq, int BH, int H,
                                    int seg_heads, int T, int D, long long sb,
                                    long long st, long long sh, int causal,
                                    float scale, void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD)                                                       \
  launch_dq<DD>(q, k, v, o, dout, m, l, qseg, kseg, dq, BH, g, causal, \
                scale, s)
  HVD_SWITCH_D(CALL, launch_dq_wide(q, k, v, o, dout, m, l, qseg, kseg, dq,
                                    BH, g, D, causal, scale, s))
#undef CALL
}

extern "C" int hvd_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* m,
                                     const void* l, const void* qseg,
                                     const void* kseg, void* dk, void* dv,
                                     int BH, int H, int seg_heads, int T,
                                     int D, long long sb, long long st,
                                     long long sh, int causal, float scale,
                                     void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD)                                                          \
  launch_dkv<DD>(q, k, v, o, dout, m, l, qseg, kseg, dk, dv, BH, g, causal, \
                 scale, s)
  HVD_SWITCH_D(CALL, launch_dkv_wide(q, k, v, o, dout, m, l, qseg, kseg, dk,
                                     dv, BH, g, D, causal, scale, s))
#undef CALL
}
