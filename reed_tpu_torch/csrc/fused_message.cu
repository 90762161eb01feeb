// Fused k-NN message MLP for Hopper (sm_90a): forward (K2a) and backward
// (K2b), the ports of the TPU kernels `_fwd_kernel` and `_bwd_kernel` in
// reed_tpu/ops/fused_message.py.
//
// Forward, for every node i (flattened over batch and length) and slot k:
//   et  = e_feat[i,k] . W_e + nbr_src[b, e_idx[i,k]]   (times mask[i,k] in mode pre)
//   m1  = gelu(et + pre_self[i])
//   m2  = gelu(m1 . W2 + b2)
//   msg = m2 . W3 + b3                                 (times mask[i,k] in mode post)
// and dh[i] = sum_k msg[i,k] / scale and/or msg. GELU is the erf form in f32.
// The backward recomputes pre, m1, z2, m2 per tile, then
//   g3 = (gdh / scale broadcast over K + gmsg)        (times mask in mode post)
//   g2 = g3 . W3^T * gelu'(z2);  g1 = g2 . W2^T * gelu'(pre)
//   d pre_self = sum_k g1;  ge = g1 (times mask in mode pre)
//   d e_feat = ge . W_e^T;  d nbr_src[e_idx] += ge (atomic adds)
//   dW_e = e_feat^T ge, dW2 = m1^T g2, db2 = sum g2, dW3 = m2^T g3, db3 = sum g3.
// Rounding points are the TPU kernel's: with bf16 inputs m1, m2, g3, g2 and
// ge are rounded to bf16 where they enter a product; db2, db3 and d pre_self
// sum f32 values; every product accumulates in f32.
//
// One tile engine serves every product: "rows x Cin of an operand in shared
// memory, times a weight (or its transpose) streamed through a cp.async
// ring, into m16n8 accumulators", and its TN form "X^T G over rows" for the
// weight gradients. It is templated on the dtype's MMA policy:
//   - f32: 3xTF32. Each operand word x is split where its fragment is
//     loaded into hi = x rounded to TF32 (to nearest, ties away: the
//     rounding of cvt.rna.tf32.f32, in two integer operations) and lo = x -
//     hi, and every product is three mma.sync.m16n8k8 tf32 (lo.hi + hi.lo +
//     hi.hi, f32 accumulate), issued pass by pass over the warp's tiles.
//     That keeps f32 accuracy (~6e-7 relative, against ~5e-4 for one TF32
//     product; tests/test_torch_fused_message_tf32.py) at an effective 495 /
//     3 = 165 TFLOP/s.
//   - bf16: one mma.sync.m16n8k16 bf16 per product, f32 accumulate.
// Operand tiles are 32-bit words (f32, or bf16 pairs) in rows padded so
// that every fragment load is free of bank conflicts (pitches below); rows
// read along k come by ldmatrix (on 32-bit words it returns exactly the
// tf32 fragment), columns read down k word by word. Weights stream in
// chunks of 32 words of depth (32 f32 or 64 bf16 rows of W, or 128 rows of
// W^T) through a two-stage ring of 16-byte cp.async copies, so chunk j + 1
// is in flight while chunk j multiplies; e_feat streams the same way as the
// first product's left operand, and the neighbour rows nbr_src[e_idx] are
// gathered by cp.async while that product runs.
//
// Tiles are whole nodes: 64 edge rows (2 nodes at K = 30, 60 rows used; 16
// at K = 4), so each node's K-sum stays in its block, summed in slot order.
// 8 warps: 2 across the rows (32 each) times 4 across 128 output columns.
//   K2a: one block per tile, 89,856 bytes of shared memory (the two rings
//   and one activation tile for the gathered rows, m1, m2 and then the f32
//   messages), two blocks (16 warps) per SM.
//   K2b, design b: a tile kernel recomputes the chain and runs the five
//   row-major backward products (one block per tile, 106,240 bytes, two
//   blocks per SM: two operand slots, gelu'(pre) in registers, gelu'(z2) in
//   shared memory), writes the rounded operands of the weight gradients
//   (m1, m2, g3, g2, ge) and each tile's f32 db2, db3; a second kernel
//   computes dW_e, dW2, dW3 as long TN products over all E edge rows, split
//   into fixed row ranges (enough blocks for two an SM), and two small
//   kernels add the ranges and the tiles in order, so the weight gradients
//   are the same on every run. d nbr_src is an atomicAdd into a zeroed f32
//   buffer (the order of the adds, so the last bits, vary from run to run).
// Measured on the H100 in f32 at ProteinMPNN's cases (tools/
// message_variants.py, PERF.md): 64-row tiles beat 96 and 128 (those fit
// one block of 8 warps an SM), 8 warps a block beat 16 on 128-row tiles, a
// third ring stage loses an SM's second block, and design b's K2b is
// 1.8-2.1x faster than design a (kWgradInTile), where each tile's TN products and
// their read-modify-write of a per-block partial sit in the tile kernel
// with one block an SM.
//
// What bounds it: per edge the forward does 2*(Ce*D + 2*D*D) flops and the
// backward 2*(3*Ce*D + 5*D*D) on ~(Ce + D) values moved, so at ProteinMPNN's
// D = 128, Ce = 128/256 both are bound by operations: at 165 TFLOP/s in f32
// (3xTF32) and 989 in bf16. On the H100 mma.sync reaches ~310-320 TFLOP/s
// of TF32 and ~640 of bf16 (tools/message_variants.py), so 3xTF32 through
// it is at most ~105. What holds the
// kernels back now is latency more than a rate: 16 warps an SM (registers
// allow no more), a barrier every ring chunk, and epilogues (gather, erf
// GELUs, the operand stores) that sit between products; wgmma with TMA and
// warp-specialised loads would be the next step.
//
// What does not carry over from the TPU: the Pallas kernels hold nbr_src[b]
// in VMEM and gather it with a one-hot matmul; here the gather is an
// indexed row copy from L2, and an index outside [0, L) gathers and
// receives nothing. The TPU grid runs in order, so it accumulates d nbr_src
// and the weight gradients in its outputs; here blocks run in no order
// (atomics for d nbr_src, fixed-order partial sums for the weights).
//
// The engine refuses (the C entry points return cudaErrorInvalidValue and
// the Python wrapper raises first, naming the cause): D not a multiple of 16
// or above 128 (one 128-column pass of output; bf16 k-steps of 16), Ce not
// a multiple of 8 (16-byte copies), K above a tile's edge rows, and float
// tensors whose base address is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;                  // a block's warps
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 16 / kWarps;    // blocks an SM should hold (16 warps)
constexpr int kWarpsN = 4;                // warps across a product's 128 output columns
constexpr int kWarpsM = kWarps / kWarpsN;  // warps across a tile's rows
constexpr int kMaxD = 128;
constexpr int kNT = kMaxD / 8 / kWarpsN;   // n8 tiles a warp owns
constexpr int kFwdRows = 64;               // edge rows of a K2a tile
constexpr int kBwdRows = 64;               // edge rows of a K2b tile
constexpr int kFwdStages = 2;              // ring depth, K2a
constexpr int kBwdStages = 2;              // ring depth, K2b
// K2b's weight gradients: false, as long TN products in a kernel of their
// own over the operands the tile kernel writes (design b); true, inside the
// tile kernel into per-block partials (design a, kept for
// tools/message_variants.py)
constexpr bool kWgradInTile = false;
constexpr int kChunkWords = 32;            // reduction depth of a ring chunk, in 32-bit words
constexpr int kTnRows = 64;                // rows of a TN chunk (weight-gradient kernel)
constexpr int kTnCols = 32 * kWarpsM;      // output rows of a TN block
constexpr int kTnStages = 2;               // ring depth, weight-gradient kernel
constexpr float kInvSqrt2 = 0.70710678118654752f;

static_assert(kWarpsM * kWarpsN == kWarps, "warps tile a product's rows and columns");

enum MaskMode { kMaskNone = 0, kMaskPre = 1, kMaskPost = 2 };

// ---------------------------------------------------------------------------
// Scalars, global loads and stores
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * kInvSqrt2));
}

// (gelu(x), gelu'(x)) from one erf: with Phi = (1 + erf(x / sqrt 2)) / 2,
// gelu = x Phi and gelu' = Phi + x phi(x); the same values as gelu() and the
// derivative taken apart (the halving is exact).
__device__ __forceinline__ float2 gelu_and_grad(float x) {
  constexpr float kInvSqrt2Pi = 0.39894228040143268f;
  const float cdf = 0.5f * (1.f + erff(x * kInvSqrt2));
  return make_float2(x * cdf, cdf + x * kInvSqrt2Pi * expf(-0.5f * x * x));
}

// ---------------------------------------------------------------------------
// Shared-memory tiles: 32-bit words (f32, or bf16 pairs), padded rows
// ---------------------------------------------------------------------------
//
// Pitches (in words) are compile-time constants, so a fragment address is a
// per-thread base plus an immediate. A tile read along its rows (A row-major,
// W^T chunks) has a pitch of 4 (mod 32) words: lanes (g, t) read rows g,
// words t, at banks 4g + t. A tile read down its columns (a weight chunk
// [k][n], the TN operands) has a pitch of 8 (mod 32) words in f32 (banks 8t
// + g) and 4 (mod 32) in bf16, where a lane reads the halves of rows 2t and
// 2t + 1: both are D + 8 elements. Every fragment load of the engine is
// then free of bank conflicts.

template <typename T>
__host__ __device__ constexpr int words_of(int elems) {
  return elems * (int)sizeof(T) / 4;
}
template <typename T>
constexpr int kTP = words_of<T>(kMaxD) + 4;        // activation tile of T
constexpr int kFP = kMaxD + 4;                      // f32 staging tile
constexpr int kAP = kChunkWords + 4;                // e_feat chunk, W^T chunk
template <typename T>
constexpr int kWP = words_of<T>(kMaxD + 8);         // W chunk [k][n]
template <typename T>
constexpr int kXP = words_of<T>(kTnCols + 8);       // TN chunk of X [k][m]
template <typename T>
constexpr int kKc = kChunkWords * 4 / (int)sizeof(T);  // k of a ring chunk, in elements
// one weight chunk, either layout (f32: 32 x 136 or 128 x 36 words)
constexpr int kStageWords = kMaxD * kAP > 32 * (kMaxD + 8) ? kMaxD * kAP : 32 * (kMaxD + 8);
static_assert(kKc<float> * kWP<float> <= kStageWords &&
                  kKc<__nv_bfloat16> * kWP<__nv_bfloat16> <= kStageWords,
              "a weight chunk fits a stage");

// Element pair (r, c), (r, c + 1) of a tile of T (c even).
template <typename T>
__device__ __forceinline__ void store_pair(uint32_t* tile, int pitch, int r, int c, float a,
                                          float b);
template <>
__device__ __forceinline__ void store_pair<float>(uint32_t* tile, int pitch, int r, int c,
                                                  float a, float b) {
  *reinterpret_cast<uint2*>(tile + r * pitch + c) =
      make_uint2(__float_as_uint(a), __float_as_uint(b));
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(uint32_t* tile, int pitch, int r,
                                                          int c, float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
  tile[r * pitch + (c >> 1)] = *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const uint32_t* tile, int pitch, int r, int c);
template <>
__device__ __forceinline__ float2 load_pair<float>(const uint32_t* tile, int pitch, int r, int c) {
  const uint2 v = *reinterpret_cast<const uint2*>(tile + r * pitch + c);
  return make_float2(__uint_as_float(v.x), __uint_as_float(v.y));
}
template <>
__device__ __forceinline__ float2 load_pair<__nv_bfloat16>(const uint32_t* tile, int pitch, int r,
                                                           int c) {
  const uint32_t w = tile[r * pitch + (c >> 1)];
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile row i (i < rows), words [0, cw) <- src[i * ld + c0 ...], cw / 4
// 16-byte pieces a row; a piece is zero-filled where i >= valid_rows or its
// first element is at or past valid_cols (valid_cols is a multiple of the
// piece's elements, so a piece is either all in or all out).
template <typename T, int kPitch>
__device__ __forceinline__ void copy_block(uint32_t* tile, const T* src, long long ld, int rows,
                                           int valid_rows, int c0, int cw, int valid_cols) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per piece
  const int pieces = cw / 4;
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int r = i / pieces;
    const int p = i - r * pieces;
    const int col = c0 + p * kPer;
    const bool in = r < valid_rows && col < valid_cols;
    cp_async_16(tile + r * kPitch + 4 * p, in ? src + r * ld + col : src, in ? 16 : 0);
  }
}

// copy_block with the rows and the pieces a row known at compile time (the
// full tiles of the main path): no division, an unrolled loop.
template <typename T, int kPitch, int kRows, int kPieces>
__device__ __forceinline__ void copy_fixed(uint32_t* tile, const T* src, long long ld,
                                           int valid_rows, int c0, int valid_cols) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kN = kRows * kPieces;
#pragma unroll
  for (int i0 = 0; i0 < kN; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    if (kN % kThreads == 0 || i < kN) {
      const int r = i / kPieces;
      const int p = i % kPieces;
      const int col = c0 + p * kPer;
      const bool in = r < valid_rows && col < valid_cols;
      cp_async_16(tile + r * kPitch + 4 * p, in ? src + r * ld + col : src, in ? 16 : 0);
    }
  }
}

// Tile row r (r < rows) <- row row_nbr[r] of src [., D]; zeros where
// row_nbr[r] < 0 (an index outside [0, L), or a row past the tile's edge).
// The neighbour gather, issued as one cp.async group ahead of the first
// product so that it lands while that product runs.
template <typename T>
__device__ __forceinline__ void gather_rows(uint32_t* tile, const T* src, const int* row_nbr,
                                            int rows, int D) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const int pieces = words_of<T>(D) / 4;
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int r = i / pieces;
    const int p = i - r * pieces;
    const int nbr = row_nbr[r];
    cp_async_16(tile + r * kTP<T> + 4 * p, nbr >= 0 ? src + (long long)nbr * D + p * kPer : src,
                nbr >= 0 ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// MMA policies
// ---------------------------------------------------------------------------

// d += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), d 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 matrices of 16-bit values from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8 and receives the 32-bit word l % 4
// of row l / 4 of each matrix. On rows of 32-bit words (f32, or bf16 pairs)
// that is word (g, t) of four 8-row x 4-word blocks: a fragment word.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Fragment words that are the same for both policies, in word units (one
// f32 or two bf16 along k): g = lane / 4, t = lane % 4.
// A row-major from a tile of rows m and words w (k): rows m0 + g (+ 8),
// words w0 + t (+ 4), one ldmatrix.
template <int kPitch>
__device__ __forceinline__ void rows_a(uint32_t (&w)[4], const uint32_t* s, int m0, int w0,
                                       int lane) {
  ldsm_x4(w, s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + w0 + (lane >> 4) * 4);
}
// B of two n8 tiles from a tile of rows n and words w (k), B[k][n] =
// tile[n][k]: words (n0 + g, w0 + t (+ 4)) into w[0], w[1] and (n0 + 8 + g,
// ...) into w[2], w[3], one ldmatrix.
template <int kPitch>
__device__ __forceinline__ void rows_b2(uint32_t (&w)[4], const uint32_t* s, int n0, int w0,
                                        int lane) {
  ldsm_x4(w, s + (n0 + (lane & 7) + (lane >> 4) * 8) * kPitch + w0 + ((lane >> 3) & 1) * 4);
}

// f32 through three TF32 products a piece. x = hi + lo with hi = x rounded
// to TF32 (to nearest, ties away from zero: cvt.rna.tf32.f32's rounding,
// done here in two full-rate integer operations, where cvt is a
// quarter-rate conversion) and lo = x - hi, exact in f32, which the tensor
// core reads as TF32 by dropping its low 13 bits.
struct Tf32x3 {
  using T = float;
  static constexpr int kK = 8;  // reduction depth of one mma
  static constexpr int kPasses = 3;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  __device__ static __forceinline__ void split(uint32_t w, uint32_t& hi, uint32_t& lo) {
    hi = (w + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(__uint_as_float(w) - __uint_as_float(hi));
  }
  __device__ static __forceinline__ A make_a(const uint32_t (&w)[4]) {
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(w[i], a.hi[i], a.lo[i]);
    return a;
  }
  __device__ static __forceinline__ B make_b(const uint32_t (&w)[2]) {
    B b;
#pragma unroll
    for (int i = 0; i < 2; ++i) split(w[i], b.hi[i], b.lo[i]);
    return b;
  }
  // pass 0: lo.hi, 1: hi.lo, 2: hi.hi (the small terms first); a caller
  // runs one pass over all its tiles before the next, so that no mma waits
  // on the one before it
  __device__ static __forceinline__ void mma(int pass, float (&d)[4], const A& a, const B& b) {
    if (pass == 0) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
    if (pass == 1) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
    if (pass == 2) mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
  }
  // B k-major: B[k][n] = tile[k][n] (a weight chunk, or G of a TN product)
  template <int kPitch>
  __device__ static __forceinline__ void kmajor_b(uint32_t (&w)[2], const uint32_t* s, int k0,
                                                  int n0, int g, int t) {
    const uint32_t* p = s + (k0 + t) * kPitch + n0 + g;
    w[0] = p[0];
    w[1] = p[4 * kPitch];
  }
  // A k-major: A[m][k] = tile[k][m] (X of a TN product)
  template <int kPitch>
  __device__ static __forceinline__ void kmajor_a(uint32_t (&w)[4], const uint32_t* s, int k0,
                                                  int m0, int g, int t) {
    const uint32_t* p = s + (k0 + t) * kPitch + m0 + g;
    w[0] = p[0];
    w[1] = p[8];
    w[2] = p[4 * kPitch];
    w[3] = p[4 * kPitch + 8];
  }
};

// bf16: one product a piece; k-major fragments are packed from two halves.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kPasses = 1;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  __device__ static __forceinline__ A make_a(const uint32_t (&w)[4]) {
    return A{{w[0], w[1], w[2], w[3]}};
  }
  __device__ static __forceinline__ B make_b(const uint32_t (&w)[2]) { return B{{w[0], w[1]}}; }
  __device__ static __forceinline__ void mma(int, float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.r, b.r[0], b.r[1]);
  }
  // (element (k, c), element (k + 1, c)) as one word, k in the low half
  template <int kPitch>
  __device__ static __forceinline__ uint32_t pair_k(const uint32_t* s, int k, int c) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(s + k * kPitch) + c;
    return (uint32_t)h[0] | ((uint32_t)h[2 * kPitch] << 16);
  }
  template <int kPitch>
  __device__ static __forceinline__ void kmajor_b(uint32_t (&w)[2], const uint32_t* s, int k0,
                                                  int n0, int g, int t) {
    w[0] = pair_k<kPitch>(s, k0 + 2 * t, n0 + g);
    w[1] = pair_k<kPitch>(s, k0 + 2 * t + 8, n0 + g);
  }
  template <int kPitch>
  __device__ static __forceinline__ void kmajor_a(uint32_t (&w)[4], const uint32_t* s, int k0,
                                                  int m0, int g, int t) {
    w[0] = pair_k<kPitch>(s, k0 + 2 * t, m0 + g);
    w[1] = pair_k<kPitch>(s, k0 + 2 * t, m0 + g + 8);
    w[2] = pair_k<kPitch>(s, k0 + 2 * t + 8, m0 + g);
    w[3] = pair_k<kPitch>(s, k0 + 2 * t + 8, m0 + g + 8);
  }
};

// ---------------------------------------------------------------------------
// The tile engine
// ---------------------------------------------------------------------------

// This thread's place: g = lane / 4 and t = lane % 4 within the m16n8 layout;
// warp (wm, wn) owns rows wm * kMT * 16 .. and columns wn * 32 .. of a product.
struct Lane {
  int lane, g, t, wm, wn;
  __device__ Lane()
      : lane(threadIdx.x & 31),
        g((threadIdx.x & 31) >> 2),
        t(threadIdx.x & 3),
        wm((threadIdx.x >> 5) / kWarpsN),
        wn((threadIdx.x >> 5) % kWarpsN) {}
};

template <int kMT>
__device__ __forceinline__ void zero(float (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// Runs `chunks` chunks through a ring of kStages stages: load(j, stage)
// issues chunk j's cp.async copies, compute(j, stage) consumes it. Chunk
// j + kStages - 1 is in flight while chunk j computes. Starts with a
// barrier, so earlier readers of the ring and writers of the operands are
// done; cp.async groups committed before the call are complete by the
// first compute.
template <int kStages, class Load, class Compute>
__device__ __forceinline__ void pipeline(int chunks, Load&& load, Compute&& compute) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk j has landed for all; chunk j - 1's stage is free
    const int next = j + kStages - 1;
    if (next < chunks) load(next, next % kStages);
    cp_async_commit();
    compute(j, j % kStages);
  }
}

// One k-step of a row-major product: acc[mt][nt] += A . B over kK of depth.
// The fragment words first, then the products pass by pass. kFull: every
// n8 tile of the warp is valid (no guard around the mma, whose
// convergence the compiler cannot otherwise assume).
template <class P, int kMT, int kAPitch, int kBPitch, bool kTransB, bool kFull>
__device__ __forceinline__ void kstep(float (&acc)[kMT][kNT][4], const uint32_t* as, int aw,
                                      const uint32_t* bs, int bk, int nvalid, const Lane& ln) {
  uint32_t ra[kMT][4], rb[kNT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
    rows_a<kAPitch>(ra[mt], as, (ln.wm * kMT + mt) * 16, aw, ln.lane);
  if constexpr (kTransB) {  // bk in words; rows past nvalid are read, never used
#pragma unroll
    for (int nt = 0; nt < kNT; nt += 2) {
      uint32_t r[4];
      rows_b2<kBPitch>(r, bs, (ln.wn * kNT + nt) * 8, bk, ln.lane);
      rb[nt][0] = r[0];
      rb[nt][1] = r[1];
      rb[nt + 1][0] = r[2];
      rb[nt + 1][1] = r[3];
    }
  } else {  // bk in rows
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = (ln.wn * kNT + nt) * 8;
      rb[nt][0] = rb[nt][1] = 0u;
      if (kFull || n < nvalid) P::template kmajor_b<kBPitch>(rb[nt], bs, bk, n, ln.g, ln.t);
    }
  }
  typename P::A a[kMT];
  typename P::B b[kNT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) a[mt] = P::make_a(ra[mt]);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) b[nt] = P::make_b(rb[nt]);
#pragma unroll
  for (int pass = 0; pass < P::kPasses; ++pass)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      if (kFull || (ln.wn * kNT + nt) * 8 < nvalid)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) P::mma(pass, acc[mt][nt], a[mt], b[nt]);
}

// acc += A . B over k < kdim for this warp's rows and columns:
//   A: kStreamA ? x[r * ldx + k] (rows r >= xrows are zeros), streamed through
//      a_ring (kStages x kRows x kAP words)
//      : the resident tile A (pitch kTP<T>; k counts from word 0);
//   B: kTransB ? w[(n0 + n) * ldw + k] : w[k * ldw + n], for n < nvalid,
//      streamed through b_ring (kStages x kStageWords words).
template <class P, int kRows, int kStages, bool kTransB, bool kStreamA, bool kFull>
__device__ __forceinline__ void product_impl(float (&acc)[kRows / 16 / kWarpsM][kNT][4],
                                             const uint32_t* A, const typename P::T* x,
                                             long long ldx, int xrows, uint32_t* a_ring,
                                             const typename P::T* w, int ldw, int n0,
                                             int nvalid, int kdim, uint32_t* b_ring,
                                             const Lane& ln) {
  using T = typename P::T;
  constexpr int kMT = kRows / 16 / kWarpsM;
  constexpr int kK = kKc<T>;                 // k of a chunk, in elements
  constexpr int kASW = kRows * kAP;          // words of an A stage
  constexpr int kBPitch = kTransB ? kAP : kWP<T>;
  const int chunks = (kdim + kK - 1) / kK;
  const T* wb = kTransB ? w + (long long)n0 * ldw : w;
  pipeline<kStages>(
      chunks,
      [&](int j, int s) {
        uint32_t* bs = b_ring + s * kStageWords;
        if constexpr (kTransB) {
          if constexpr (kFull)
            copy_fixed<T, kAP, kMaxD, kChunkWords / 4>(bs, wb, ldw, kMaxD, j * kK, kdim);
          else
            copy_block<T, kAP>(bs, wb, ldw, nvalid, nvalid, j * kK, kChunkWords, kdim);
        } else {
          if constexpr (kFull)
            copy_fixed<T, kWP<T>, kK, words_of<T>(kMaxD) / 4>(
                bs, wb + (long long)j * kK * ldw, ldw, kK, 0, kMaxD);
          else
            copy_block<T, kWP<T>>(bs, wb + (long long)j * kK * ldw, ldw, kK, kdim - j * kK, 0,
                                  words_of<T>(nvalid), nvalid);
        }
        if constexpr (kStreamA) {
          if constexpr (kFull)
            copy_fixed<T, kAP, kRows, kChunkWords / 4>(a_ring + s * kASW, x, ldx, xrows, j * kK,
                                                       kdim);
          else
            copy_block<T, kAP>(a_ring + s * kASW, x, ldx, kRows, xrows, j * kK, kChunkWords,
                               kdim);
        }
      },
      [&](int j, int s) {
        const uint32_t* bs = b_ring + s * kStageWords;
        const uint32_t* as = kStreamA ? a_ring + s * kASW : A;
        const int aw = kStreamA ? 0 : j * kChunkWords;
        if (kFull) {
#pragma unroll
          for (int ks = 0; ks < kChunkWords / 8; ++ks)
            kstep<P, kMT, kStreamA ? kAP : kTP<T>, kBPitch, kTransB, true>(
                acc, as, aw + 8 * ks, bs, kTransB ? 8 * ks : ks * P::kK, nvalid, ln);
        } else {
          const int ksteps = min(kChunkWords / 8, (kdim - j * kK + P::kK - 1) / P::kK);
#pragma unroll 1
          for (int ks = 0; ks < ksteps; ++ks)
            kstep<P, kMT, kStreamA ? kAP : kTP<T>, kBPitch, kTransB, false>(
                acc, as, aw + 8 * ks, bs, kTransB ? 8 * ks : ks * P::kK, nvalid, ln);
        }
      });
}

template <class P, int kRows, int kStages, bool kTransB, bool kStreamA>
__device__ __forceinline__ void product(float (&acc)[kRows / 16 / kWarpsM][kNT][4],
                                        const uint32_t* A, const typename P::T* x, long long ldx,
                                        int xrows, uint32_t* a_ring, const typename P::T* w,
                                        int ldw, int n0, int nvalid, int kdim, uint32_t* b_ring,
                                        const Lane& ln) {
  if (nvalid == kMaxD && kdim % kKc<typename P::T> == 0)
    product_impl<P, kRows, kStages, kTransB, kStreamA, true>(acc, A, x, ldx, xrows, a_ring, w,
                                                             ldw, n0, nvalid, kdim, b_ring, ln);
  else
    product_impl<P, kRows, kStages, kTransB, kStreamA, false>(acc, A, x, ldx, xrows, a_ring, w,
                                                              ldw, n0, nvalid, kdim, b_ring, ln);
}

// acc += X^T G over kRows rows of two tiles, for this warp's part of a
// kTnCols-row output block: output rows xcol0 + 32 wm + 16 mt (m16 tiles
// below mvalid) of X's columns, output columns 32 wn + 8 nt (< nvalid) of G's.
// Rows of X and G past the data are zeros.
template <class P, int kRows, int kXPitch, int kGPitch>
__device__ __forceinline__ void tn_accumulate(float (&acc)[2][kNT][4], const uint32_t* X,
                                              int xcol0, int mvalid, const uint32_t* G,
                                              int nvalid, const Lane& ln) {
#pragma unroll 2
  for (int k0 = 0; k0 < kRows; k0 += P::kK) {
    uint32_t ra[2][4], rb[kNT][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ra[mt][0] = ra[mt][1] = ra[mt][2] = ra[mt][3] = 0u;
      if (32 * ln.wm + 16 * mt < mvalid)
        P::template kmajor_a<kXPitch>(ra[mt], X, k0, xcol0 + 32 * ln.wm + 16 * mt, ln.g, ln.t);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      rb[nt][0] = rb[nt][1] = 0u;
      if (32 * ln.wn + 8 * nt < nvalid)
        P::template kmajor_b<kGPitch>(rb[nt], G, k0, 32 * ln.wn + 8 * nt, ln.g, ln.t);
    }
    typename P::A a[2];
    typename P::B b[kNT];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) a[mt] = P::make_a(ra[mt]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) b[nt] = P::make_b(rb[nt]);
    // out-of-range tiles multiply zeros: no guard around the mma
#pragma unroll
    for (int pass = 0; pass < P::kPasses; ++pass)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) P::mma(pass, acc[mt][nt], a[mt], b[nt]);
  }
}

// out[row][col] (row stride D) = (accumulate ? out : 0) + acc for a TN
// output block at row0, rows < nrows, columns < D.
__device__ __forceinline__ void store_tn(float* out, int row0, int nrows, int D, bool accumulate,
                                         const float (&acc)[2][kNT][4], const Lane& ln) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 32 * ln.wm + 16 * mt + ln.g + 8 * h;
      if (row >= nrows) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = 32 * ln.wn + 8 * nt + 2 * ln.t;
        if (col >= D) continue;
        float2* p = reinterpret_cast<float2*>(out + (long long)row * D + col);
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (accumulate) {
          const float2 o = *p;
          v.x += o.x;
          v.y += o.y;
        }
        *p = v;
      }
    }
}

// f(mt, nt, h, row, col) for each pair of this thread's accumulators,
// acc[mt][nt][2h] and acc[mt][nt][2h + 1] at (row, col) and (row, col + 1),
// with col < D.
template <int kMT, class F>
__device__ __forceinline__ void for_pairs(int D, const Lane& ln, F&& f) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (ln.wm * kMT + mt) * 16 + ln.g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = (ln.wn * kNT + nt) * 8 + 2 * ln.t;
        if (col < D) f(mt, nt, h, row, col);
      }
    }
}

// colsum[wm][col] = this warp's rows' sum of v (accumulator layout) for its
// columns; the caller adds the kWarpsM rows in order after a barrier.
template <int kMT>
__device__ __forceinline__ void warp_colsum(const float (&v)[kMT][kNT][4], float* colsum,
                                            const Lane& ln) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) s += v[mt][nt][j] + v[mt][nt][2 + j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (ln.g == 0) colsum[ln.wm * kMaxD + 32 * ln.wn + 8 * nt + 2 * ln.t + j] = s;
    }
}

// out[c] = (accumulate ? out[c] : 0) + sum over the row warps of colsum[.][c], c < D
__device__ __forceinline__ void store_colsum(float* out, const float* colsum, int D,
                                             bool accumulate) {
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < kWarpsM; ++m) s += colsum[m * kMaxD + c];
    out[c] = accumulate ? out[c] + s : s;
  }
}

// For each edge row r < n of a tile: row_nbr[r], the row of nbr_src it
// gathers (-1: none, for an index outside [0, L) or a row past the tile);
// row_mask[r], its mask; row_self[r], its node (the row of pre_self).
__device__ __forceinline__ void fill_rows(int* row_nbr, float* row_mask, int* row_self, int n,
                                          const int* __restrict__ e_idx,
                                          const float* __restrict__ mask, int mask_mode,
                                          long long e0, int node0, int rows, int K, int L) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    int nbr = -1, self = node0;
    float m = 0.f;
    if (r < rows) {
      self = node0 + r / K;
      const int j = e_idx[e0 + r];
      nbr = (j >= 0 && j < L) ? self / L * L + j : -1;
      m = mask_mode == kMaskNone ? 1.f : mask[e0 + r];
    }
    row_nbr[r] = nbr;
    row_mask[r] = m;
    row_self[r] = self;
  }
}

// ---------------------------------------------------------------------------
// K2a: forward
// ---------------------------------------------------------------------------

// Shared memory (dynamic, 16-byte aligned), in 32-bit words: the weight
// ring, the e_feat ring, one activation tile (the gathered nbr_src rows,
// then m1, then m2, as T; then the f32 messages), then row_nbr, row_mask
// and row_self [kFwdRows].
constexpr size_t kFwdSmemBytes =
    4 * ((size_t)kFwdStages * (kStageWords + kFwdRows * kAP) + kFwdRows * kFP) +
    (size_t)kFwdRows * 12;

template <class P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_message_fwd_kernel(const typename P::T* __restrict__ pre_self,
                             const typename P::T* __restrict__ e_feat,
                             const typename P::T* __restrict__ nbr_src,
                             const int* __restrict__ e_idx, const float* __restrict__ mask,
                             const typename P::T* __restrict__ w_e,
                             const typename P::T* __restrict__ w2,
                             const typename P::T* __restrict__ b2,
                             const typename P::T* __restrict__ w3,
                             const typename P::T* __restrict__ b3, typename P::T* __restrict__ dh,
                             typename P::T* __restrict__ msg, int num_nodes, int L, int K, int D,
                             int Ce, int nodes_per_tile, int mask_mode, float scale) {
  using T = typename P::T;
  constexpr int kMT = kFwdRows / 16 / kWarpsM;
  constexpr int tp = kTP<T>;
  extern __shared__ uint4 smem_u4[];
  uint32_t* b_ring = reinterpret_cast<uint32_t*>(smem_u4);
  uint32_t* a_ring = b_ring + kFwdStages * kStageWords;
  uint32_t* act = a_ring + kFwdStages * kFwdRows * kAP;
  int* row_nbr = reinterpret_cast<int*>(act + kFwdRows * kFP);
  float* row_mask = reinterpret_cast<float*>(row_nbr + kFwdRows);
  int* row_self = reinterpret_cast<int*>(row_mask + kFwdRows);

  const Lane ln;
  const int node0 = blockIdx.x * nodes_per_tile;
  const int nodes = min(nodes_per_tile, num_nodes - node0);
  const int rows = nodes * K;  // valid edge rows, a prefix of the tile
  const long long e0 = (long long)node0 * K;
  fill_rows(row_nbr, row_mask, row_self, kFwdRows, e_idx, mask, mask_mode, e0, node0, rows, K,
            L);
  __syncthreads();
  gather_rows<T>(act, nbr_src, row_nbr, kFwdRows, D);  // nbr_src[e_idx] into act
  cp_async_commit();

  float acc[kMT][kNT][4];

  // et = e_feat . W_e (both streamed) + nbr_src[e_idx];
  // m1 = round(gelu(et (* mask) + pre_self)) over the gathered rows
  zero(acc);
  product<P, kFwdRows, kFwdStages, false, true>(acc, nullptr, e_feat + e0 * Ce, Ce, rows,
                                                a_ring, w_e, D, 0, D, Ce, b_ring, ln);
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    float v0 = 0.f, v1 = 0.f;
    if (row < rows) {
      const float2 s = load_pair<T>(act, tp, row, col);
      float2 et = make_float2(acc[mt][nt][2 * h] + s.x, acc[mt][nt][2 * h + 1] + s.y);
      if (mask_mode == kMaskPre) {
        et.x *= row_mask[row];
        et.y *= row_mask[row];
      }
      const float2 ps = load2(pre_self + (long long)row_self[row] * D + col);
      v0 = round_to<T>(gelu(et.x + ps.x));
      v1 = round_to<T>(gelu(et.y + ps.y));
    }
    store_pair<T>(act, tp, row, col, v0, v1);  // the pair this thread read
  });

  // m2 = round(gelu(m1 . W2 + b2))
  zero(acc);
  product<P, kFwdRows, kFwdStages, false, false>(acc, act, nullptr, 0, 0, nullptr, w2, D, 0, D,
                                                 D, b_ring, ln);
  __syncthreads();  // every read of m1 is done before m2 overwrites it
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    float v0 = 0.f, v1 = 0.f;
    if (row < rows) {
      const float2 b = load2(b2 + col);
      v0 = round_to<T>(gelu(acc[mt][nt][2 * h] + b.x));
      v1 = round_to<T>(gelu(acc[mt][nt][2 * h + 1] + b.y));
    }
    store_pair<T>(act, tp, row, col, v0, v1);
  });

  // msg = m2 . W3 + b3 (* mask); the f32 messages stay in act for dh
  zero(acc);
  product<P, kFwdRows, kFwdStages, false, false>(acc, act, nullptr, 0, 0, nullptr, w3, D, 0, D,
                                                 D, b_ring, ln);
  __syncthreads();  // every read of m2 is done before the messages overwrite it
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    if (row >= rows) return;
    const float2 b = load2(b3 + col);
    float v0 = acc[mt][nt][2 * h] + b.x, v1 = acc[mt][nt][2 * h + 1] + b.y;
    if (mask_mode == kMaskPost) {
      v0 *= row_mask[row];
      v1 *= row_mask[row];
    }
    if (msg != nullptr) store2(msg + (e0 + row) * D + col, v0, v1);
    store_pair<float>(act, kFP, row, col, v0, v1);
  });
  if (dh == nullptr) return;

  // dh = sum over each node's K rows / scale, in slot order, in f32
  __syncthreads();
  for (int idx = threadIdx.x; idx < nodes * D; idx += kThreads) {
    const int n = idx / D;
    const int col = idx - n * D;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += __uint_as_float(act[(n * K + k) * kFP + col]);
    store1(dh + (long long)(node0 + n) * D + col, s / scale);
  }
}

// ---------------------------------------------------------------------------
// K2b, design b: the tile kernel and the weight-gradient kernel
// ---------------------------------------------------------------------------

// The tile kernel. Shared memory, in 32-bit words: the weight ring; two
// slots of kBwdRows x kFP words, A and B (what each holds when is below);
// colsum [kWarpsM][kMaxD] f32; row_nbr, row_mask and row_self [kBwdRows].
constexpr int kBwdSlotWords = kBwdRows * kFP;
constexpr size_t kBwdSmemBytes =
    4 * ((size_t)kBwdStages * kStageWords + 2 * (size_t)kBwdSlotWords + kWarpsM * kMaxD) +
    (size_t)kBwdRows * 12;
static_assert(kBwdStages * kBwdRows * kAP <= kBwdSlotWords,
              "the first product's e_feat ring fits slot B");

// It writes the rounded operands of the weight gradients, ops [5][E][D] of
// T: m1, m2, g3, g2, ge; and each tile's db2 and db3 (f32 sums) into
// bias [tiles][2 D]. The weight-gradient kernel computes the rest.
template <class P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_message_bwd_kernel(const typename P::T* __restrict__ pre_self,
                             const typename P::T* __restrict__ e_feat,
                             const typename P::T* __restrict__ nbr_src,
                             const int* __restrict__ e_idx, const float* __restrict__ mask,
                             const typename P::T* __restrict__ w_e,
                             const typename P::T* __restrict__ w2,
                             const typename P::T* __restrict__ b2,
                             const typename P::T* __restrict__ w3,
                             const typename P::T* __restrict__ gdh,
                             const typename P::T* __restrict__ gmsg,
                             typename P::T* __restrict__ d_pre_self,
                             typename P::T* __restrict__ d_e_feat, float* __restrict__ d_nbr_src,
                             typename P::T* __restrict__ ops, float* __restrict__ bias,
                             int num_nodes, int L, int K, int D, int Ce, int nodes_per_tile,
                             int mask_mode, float scale) {
  using T = typename P::T;
  constexpr int kMT = kBwdRows / 16 / kWarpsM;
  constexpr int tp = kTP<T>;
  extern __shared__ uint4 smem_u4[];
  uint32_t* b_ring = reinterpret_cast<uint32_t*>(smem_u4);
  uint32_t* sa = b_ring + kBwdStages * kStageWords;  // nbr rows, m1; gelu'(z2); g1 (f32)
  uint32_t* sb = sa + kBwdSlotWords;  // the first product's e_feat ring; g3; g2; ge
  float* colsum = reinterpret_cast<float*>(sb + kBwdSlotWords);
  int* row_nbr = reinterpret_cast<int*>(colsum + kWarpsM * kMaxD);
  float* row_mask = reinterpret_cast<float*>(row_nbr + kBwdRows);
  int* row_self = reinterpret_cast<int*>(row_mask + kBwdRows);

  const Lane ln;
  const int node0 = blockIdx.x * nodes_per_tile;
  const int nodes = min(nodes_per_tile, num_nodes - node0);
  const int rows = nodes * K;
  const long long e0 = (long long)node0 * K;
  const long long E = (long long)num_nodes * K;
  T* op_m1 = ops + e0 * D;
  T* op_m2 = op_m1 + E * D;
  T* op_g3 = op_m2 + E * D;
  T* op_g2 = op_g3 + E * D;
  T* op_ge = op_g2 + E * D;
  float* db2 = bias + (long long)blockIdx.x * 2 * D;
  float* db3 = db2 + D;

  fill_rows(row_nbr, row_mask, row_self, kBwdRows, e_idx, mask, mask_mode, e0, node0, rows,
              K, L);
  __syncthreads();
  gather_rows<T>(sa, nbr_src, row_nbr, kBwdRows, D);  // nbr_src[e_idx] into A
  cp_async_commit();

  float acc[kMT][kNT][4];
  float dpre[kMT][kNT][4];  // gelu'(pre) in the accumulators' layout

  // Recompute 1: pre = (e_feat . W_e + nbr_src[e_idx]) (* mask) + pre_self;
  // m1 = round(gelu(pre)) into A (over the gathered rows) and ops, gelu'(pre) into dpre
  zero(acc);
  product<P, kBwdRows, kBwdStages, false, true>(acc, nullptr, e_feat + e0 * Ce, Ce, rows, sb,
                                                w_e, D, 0, D, Ce, b_ring, ln);
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    float v0 = 0.f, v1 = 0.f, d0 = 0.f, d1 = 0.f;
    if (row < rows) {
      const float2 s = load_pair<T>(sa, tp, row, col);
      float2 et = make_float2(acc[mt][nt][2 * h] + s.x, acc[mt][nt][2 * h + 1] + s.y);
      if (mask_mode == kMaskPre) {
        et.x *= row_mask[row];
        et.y *= row_mask[row];
      }
      const float2 ps = load2(pre_self + (long long)row_self[row] * D + col);
      const float2 q0 = gelu_and_grad(et.x + ps.x), q1 = gelu_and_grad(et.y + ps.y);
      v0 = round_to<T>(q0.x);
      v1 = round_to<T>(q1.x);
      d0 = q0.y;
      d1 = q1.y;
      store2(op_m1 + (long long)row * D + col, v0, v1);
    }
    store_pair<T>(sa, tp, row, col, v0, v1);  // the pair this thread read
    dpre[mt][nt][2 * h] = d0;
    dpre[mt][nt][2 * h + 1] = d1;
  });

  // Recompute 2: z2 = m1 . W2 + b2; m2 = round(gelu(z2)) into ops; gelu'(z2)
  // in f32 into A (m1 is done)
  zero(acc);
  product<P, kBwdRows, kBwdStages, false, false>(acc, sa, nullptr, 0, 0, nullptr, w2, D, 0, D, D,
                                                 b_ring, ln);
  __syncthreads();  // every read of m1 is done
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    float d0 = 0.f, d1 = 0.f;
    if (row < rows) {
      const float2 b = load2(b2 + col);
      const float2 q0 = gelu_and_grad(acc[mt][nt][2 * h] + b.x);
      const float2 q1 = gelu_and_grad(acc[mt][nt][2 * h + 1] + b.y);
      store2(op_m2 + (long long)row * D + col, round_to<T>(q0.x), round_to<T>(q1.x));
      d0 = q0.y;
      d1 = q1.y;
    }
    store_pair<float>(sa, kFP, row, col, d0, d1);
  });

  // g3 = (gdh / scale + gmsg) (* mask in mode post), f32 in acc; round(g3)
  // into B (the first product's ring, free since the second product's
  // first barrier) and ops; db3 = sum g3
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    float g0 = 0.f, g1 = 0.f;
    if (row < rows) {
      if (gdh != nullptr) {
        const float2 g = load2(gdh + (long long)row_self[row] * D + col);
        g0 = g.x / scale;
        g1 = g.y / scale;
      }
      if (gmsg != nullptr) {
        const float2 g = load2(gmsg + (e0 + row) * D + col);
        g0 += g.x;
        g1 += g.y;
      }
      if (mask_mode == kMaskPost) {
        g0 *= row_mask[row];
        g1 *= row_mask[row];
      }
      store2(op_g3 + (long long)row * D + col, g0, g1);
    }
    acc[mt][nt][2 * h] = g0;
    acc[mt][nt][2 * h + 1] = g1;
    store_pair<T>(sb, tp, row, col, round_to<T>(g0), round_to<T>(g1));
  });
  warp_colsum(acc, colsum, ln);
  store_colsum(db3, colsum, D, false);

  // g2 = round(g3) . W3^T * gelu'(z2) (f32 in acc); db2 = sum g2; round(g2)
  // into B (g3 is done) and ops
  zero(acc);
  product<P, kBwdRows, kBwdStages, true, false>(acc, sb, nullptr, 0, 0, nullptr, w3, D, 0, D, D,
                                                b_ring, ln);
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    const float2 dz = load_pair<float>(sa, kFP, row, col);
    acc[mt][nt][2 * h] *= dz.x;
    acc[mt][nt][2 * h + 1] *= dz.y;
  });
  warp_colsum(acc, colsum, ln);
  store_colsum(db2, colsum, D, false);  // starts with a barrier: every read of g3 is done
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    const float g0 = round_to<T>(acc[mt][nt][2 * h]), g1 = round_to<T>(acc[mt][nt][2 * h + 1]);
    if (row < rows) store2(op_g2 + (long long)row * D + col, g0, g1);
    store_pair<T>(sb, tp, row, col, g0, g1);
  });

  // g1 = round(g2) . W2^T * gelu'(pre): g1 in f32 into A (gelu'(z2) is done)
  // for d pre_self; ge = round(g1 (* mask in mode pre)) into B (g2 is done),
  // ops and d nbr_src[b, e_idx] (atomic adds)
  zero(acc);
  product<P, kBwdRows, kBwdStages, true, false>(acc, sb, nullptr, 0, 0, nullptr, w2, D, 0, D, D,
                                                b_ring, ln);
  __syncthreads();  // every read of g2 is done
  for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
    const float g0 = acc[mt][nt][2 * h] * dpre[mt][nt][2 * h];
    const float g1 = acc[mt][nt][2 * h + 1] * dpre[mt][nt][2 * h + 1];
    store_pair<float>(sa, kFP, row, col, g0, g1);
    const float m = mask_mode == kMaskPre ? row_mask[row] : 1.f;
    const float e0v = round_to<T>(g0 * m), e1v = round_to<T>(g1 * m);
    store_pair<T>(sb, tp, row, col, e0v, e1v);
    if (row < rows) {
      store2(op_ge + (long long)row * D + col, e0v, e1v);
      const int nbr = row_nbr[row];
      if (nbr >= 0)
        atomicAdd(reinterpret_cast<float2*>(d_nbr_src + (long long)nbr * D + col),
                  make_float2(e0v, e1v));
    }
  });
  __syncthreads();
  // d pre_self = sum over each node's K rows of g1, in slot order
  for (int idx = threadIdx.x; idx < nodes * D; idx += kThreads) {
    const int n = idx / D;
    const int col = idx - n * D;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += __uint_as_float(sa[(n * K + k) * kFP + col]);
    store1(d_pre_self + (long long)(node0 + n) * D + col, s);
  }

  // d e_feat = ge . W_e^T, 128 output columns at a time
  for (int ce0 = 0; ce0 < Ce; ce0 += kMaxD) {
    const int nv = min(kMaxD, Ce - ce0);
    zero(acc);
    product<P, kBwdRows, kBwdStages, true, false>(acc, sb, nullptr, 0, 0, nullptr, w_e, D, ce0,
                                                  nv, D, b_ring, ln);
    for_pairs<kMT>(nv, ln, [&](int mt, int nt, int h, int row, int col) {
      if (row < rows)
        store2(d_e_feat + (e0 + row) * Ce + ce0 + col, acc[mt][nt][2 * h],
               acc[mt][nt][2 * h + 1]);
    });
  }
}

// The weight-gradient kernel: dW_e = e_feat^T ge, dW2 = m1^T g2, dW3 = m2^T
// g3 as long TN products over all E edge rows. Block (o, s) computes output
// block o (64 rows of one weight gradient, all D columns) over the s-th of
// `ranges` fixed row ranges and writes it to partial[s] (layout dW_e, dW2,
// dW3); sum_grads_kernel adds the ranges in order. Shared memory: kTnStages
// stages of an X chunk [kTnRows][kTnCols] and a G chunk [kTnRows][D].
template <typename T>
constexpr int kTnStageWords = kTnRows * (kXP<T> + kWP<T>);
template <typename T>
constexpr size_t kTnSmemBytes = 4 * (size_t)kTnStages * kTnStageWords<T>;

template <class P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_message_wgrad_kernel(const typename P::T* __restrict__ e_feat,
                               const typename P::T* __restrict__ ops, long long E, int D, int Ce,
                               int ranges, float* __restrict__ partial) {
  using T = typename P::T;
  extern __shared__ uint4 smem_u4[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem_u4);
  const Lane ln;
  const int n_ce = (Ce + kTnCols - 1) / kTnCols;
  const int n_d = (D + kTnCols - 1) / kTnCols;
  const int n_out = n_ce + 2 * n_d;
  const int o = blockIdx.x % n_out;  // neighbouring blocks read the same rows
  const int s = blockIdx.x / n_out;
  const T* X;
  const T* G;
  int ldx, xcol0, mvalid;
  float* out = partial + (long long)s * ((long long)Ce * D + 2 * D * D);
  if (o < n_ce) {  // dW_e rows 64 o ..
    X = e_feat, ldx = Ce, xcol0 = kTnCols * o, G = ops + 4 * E * D;
    out += (long long)xcol0 * D;
  } else if (o < n_ce + n_d) {  // dW2
    X = ops, ldx = D, xcol0 = kTnCols * (o - n_ce), G = ops + 3 * E * D;
    out += (long long)Ce * D + (long long)xcol0 * D;
  } else {  // dW3
    X = ops + E * D, ldx = D, xcol0 = kTnCols * (o - n_ce - n_d), G = ops + 2 * E * D;
    out += (long long)Ce * D + (long long)D * D + (long long)xcol0 * D;
  }
  mvalid = min(kTnCols, ldx - xcol0);
  const long long chunks = (E + kTnRows - 1) / kTnRows;
  const long long c0 = s * chunks / ranges, c1 = (s + 1) * chunks / ranges;

  float acc[2][kNT][4];
  zero(acc);
  pipeline<kTnStages>(
      (int)(c1 - c0),
      [&](int j, int st) {
        uint32_t* xs = ring + st * kTnStageWords<T>;
        uint32_t* gs = xs + kTnRows * kXP<T>;
        const long long row0 = (c0 + j) * kTnRows;
        const int valid = (int)min((long long)kTnRows, E - row0);
        copy_fixed<T, kXP<T>, kTnRows, words_of<T>(kTnCols) / 4>(xs, X + row0 * ldx, ldx, valid,
                                                                xcol0, ldx);
        if (D == kMaxD)
          copy_fixed<T, kWP<T>, kTnRows, words_of<T>(kMaxD) / 4>(gs, G + row0 * D, D, valid, 0,
                                                                 D);
        else
          copy_block<T, kWP<T>>(gs, G + row0 * D, D, kTnRows, valid, 0, words_of<T>(D), D);
      },
      [&](int, int st) {
        const uint32_t* xs = ring + st * kTnStageWords<T>;
        tn_accumulate<P, kTnRows, kXP<T>, kWP<T>>(acc, xs, 0, mvalid, xs + kTnRows * kXP<T>, D,
                                                  ln);
      });
  store_tn(out, 0, mvalid, D, false, acc, ln);
}

// d_weights = [dW_e, dW2, db2, dW3, db3]: the weight gradients summed over
// the row ranges in order (one thread an element), and then
// sum_bias_kernel's bias gradients.
__global__ void sum_grads_kernel(const float* __restrict__ partial, int ranges, int Ce, int D,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_wm = Ce * D + 2 * D * D;
  const int end_w2 = Ce * D + D * D;
  if (i >= n_wm) return;
  float s = 0.f;
  for (int b = 0; b < ranges; ++b) s += partial[(long long)b * n_wm + i];
  out[i < end_w2 ? i : i + D] = s;  // dW3 comes after db2
}

// db2 (j < D) and db3 (j >= D) of d_weights: block j sums bias[t][j] over
// the tiles t, each thread a fixed stride of tiles, then a fixed tree.
__global__ void sum_bias_kernel(const float* __restrict__ bias, int tiles, int Ce, int D,
                                float* __restrict__ out) {
  __shared__ float part[kThreads / 32];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int t = threadIdx.x; t < tiles; t += kThreads) s += bias[(long long)t * 2 * D + j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += part[w];
    const int end_w2 = Ce * D + D * D;
    out[j < D ? end_w2 + j : end_w2 + D + D * D + (j - D)] = total;
  }
}

// ---------------------------------------------------------------------------
// K2b, design a (kWgradInTile, for tools/message_variants.py): the weight
// gradients inside the tile kernel. The grid is persistent; each block walks
// its tiles and adds their dW_e, dW2, dW3 (TN products over the tile's
// rows, 64 output rows at a time) and db2, db3 straight from the
// accumulators into its own f32 partial in a [grid, Ce*D + 2*D*D + 2*D]
// workspace (d_weights' layout); sum_partials_kernel adds the blocks in
// order. Four operand tiles live at once: m1 (then ge), m2 (then g1 in f32,
// over the next slot too in bf16), g3, g2 (gelu'(z2) in f32 over it in f32,
// in a slot of its own in bf16).
// ---------------------------------------------------------------------------

template <class P>
struct PartialsSmem {
  using T = typename P::T;
  static constexpr int kSlotWords = kBwdRows * kTP<T>;
  static constexpr int kDzWords = sizeof(T) == 4 ? 0 : kBwdRows * kFP;
  static constexpr size_t kBytes =
      4 * ((size_t)kBwdStages * kStageWords + 4 * (size_t)kSlotWords + kDzWords +
           kWarpsM * kMaxD) +
      (size_t)kBwdRows * 12;
  static_assert(kBwdStages * kBwdRows * kAP <= 2 * kSlotWords, "e_feat ring over slots 2, 3");
  static_assert(kBwdStages * kBwdRows * kXP<T> <= 3 * kSlotWords, "dW_e ring over slots 1-3");
  static_assert(kBwdRows * kFP <= 2 * kSlotWords, "g1 in f32 over slots 1, 2");
};

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    fused_message_bwd_partials_kernel(
        const typename P::T* __restrict__ pre_self, const typename P::T* __restrict__ e_feat,
        const typename P::T* __restrict__ nbr_src, const int* __restrict__ e_idx,
        const float* __restrict__ mask, const typename P::T* __restrict__ w_e,
        const typename P::T* __restrict__ w2, const typename P::T* __restrict__ b2,
        const typename P::T* __restrict__ w3, const typename P::T* __restrict__ gdh,
        const typename P::T* __restrict__ gmsg, typename P::T* __restrict__ d_pre_self,
        typename P::T* __restrict__ d_e_feat, float* __restrict__ d_nbr_src,
        float* __restrict__ workspace, int num_nodes, int L, int K, int D, int Ce,
        int nodes_per_tile, int mask_mode, float scale) {
  using T = typename P::T;
  using S = PartialsSmem<P>;
  constexpr int kMT = kBwdRows / 16 / kWarpsM;
  constexpr int tp = kTP<T>;
  extern __shared__ uint4 smem_u4[];
  uint32_t* b_ring = reinterpret_cast<uint32_t*>(smem_u4);
  uint32_t* s0 = b_ring + kBwdStages * kStageWords;
  uint32_t* s1 = s0 + S::kSlotWords;
  uint32_t* s2 = s1 + S::kSlotWords;
  uint32_t* s3 = s2 + S::kSlotWords;
  uint32_t* dz2 = sizeof(T) == 4 ? s3 : s3 + S::kSlotWords;
  float* colsum = reinterpret_cast<float*>(s3 + S::kSlotWords + S::kDzWords);
  int* row_nbr = reinterpret_cast<int*>(colsum + kWarpsM * kMaxD);
  float* row_mask = reinterpret_cast<float*>(row_nbr + kBwdRows);
  int* row_self = reinterpret_cast<int*>(row_mask + kBwdRows);

  const Lane ln;
  const int num_tiles = (num_nodes + nodes_per_tile - 1) / nodes_per_tile;
  float* ws_we = workspace + (long long)blockIdx.x * ((long long)Ce * D + 2 * D * D + 2 * D);
  float* ws_w2 = ws_we + (long long)Ce * D;
  float* ws_b2 = ws_w2 + D * D;
  float* ws_w3 = ws_b2 + D;
  float* ws_b3 = ws_w3 + D * D;

  float acc[kMT][kNT][4];
  float dpre[kMT][kNT][4];
  float tacc[2][kNT][4];

  bool first = true;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, first = false) {
    const int node0 = tile * nodes_per_tile;
    const int nodes = min(nodes_per_tile, num_nodes - node0);
    const int rows = nodes * K;
    const long long e0 = (long long)node0 * K;

    __syncthreads();  // the previous tile is done with every slot and row_nbr / row_mask
    fill_rows(row_nbr, row_mask, row_self, kBwdRows, e_idx, mask, mask_mode, e0, node0, rows,
              K, L);
    __syncthreads();
    gather_rows<T>(s0, nbr_src, row_nbr, kBwdRows, D);
    cp_async_commit();

    zero(acc);
    product<P, kBwdRows, kBwdStages, false, true>(acc, nullptr, e_feat + e0 * Ce, Ce, rows, s2,
                                                  w_e, D, 0, D, Ce, b_ring, ln);
    for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
      float v0 = 0.f, v1 = 0.f, d0 = 0.f, d1 = 0.f;
      if (row < rows) {
        const float2 s = load_pair<T>(s0, tp, row, col);
        float2 et = make_float2(acc[mt][nt][2 * h] + s.x, acc[mt][nt][2 * h + 1] + s.y);
        if (mask_mode == kMaskPre) {
          et.x *= row_mask[row];
          et.y *= row_mask[row];
        }
        const float2 ps = load2(pre_self + (long long)row_self[row] * D + col);
        const float2 q0 = gelu_and_grad(et.x + ps.x), q1 = gelu_and_grad(et.y + ps.y);
        v0 = round_to<T>(q0.x);
        v1 = round_to<T>(q1.x);
        d0 = q0.y;
        d1 = q1.y;
      }
      store_pair<T>(s0, tp, row, col, v0, v1);
      dpre[mt][nt][2 * h] = d0;
      dpre[mt][nt][2 * h + 1] = d1;
    });

    zero(acc);
    product<P, kBwdRows, kBwdStages, false, false>(acc, s0, nullptr, 0, 0, nullptr, w2, D, 0, D,
                                                   D, b_ring, ln);
    for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
      float v0 = 0.f, v1 = 0.f, d0 = 0.f, d1 = 0.f;
      if (row < rows) {
        const float2 b = load2(b2 + col);
        const float2 q0 = gelu_and_grad(acc[mt][nt][2 * h] + b.x);
        const float2 q1 = gelu_and_grad(acc[mt][nt][2 * h + 1] + b.y);
        v0 = round_to<T>(q0.x);
        v1 = round_to<T>(q1.x);
        d0 = q0.y;
        d1 = q1.y;
      }
      store_pair<T>(s1, tp, row, col, v0, v1);
      store_pair<float>(dz2, kFP, row, col, d0, d1);
    });

    for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
      float g0 = 0.f, g1 = 0.f;
      if (row < rows) {
        if (gdh != nullptr) {
          const float2 g = load2(gdh + (long long)row_self[row] * D + col);
          g0 = g.x / scale;
          g1 = g.y / scale;
        }
        if (gmsg != nullptr) {
          const float2 g = load2(gmsg + (e0 + row) * D + col);
          g0 += g.x;
          g1 += g.y;
        }
        if (mask_mode == kMaskPost) {
          g0 *= row_mask[row];
          g1 *= row_mask[row];
        }
      }
      acc[mt][nt][2 * h] = g0;
      acc[mt][nt][2 * h + 1] = g1;
      store_pair<T>(s2, tp, row, col, round_to<T>(g0), round_to<T>(g1));
    });
    warp_colsum(acc, colsum, ln);
    store_colsum(ws_b3, colsum, D, !first);  // starts with a barrier: m2 and g3 are in place

    for (int ob = 0; ob < D; ob += kTnCols) {  // dW3 += round(m2)^T round(g3)
      zero(tacc);
      tn_accumulate<P, kBwdRows, tp, tp>(tacc, s1, ob, D - ob, s2, D, ln);
      store_tn(ws_w3, ob, D, D, !first, tacc, ln);
    }

    zero(acc);
    product<P, kBwdRows, kBwdStages, true, false>(acc, s2, nullptr, 0, 0, nullptr, w3, D, 0, D,
                                                  D, b_ring, ln);
    for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
      const float2 dz = load_pair<float>(dz2, kFP, row, col);
      const float g0 = acc[mt][nt][2 * h] * dz.x, g1 = acc[mt][nt][2 * h + 1] * dz.y;
      acc[mt][nt][2 * h] = g0;
      acc[mt][nt][2 * h + 1] = g1;
      store_pair<T>(s3, tp, row, col, round_to<T>(g0), round_to<T>(g1));  // over its gelu'(z2)
    });
    warp_colsum(acc, colsum, ln);
    store_colsum(ws_b2, colsum, D, !first);  // starts with a barrier: g2 is in place

    for (int ob = 0; ob < D; ob += kTnCols) {  // dW2 += round(m1)^T round(g2)
      zero(tacc);
      tn_accumulate<P, kBwdRows, tp, tp>(tacc, s0, ob, D - ob, s3, D, ln);
      store_tn(ws_w2, ob, D, D, !first, tacc, ln);
    }

    zero(acc);
    product<P, kBwdRows, kBwdStages, true, false>(acc, s3, nullptr, 0, 0, nullptr, w2, D, 0, D,
                                                  D, b_ring, ln);
    for_pairs<kMT>(D, ln, [&](int mt, int nt, int h, int row, int col) {
      const float g0 = acc[mt][nt][2 * h] * dpre[mt][nt][2 * h];
      const float g1 = acc[mt][nt][2 * h + 1] * dpre[mt][nt][2 * h + 1];
      store_pair<float>(s1, kFP, row, col, g0, g1);
      const float m = mask_mode == kMaskPre ? row_mask[row] : 1.f;
      const float e0v = round_to<T>(g0 * m), e1v = round_to<T>(g1 * m);
      store_pair<T>(s0, tp, row, col, e0v, e1v);
      const int nbr = row < rows ? row_nbr[row] : -1;
      if (nbr >= 0) {
        float* p = d_nbr_src + (long long)nbr * D + col;
        atomicAdd(p, e0v);
        atomicAdd(p + 1, e1v);
      }
    });
    __syncthreads();
    for (int idx = threadIdx.x; idx < nodes * D; idx += kThreads) {
      const int n = idx / D;
      const int col = idx - n * D;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += __uint_as_float(s1[(n * K + k) * kFP + col]);
      store1(d_pre_self + (long long)(node0 + n) * D + col, s);
    }

    for (int ce0 = 0; ce0 < Ce; ce0 += kMaxD) {
      const int nv = min(kMaxD, Ce - ce0);
      zero(acc);
      product<P, kBwdRows, kBwdStages, true, false>(acc, s0, nullptr, 0, 0, nullptr, w_e, D, ce0,
                                                    nv, D, b_ring, ln);
      for_pairs<kMT>(nv, ln, [&](int mt, int nt, int h, int row, int col) {
        if (row < rows)
          store2(d_e_feat + (e0 + row) * Ce + ce0 + col, acc[mt][nt][2 * h],
                 acc[mt][nt][2 * h + 1]);
      });
    }

    pipeline<kBwdStages>(  // dW_e += e_feat^T ge, e_feat streamed through s1..s3
        (Ce + kTnCols - 1) / kTnCols,
        [&](int j, int st) {
          copy_block<T, kXP<T>>(s1 + st * kBwdRows * kXP<T>, e_feat + e0 * Ce, Ce, kBwdRows,
                                rows, j * kTnCols, words_of<T>(kTnCols), Ce);
        },
        [&](int j, int st) {
          zero(tacc);
          tn_accumulate<P, kBwdRows, kXP<T>, tp>(tacc, s1 + st * kBwdRows * kXP<T>, 0,
                                                 min(kTnCols, Ce - j * kTnCols), s0, D, ln);
          store_tn(ws_we, j * kTnCols, Ce, D, !first, tacc, ln);
        });
  }
}

// out[i] = sum over the grid's blocks of workspace[block][i], in block order.
__global__ void sum_partials_kernel(const float* __restrict__ workspace, int blocks, int n,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += workspace[(long long)b * n + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <class P>
cudaError_t launch_fwd(const void* pre_self, const void* e_feat, const void* nbr_src,
                       const int* e_idx, const float* mask, const void* w_e, const void* w2,
                       const void* b2, const void* w3, const void* b3, void* dh, void* msg,
                       int num_nodes, int L, int K, int D, int Ce, int mask_mode, float scale,
                       cudaStream_t stream) {
  using T = typename P::T;
  cudaError_t err = cudaFuncSetAttribute(fused_message_fwd_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kFwdSmemBytes);
  if (err != cudaSuccess) return err;
  const int nodes_per_tile = kFwdRows / K;
  const int blocks = (num_nodes + nodes_per_tile - 1) / nodes_per_tile;
  fused_message_fwd_kernel<P><<<blocks, kThreads, kFwdSmemBytes, stream>>>(
      static_cast<const T*>(pre_self), static_cast<const T*>(e_feat),
      static_cast<const T*>(nbr_src), e_idx, mask, static_cast<const T*>(w_e),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(dh), static_cast<T*>(msg), num_nodes, L, K, D,
      Ce, nodes_per_tile, mask_mode, scale);
  return cudaGetLastError();
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// The backward's plan for these sizes: grid of the tile kernel (design a:
// persistent, as many blocks as fit at once), row ranges of the weight-
// gradient kernel (design b: enough blocks for two a SM), workspace bytes.
struct BwdPlan {
  int tiles, grid, ranges;
  size_t ops_bytes, partial_bytes, bias_bytes;
  size_t bytes() const { return ops_bytes + partial_bytes + bias_bytes; }
};

template <class P>
cudaError_t bwd_plan(int num_nodes, int K, int D, int Ce, BwdPlan* plan) {
  using T = typename P::T;
  const long long E = (long long)num_nodes * K;
  const long long n_wm = (long long)Ce * D + 2LL * D * D;
  const int nodes_per_tile = kBwdRows / K;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  plan->tiles = (num_nodes + nodes_per_tile - 1) / nodes_per_tile;
  if constexpr (kWgradInTile) {
    constexpr size_t smem = PartialsSmem<P>::kBytes;
    int per_sm = 0;
    if ((err = cudaFuncSetAttribute(fused_message_bwd_partials_kernel<P>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fused_message_bwd_partials_kernel<P>, kThreads, smem)) != cudaSuccess)
      return err;
    plan->grid = std::max(1, std::min(plan->tiles, sms * std::max(per_sm, 1)));
    plan->ranges = 0;
    plan->ops_bytes = plan->bias_bytes = 0;
    plan->partial_bytes = align256((size_t)plan->grid * (n_wm + 2 * D) * sizeof(float));
  } else {
    const int n_out = (Ce + kTnCols - 1) / kTnCols + 2 * ((D + kTnCols - 1) / kTnCols);
    const long long chunks = (E + kTnRows - 1) / kTnRows;
    plan->grid = plan->tiles;
    plan->ranges = (int)std::max(1LL, std::min(chunks, (long long)(2 * sms + n_out - 1) / n_out));
    plan->ops_bytes = align256((size_t)5 * E * D * sizeof(T));
    plan->partial_bytes = align256((size_t)plan->ranges * n_wm * sizeof(float));
    plan->bias_bytes = align256((size_t)plan->tiles * 2 * D * sizeof(float));
  }
  return cudaSuccess;
}

template <class P>
cudaError_t launch_bwd(const void* pre_self, const void* e_feat, const void* nbr_src,
                       const int* e_idx, const float* mask, const void* w_e, const void* w2,
                       const void* b2, const void* w3, const void* gdh, const void* gmsg,
                       void* d_pre_self, void* d_e_feat, float* d_nbr_src, float* d_weights,
                       char* workspace, long long workspace_bytes, int num_nodes, int L, int K,
                       int D, int Ce, int mask_mode, float scale, cudaStream_t stream) {
  using T = typename P::T;
  BwdPlan plan;
  cudaError_t err = bwd_plan<P>(num_nodes, K, D, Ce, &plan);
  if (err != cudaSuccess) return err;
  if ((long long)plan.bytes() > workspace_bytes) return cudaErrorInvalidValue;
  const int n_w = Ce * D + 2 * D * D + 2 * D;
  const int nodes_per_tile = kBwdRows / K;
  float* partial = reinterpret_cast<float*>(workspace + plan.ops_bytes);
  if constexpr (kWgradInTile) {
    fused_message_bwd_partials_kernel<P><<<plan.grid, kThreads, PartialsSmem<P>::kBytes,
                                           stream>>>(
        static_cast<const T*>(pre_self), static_cast<const T*>(e_feat),
        static_cast<const T*>(nbr_src), e_idx, mask, static_cast<const T*>(w_e),
        static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(w3),
        static_cast<const T*>(gdh), static_cast<const T*>(gmsg), static_cast<T*>(d_pre_self),
        static_cast<T*>(d_e_feat), d_nbr_src, partial, num_nodes, L, K, D, Ce, nodes_per_tile,
        mask_mode, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sum_partials_kernel<<<(n_w + 255) / 256, 256, 0, stream>>>(partial, plan.grid, n_w,
                                                              d_weights);
    return cudaGetLastError();
  } else {
    T* ops = reinterpret_cast<T*>(workspace);
    float* bias = reinterpret_cast<float*>(workspace + plan.ops_bytes + plan.partial_bytes);
    if ((err = cudaFuncSetAttribute(fused_message_bwd_kernel<P>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kBwdSmemBytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(fused_message_wgrad_kernel<P>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kTnSmemBytes<T>)) != cudaSuccess)
      return err;
    fused_message_bwd_kernel<P><<<plan.tiles, kThreads, kBwdSmemBytes, stream>>>(
        static_cast<const T*>(pre_self), static_cast<const T*>(e_feat),
        static_cast<const T*>(nbr_src), e_idx, mask, static_cast<const T*>(w_e),
        static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(w3),
        static_cast<const T*>(gdh), static_cast<const T*>(gmsg), static_cast<T*>(d_pre_self),
        static_cast<T*>(d_e_feat), d_nbr_src, ops, bias, num_nodes, L, K, D, Ce, nodes_per_tile,
        mask_mode, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int n_out = (Ce + kTnCols - 1) / kTnCols + 2 * ((D + kTnCols - 1) / kTnCols);
    fused_message_wgrad_kernel<P><<<n_out * plan.ranges, kThreads, kTnSmemBytes<T>, stream>>>(
        static_cast<const T*>(e_feat), ops, (long long)num_nodes * K, D, Ce, plan.ranges,
        partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sum_grads_kernel<<<(n_w - 2 * D + 255) / 256, 256, 0, stream>>>(partial, plan.ranges, Ce, D,
                                                                   d_weights);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sum_bias_kernel<<<2 * D, kThreads, 0, stream>>>(bias, plan.tiles, Ce, D, d_weights);
    return cudaGetLastError();
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The sizes the engine takes (the Python wrapper checks them first and
// names the cause): D a multiple of 16 up to 128, Ce a multiple of 8, K up
// to `rows`, at most 2^31 - 1 nodes and edges.
bool shapes_ok(int B, int L, int K, int D, int Ce, int rows) {
  return B >= 1 && L >= 1 && K >= 1 && K <= rows && D >= 16 && D <= kMaxD && D % 16 == 0 &&
         Ce >= 8 && Ce % 8 == 0 && (long long)B * L * K <= 0x7fffffffLL;
}

}  // namespace

// All tensors contiguous, on one device: pre_self, nbr_src [B, L, D];
// e_feat [B, L, K, Ce]; e_idx int32 and mask f32 [B, L, K] (mask may be null
// with mask_mode 0); w_e [Ce, D], w2 and w3 [D, D], b2 and b3 [D]; outputs
// dh [B, L, D] and msg [B, L, K, D], either may be null but not both. Float
// tensors are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), with 16-byte aligned
// base addresses. Launches on `stream`, allocates nothing and does not
// synchronise. Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int reed_fused_message_fwd(const void* pre_self, const void* e_feat,
                                      const void* nbr_src, const void* e_idx,
                                      const void* mask, const void* w_e, const void* w2,
                                      const void* b2, const void* w3, const void* b3,
                                      void* dh, void* msg, int is_bf16, int B, int L, int K,
                                      int D, int Ce, int mask_mode, float scale,
                                      void* stream) {
  const void* floats[] = {pre_self, e_feat, nbr_src, w_e, w2, b2, w3, b3, dh, msg};
  for (const void* p : floats)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (!shapes_ok(B, L, K, D, Ce, kFwdRows) || mask_mode < kMaskNone || mask_mode > kMaskPost ||
      (mask_mode != kMaskNone && mask == nullptr) || (dh == nullptr && msg == nullptr))
    return (int)cudaErrorInvalidValue;
  const int num_nodes = B * L;
  const int* idx = static_cast<const int*>(e_idx);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<Bf16>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3, b3, dh,
                                 msg, num_nodes, L, K, D, Ce, mask_mode, scale, st)
              : launch_fwd<Tf32x3>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3, b3, dh,
                                   msg, num_nodes, L, K, D, Ce, mask_mode, scale, st);
  return (int)err;
}

// Bytes of scratch the backward needs for these sizes: the wrapper
// allocates them. Returns a cudaError_t.
extern "C" int reed_fused_message_bwd_workspace(int is_bf16, int B, int L, int K, int D, int Ce,
                                                long long* bytes) {
  if (!shapes_ok(B, L, K, D, Ce, kBwdRows) || bytes == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdPlan plan;
  const cudaError_t err = is_bf16 ? bwd_plan<Bf16>(B * L, K, D, Ce, &plan)
                                  : bwd_plan<Tf32x3>(B * L, K, D, Ce, &plan);
  *bytes = (long long)plan.bytes();
  return (int)err;
}

// Inputs as reed_fused_message_fwd's, plus the cotangents gdh [B, L, D] and
// gmsg [B, L, K, D] in the input dtype (either may be null: a zero
// cotangent). Outputs: d_pre_self [B, L, D] and d_e_feat [B, L, K, Ce] in the
// input dtype; d_nbr_src f32 [B, L, D], zeroed by the caller (atomic adds);
// d_weights f32 [Ce*D + D*D + D + D*D + D] = dW_e, dW2, db2, dW3, db3 in that
// order, the same on every run. workspace: reed_fused_message_bwd_workspace
// bytes, 256-byte aligned, no initial value. Launches on `stream`, allocates
// nothing and does not synchronise. Returns a cudaError_t.
extern "C" int reed_fused_message_bwd(const void* pre_self, const void* e_feat,
                                      const void* nbr_src, const void* e_idx, const void* mask,
                                      const void* w_e, const void* w2, const void* b2,
                                      const void* w3, const void* gdh,
                                      const void* gmsg, void* d_pre_self, void* d_e_feat,
                                      void* d_nbr_src, void* d_weights, void* workspace,
                                      long long workspace_bytes, int is_bf16, int B, int L,
                                      int K, int D, int Ce, int mask_mode, float scale,
                                      void* stream) {
  const void* floats[] = {pre_self, e_feat, nbr_src, w_e, w2, b2, w3, gdh, gmsg,
                          d_pre_self, d_e_feat, d_nbr_src, d_weights};
  for (const void* p : floats)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (!shapes_ok(B, L, K, D, Ce, kBwdRows) || mask_mode < kMaskNone || mask_mode > kMaskPost ||
      (mask_mode != kMaskNone && mask == nullptr) || d_pre_self == nullptr ||
      d_e_feat == nullptr || d_nbr_src == nullptr || d_weights == nullptr ||
      workspace == nullptr || (reinterpret_cast<uintptr_t>(workspace) & 255) != 0)
    return (int)cudaErrorInvalidValue;
  const int num_nodes = B * L;
  const int* idx = static_cast<const int*>(e_idx);
  const float* m = static_cast<const float*>(mask);
  float* dns = static_cast<float*>(d_nbr_src);
  float* dw = static_cast<float*>(d_weights);
  char* ws = static_cast<char*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<Bf16>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3, gdh, gmsg,
                                 d_pre_self, d_e_feat, dns, dw, ws, workspace_bytes, num_nodes,
                                 L, K, D, Ce, mask_mode, scale, st)
              : launch_bwd<Tf32x3>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3, gdh,
                                   gmsg, d_pre_self, d_e_feat, dns, dw, ws, workspace_bytes,
                                   num_nodes, L, K, D, Ce, mask_mode, scale, st);
  return (int)err;
}

// Dynamic shared memory of one block of kernel `which` (0: forward, 1: the
// backward's tile kernel, 2: its weight-gradient kernel, absent in design a)
// for this dtype, how many such blocks fit on one SM, and its tile rows.
// Returns a cudaError_t.
extern "C" int reed_fused_message_info(int is_bf16, int which, int* smem_bytes,
                                       int* blocks_per_sm, int* tile_rows) {
  auto query = [&](auto kernel, size_t smem, int rows) {
    *smem_bytes = (int)smem;
    *tile_rows = rows;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
  };
  auto for_policy = [&](auto policy) {
    using P = decltype(policy);
    if (which == 0) return query(fused_message_fwd_kernel<P>, kFwdSmemBytes, kFwdRows);
    if constexpr (kWgradInTile) {
      if (which == 1)
        return query(fused_message_bwd_partials_kernel<P>, PartialsSmem<P>::kBytes, kBwdRows);
    } else {
      if (which == 1) return query(fused_message_bwd_kernel<P>, kBwdSmemBytes, kBwdRows);
      if (which == 2)
        return query(fused_message_wgrad_kernel<P>, kTnSmemBytes<typename P::T>, kTnRows);
    }
    return cudaErrorInvalidValue;
  };
  return (int)(is_bf16 ? for_policy(Bf16{}) : for_policy(Tf32x3{}));
}

extern "C" const char* reed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
