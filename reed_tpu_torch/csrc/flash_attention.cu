// Flash attention forward for Hopper (sm_90a), the port of the TPU kernel
// `_attn_kernel` in reed_tpu/ops/flash_attention.py.
//
// Computes o = softmax(q k^T * D^-1/2) v for every (batch, head), exact
// softmax over all keys, with f32 logits and f32 accumulation, and writes o
// once in the input dtype. q and o are [B, Sq, H, D] and k and v [B, Sk, H,
// D] views given by their strides (last dim contiguous), so the q/k/v
// slices of a fused qkv projection need no copy. The query length sizes the
// grid and the key length the key loop: Sq = Sk in self-attention, Sq = Sk /
// S on a rank of SiT's sequence parallelism, whose queries are its own
// tokens and whose keys are every rank's.
//
// bf16 (the model's dtype): both products run on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 accumulate). One block of 4 warps per
// (b*h, tile of 128 queries); each warp owns 32 query rows, two m16 tiles
// that share every K and V fragment it reads from shared memory (at
// D > 80 registers allow one without spills: 64 queries a block). The Q
// tile is read once into registers as A fragments (ldmatrix). K and V
// stream through a two-stage ring of 64-key tiles in shared memory, filled
// with 16-byte cp.async copies, so tile j+1 is in flight while tile j's
// products run.
// S = Q K^T reduces over D rounded up to 16 (72 -> 80; the pad is zeros in
// shared memory, never the neighbouring head's columns); P = 2^(scaled
// logits - running row max) (online softmax, max and sum in f32, ex2 on the
// special-function unit) goes from the S accumulators straight into
// registers as the bf16 A operand of O += P V, so P is rounded to bf16
// where it enters the PV product, as the TPU kernel rounds it
// (reed_tpu/ops/flash_attention.py:35); V is the B operand
// (ldmatrix.trans), N = D in tiles of 8. Rows of shared memory are padded
// to an odd number of 16-byte chunks, so the eight rows an ldmatrix reads
// fall in eight different bank groups. The output is divided by the f32 row
// sum once, staged through the warp's own Q rows and written with 16-byte
// stores; the ragged last query and key tiles are masked (zero-filled
// copies, -inf logits). Two blocks share an SM (246 registers a thread at
// D = 72). Measured on the H100 (tools/attention_variants.py, PERF.md):
// 128 queries a block beat 64, two m-tiles a warp beat one by 4-6 %,
// ex2.approx beat exp2f by 5-7 %, a third ring stage gained nothing.
//
// What bounds it: per (batch, head) attention does 4*S^2*D flops on 8*S*D
// bytes of bf16 q/k/v/o, S/2 flops per byte: 128 at SiT-XL/2's S = 256,
// below the H100's ~295 flops/byte ridge, so there the bound is the bytes
// (q, k, v read once, o written once); at S = 1024 it is the flops. What
// holds it back now is latency, not a rate: with 8 warps an SM, each
// warp's tile runs its products, its softmax (shuffles, ex2) and the
// block-wide barrier one after another, and too few warps cover the gaps.
// wgmma (asynchronous, per warpgroup) with warp-specialised TMA loads, so
// one warpgroup's softmax overlaps another's products, is the next step.
// Each block re-reads K and V of its (b, h) from L2, S/128 blocks per
// (b, h).
//
// f32: both products on the tensor cores as 3xTF32 (mma.sync.m16n8k8, TF32
// in, f32 accumulate). Each operand word x is split into hi = x rounded to
// TF32 (cvt.rna's rounding in two integer operations) and lo = x - hi, which
// the tensor core reads as TF32, and every product is lo.hi + hi.lo + hi.hi:
// f32 accuracy (one TF32 product keeps ~3 digits, too few for the f32
// tolerance), at a third of the TF32 rate. Q, K, P and V are all split.
// One block of 4 warps per (b*h, 64 queries); each warp owns one m16 tile
// whose Q hi/lo fragments stay in registers up to D = 96 and are re-read
// from shared memory above (ldmatrix on 32-bit words gives the TF32 A
// fragment). K and V stream through the same two-stage 64-key
// cp.async ring as bf16 (16-byte copies where D % 4 == 0 and every base
// and stride allows, 4-byte copies otherwise, so any D <= 128 is taken).
// S = Q K^T reduces over D rounded up to 8 (zeros in shared memory); the
// online softmax is bf16's, with p kept in f32. The S accumulator gives a
// thread keys 2t and 2t + 1 of each 8-key slice where the TF32 A fragment
// wants keys t and t + 4, so P V reads its keys in the permuted order
// (logical t -> key 2t, t + 4 -> key 2t + 1): P goes from the accumulators
// into the A operand with no shuffle, and V's B fragment is read from rows
// 2t and 2t + 1. Rows of shared memory are D rounded to 4 words, plus 4 if
// that is a multiple of 8: an odd number of 16-byte chunks, so K's ldmatrix
// rows and V's (2t, g) words are conflict-free.
// What bounds it: 3xTF32 runs at 495 / 3 = 165 TF/s, so attention at S =
// 256 (S/4 = 64 flops per f32 byte, above the 49 where 165 TF/s meets 3.35
// TB/s) is bound by operations, and more so at S = 1024. Measured on the
// H100 (tools/attention_variants.py, PERF.md): 28 % of that bound at
// SiT-XL/2's shape, 1.9x faster than SDPA; Q in registers ties Q re-read
// from shared memory, and a third block an SM gains nothing, so occupancy
// is not the limit; two m16 tiles a warp, which share each K and V
// fragment and its split, are 11 % faster at S >= 256 and slower on small
// grids: the instructions beside each mma (fragment loads, splits) are.
// 32-key tiles, 8 warps and a third ring stage are slower. The old
// CUDA-core kernel (f32 FMA, 32 queries a block, 4.8x slower) stays below
// as the compile-time variant kF32TensorCores = false.
//
// The bf16 kernel takes D % 8 == 0, D <= 128, 16-byte aligned base
// pointers and strides that are multiples of 8 elements; the f32 kernel any
// D <= 128. The Python wrapper checks both and raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxD = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements; the last dim has stride 1
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBlockN = 64;              // keys per shared-memory tile
constexpr int kStages = 2;               // K/V ring depth

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; subnormal results flush to 0, 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies rows [row0, row0 + kRows) of a [S, kD] view (row stride `ld`) into
// shared memory rows of pitch kPitch; rows at or past S are zero-filled.
template <int kRows, int kD, int kPitch>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int row0, int S, int tid) {
  constexpr int kChunks = kD / 8;
#pragma unroll 4
  for (int i = tid; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool in = row0 + r < S;
    const __nv_bfloat16* g = in ? src + (long long)(row0 + r) * ld + 8 * c : src;
    cp_async_16(dst + r * kPitch + 8 * c, g, in ? 16 : 0);
  }
}

template <int kD>
struct MmaShape {
  // 16-row m-tiles a warp owns: two share every K and V fragment a warp
  // reads from shared memory, where registers allow it
  static constexpr int kRowTiles = kD <= 80 ? 2 : 1;
  static constexpr int kBlockM = kMmaWarps * 16 * kRowTiles;  // queries per block
  static constexpr int kDPad = (kD + 15) / 16 * 16;  // reduction depth of Q K^T
  static constexpr int kKSteps = kDPad / 16;
  static constexpr int kNTiles = kD / 8;             // n8 tiles of P V
  // shared-memory row pitches (elements): an odd number of 16-byte chunks
  static constexpr int kPitchQK = ((kDPad / 8) | 1) * 8;
  static constexpr int kPitchV = ((kD / 8) | 1) * 8;
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) *
      ((size_t)(kBlockM + kStages * kBlockN) * kPitchQK + (size_t)kStages * kBlockN * kPitchV);
};

template <int kD>
__global__ void __launch_bounds__(kMmaThreads, 2)
    attention_fwd_bf16_mma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int Sq, int Sk, int H, Strides qs, Strides ks, Strides vs, Strides os,
                           float scale_log2) {
  using Shape = MmaShape<kD>;
  constexpr int kMT = Shape::kRowTiles;
  constexpr int kBlockM = Shape::kBlockM;
  constexpr int kKSteps = Shape::kKSteps;
  constexpr int kNTiles = Shape::kNTiles;
  constexpr int kPitchQK = Shape::kPitchQK;
  constexpr int kPitchV = Shape::kPitchV;

  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [kBlockM][kPitchQK]
  __nv_bfloat16* Ks = Qs + kBlockM * kPitchQK;              // [kStages][kBlockN][kPitchQK]
  __nv_bfloat16* Vs = Ks + kStages * kBlockN * kPitchQK;    // [kStages][kBlockN][kPitchV]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kBlockM;
  const int n_tiles = (Sk + kBlockN - 1) / kBlockN;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  load_tile<kBlockM, kD, kPitchQK>(Qs, qb, qs.s, q0, Sq, tid);
  cp_async_commit();
  load_tile<kBlockN, kD, kPitchQK>(Ks, kb, ks.s, 0, Sk, tid);
  load_tile<kBlockN, kD, kPitchV>(Vs, vb, vs.s, 0, Sk, tid);
  cp_async_commit();
  if constexpr (Shape::kDPad != kD) {
    // the reduction pad of Q and of every K stage: columns [kD, kD + 8)
    for (int r = tid; r < kBlockM + kStages * kBlockN; r += kMmaThreads)
      *reinterpret_cast<uint4*>(Qs + r * kPitchQK + kD) = make_uint4(0, 0, 0, 0);
  }

  // the warp's rows: kMT m-tiles of 16 from row warp * 16 * kMT of the block
  __nv_bfloat16* Qw = Qs + warp * 16 * kMT * kPitchQK;
  cp_async_wait<1>();  // the Q tile
  __syncthreads();
  uint32_t qf[kMT][kKSteps][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const __nv_bfloat16* row = Qw + (16 * mt + (lane & 15)) * kPitchQK + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(qf[mt][kk], row + 16 * kk);
  }

  // This thread holds rows g = lane / 4 and g + 8 of each m-tile: index 0
  // of each pair below is row g, index 1 row g + 8.
  float acc[kMT][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int t = 0; t < kNTiles; ++t)
      acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;
  float m_run[kMT][2], l_run[kMT][2];  // running max (log2 domain); this thread's row sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -CUDART_INF_F;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    if (j + 1 < n_tiles) {
      const int next = (j + 1) % kStages;
      load_tile<kBlockN, kD, kPitchQK>(Ks + next * kBlockN * kPitchQK, kb, ks.s,
                                       (j + 1) * kBlockN, Sk, tid);
      load_tile<kBlockN, kD, kPitchV>(Vs + next * kBlockN * kPitchV, vb, vs.s,
                                      (j + 1) * kBlockN, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();  // tile j has landed, tile j + 1 may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s = Q K^T for the warp's rows and the tile's 64 keys (8 n8 tiles)
    float s[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int t = 0; t < 8; ++t) s[mt][t][0] = s[mt][t][1] = s[mt][t][2] = s[mt][t][3] = 0.f;
    {
      const __nv_bfloat16* kt = Ks + stage * kBlockN * kPitchQK +
                                ((lane & 7) + ((lane >> 4) << 3)) * kPitchQK +
                                ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4];  // b0, b1 of key tiles 2 jp and 2 jp + 1
          ldmatrix_x4(bf, kt + 16 * jp * kPitchQK + 16 * kk);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(s[mt][2 * jp], qf[mt][kk], bf[0], bf[1]);
            mma_bf16(s[mt][2 * jp + 1], qf[mt][kk], bf[2], bf[3]);
          }
        }
      }
    }

    const int k0 = j * kBlockN;
    if (k0 + kBlockN > Sk) {  // the ragged last tile
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int key = k0 + 8 * t + 2 * (lane & 3);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (key >= Sk) s[mt][t][0] = s[mt][t][2] = -CUDART_INF_F;
          if (key + 1 >= Sk) s[mt][t][1] = s[mt][t][3] = -CUDART_INF_F;
        }
      }
    }

    // online softmax; p replaces s
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[mt][t][2 * r], s[mt][t][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][r], mx * scale_log2);  // finite: a tile holds a key
        const float alpha = fast_exp2(m_run[mt][r] - m_new);
        m_run[mt][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float p0 = fast_exp2(fmaf(s[mt][t][2 * r], scale_log2, -m_new));
          const float p1 = fast_exp2(fmaf(s[mt][t][2 * r + 1], scale_log2, -m_new));
          s[mt][t][2 * r] = p0;
          s[mt][t][2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l_run[mt][r] = l_run[mt][r] * alpha + sum;
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
          acc[mt][t][2 * r] *= alpha;
          acc[mt][t][2 * r + 1] *= alpha;
        }
      }
    }

    // acc += P V: P (bf16) from registers as A, V from shared memory as B
    {
      const __nv_bfloat16* vt = Vs + stage * kBlockN * kPitchV + (lane & 15) * kPitchV;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
        const __nv_bfloat16* vrow = vt + 16 * kk * kPitchV;
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          uint32_t bf[4];  // b0, b1 of dim tiles 2 np and 2 np + 1
          ldmatrix_x4_trans(bf, vrow + 8 * (2 * np + (lane >> 4)));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], pa[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], pa[mt], bf[2], bf[3]);
          }
        }
        if constexpr (kNTiles % 2 == 1) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + 8 * (kNTiles - 1));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][kNTiles - 1], pa[mt], b0, b1);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copies
  }

  // epilogue: divide by the row sums, stage the warp's rows in its own Q
  // rows (no other warp reads them), then 16-byte stores
  const int g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / l;
    }
    __nv_bfloat16* ow = Qw + 16 * mt * kPitchQK;
#pragma unroll
    for (int t = 0; t < kNTiles; ++t) {
      const int col = 8 * t + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(ow + g * kPitchQK + col) =
          __floats2bfloat162_rn(acc[mt][t][0] * inv[0], acc[mt][t][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * kPitchQK + col) =
          __floats2bfloat162_rn(acc[mt][t][2] * inv[1], acc[mt][t][3] * inv[1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = kD / 8;
  for (int i = lane; i < 16 * kMT * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int row = q0 + warp * 16 * kMT + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)row * os.s + 8 * c) =
          *reinterpret_cast<const uint4*>(Qw + r * kPitchQK + 8 * c);
  }
}

template <int kD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                        cudaStream_t stream) {
  using Shape = MmaShape<kD>;
  constexpr size_t smem = Shape::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_bf16_mma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + Shape::kBlockM - 1) / Shape::kBlockM));
  attention_fwd_bf16_mma<kD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, qs, ks,
      vs, os, scale * kLog2e);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool strides8(Strides st) { return st.b % 8 == 0 && st.s % 8 == 0 && st.h % 8 == 0; }

// Calls f(std::integral_constant<int, D>) for D = 8, 16, ..., 128.
template <typename F>
cudaError_t with_head_dim(int D, F&& f) {
  if (D % 8 != 0) return cudaErrorInvalidValue;
  switch (D / 8) {
#define REED_CASE(n) \
  case n:            \
    return f(std::integral_constant<int, 8 * n>{});
    REED_CASE(1) REED_CASE(2) REED_CASE(3) REED_CASE(4) REED_CASE(5) REED_CASE(6)
    REED_CASE(7) REED_CASE(8) REED_CASE(9) REED_CASE(10) REED_CASE(11) REED_CASE(12)
    REED_CASE(13) REED_CASE(14) REED_CASE(15) REED_CASE(16)
#undef REED_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                          int Sk, int H, int D, Strides qs, Strides ks, Strides vs, Strides os,
                          float scale, cudaStream_t st) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) || !strides8(qs) ||
      !strides8(ks) || !strides8(vs) || !strides8(os))
    return cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    return launch_bf16<decltype(d)::value>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, os, scale, st);
  });
}

// ---------------------------------------------------------------------------
// f32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr bool kF32TensorCores = true;  // false: the CUDA-core kernel further down
constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32RowTiles = 1;    // m16 tiles a warp
constexpr bool kF32QInRegs = true; // Q's hi/lo fragments held, not re-read each k-step
constexpr int kF32BlockN = 64;     // keys per shared-memory tile
constexpr int kF32Stages = 2;      // K/V ring depth
constexpr int kF32MinBlocks = 2;   // blocks per SM the register budget is cut for

// 4-byte global -> shared copy; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// d += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), d 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32, in two full-rate integer operations where cvt is a
// quarter-rate conversion), lo = x - hi is exact in f32 and the tensor core
// reads it as TF32 by dropping its low 13 bits. The same split as
// csrc/fused_message.cu's Tf32x3::split.
__device__ __forceinline__ void split_tf32(uint32_t w, uint32_t& hi, uint32_t& lo) {
  hi = (w + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(w) - __uint_as_float(hi));
}

// pass 0: lo.hi, 1: hi.lo, 2: hi.hi (the small terms first); callers run
// one pass over all their tiles before the next, so no mma waits on the last
__device__ __forceinline__ void mma_3xtf32(int pass, float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (pass == 0) mma_tf32(d, al, bh[0], bh[1]);
  if (pass == 1) mma_tf32(d, ah, bl[0], bl[1]);
  if (pass == 2) mma_tf32(d, ah, bh[0], bh[1]);
}

// Copies rows [row0, row0 + kRows) of a [S, D] f32 view (row stride `ld`)
// into shared memory rows of pitch kPitch, columns [0, kDP); rows at or past
// S and columns at or past D are zero-filled. vec: 16-byte copies (D % 4 ==
// 0, 16-byte aligned base and row stride), else 4-byte copies.
template <int kRows, int kDP, int kPitch>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long ld,
                                              int row0, int S, int D, bool vec, int tid) {
  if (vec) {
    constexpr int kChunks = kDP / 4;
#pragma unroll 4
    for (int i = tid; i < kRows * kChunks; i += kF32Threads) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const bool in = row0 + r < S && 4 * c < D;
      cp_async_16(dst + r * kPitch + 4 * c, in ? src + (long long)(row0 + r) * ld + 4 * c : src,
                  in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kRows * kDP; i += kF32Threads) {
      const int r = i / kDP;
      const int c = i - r * kDP;
      const bool in = row0 + r < S && c < D;
      cp_async_4(dst + r * kPitch + c, in ? src + (long long)(row0 + r) * ld + c : src,
                 in ? 4 : 0);
    }
  }
}

template <int kDP>
struct F32Shape {
  static constexpr int kBlockM = kF32Warps * 16 * kF32RowTiles;  // queries per block
  // Q's fragments take 2 * kDP registers: above D = 96 they would spill
  static constexpr bool kQInRegs = kF32QInRegs && kDP <= 96;
  // row pitch (words): D rounded to 4, an odd number of 16-byte chunks
  static constexpr int kPitch = ((kDP / 4) | 1) * 4;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (size_t)(kBlockM + 2 * kF32Stages * kF32BlockN) * kPitch;
};

// kDP: D rounded up to 8, the reduction depth of Q K^T and the width of P V
template <int kDP>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
    attention_fwd_f32_mma(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
                          int D, bool vec, Strides qs, Strides ks, Strides vs, Strides os,
                          float scale_log2) {
  using Shape = F32Shape<kDP>;
  constexpr int kMT = kF32RowTiles;
  constexpr int kBlockM = Shape::kBlockM;
  constexpr int kP = Shape::kPitch;
  constexpr int kDSteps = kDP / 8;       // k8 steps of Q K^T, n8 tiles of P V
  constexpr int kKeySteps = kF32BlockN / 8;  // n8 tiles of Q K^T, k8 steps of P V

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [kBlockM][kP]
  float* Ks = Qs + kBlockM * kP;                  // [kF32Stages][kF32BlockN][kP]
  float* Vs = Ks + kF32Stages * kF32BlockN * kP;  // [kF32Stages][kF32BlockN][kP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kBlockM;
  const int n_tiles = (Sk + kF32BlockN - 1) / kF32BlockN;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  // one commit group for Q, then one per ring stage but the last
  load_rows_f32<kBlockM, kDP, kP>(Qs, qb, qs.s, q0, Sq, D, vec, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kF32Stages - 1; ++st) {
    if (st < n_tiles) {
      load_rows_f32<kF32BlockN, kDP, kP>(Ks + st * kF32BlockN * kP, kb, ks.s, st * kF32BlockN,
                                         Sk, D, vec, tid);
      load_rows_f32<kF32BlockN, kDP, kP>(Vs + st * kF32BlockN * kP, vb, vs.s, st * kF32BlockN,
                                         Sk, D, vec, tid);
    }
    cp_async_commit();
  }

  // the warp's rows: kMT m-tiles of 16 from row warp * 16 * kMT of the block
  const float* Qw = Qs + warp * 16 * kMT * kP;
  // ldmatrix row addresses of an A fragment (rows g, g + 8; words t, t + 4)
  const float* qrow = Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * kP + (lane >> 4) * 4;
  constexpr bool kQInRegs = Shape::kQInRegs;
  uint32_t qh_all[kQInRegs ? kMT : 1][kQInRegs ? kDSteps : 1][4];
  uint32_t ql_all[kQInRegs ? kMT : 1][kQInRegs ? kDSteps : 1][4];
  if constexpr (kQInRegs) {
    cp_async_wait<kF32Stages - 1>();  // the Q tile
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        uint32_t w[4];
        ldmatrix_x4(w, qrow + 16 * mt * kP + 8 * kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(w[i], qh_all[mt][kk][i], ql_all[mt][kk][i]);
      }
  }

  // This thread holds rows g and g + 8 of each m-tile: index 0 of each pair
  // below is row g, index 1 row g + 8.
  float acc[kMT][kDSteps][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kDSteps; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  float m_run[kMT][2], l_run[kMT][2];  // running max (log2 domain); this thread's row sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -CUDART_INF_F;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kF32Stages;
    const int ahead = j + kF32Stages - 1;  // the tile whose copies start now
    if (ahead < n_tiles) {
      const int st = ahead % kF32Stages;  // the stage tile j - 1 used
      load_rows_f32<kF32BlockN, kDP, kP>(Ks + st * kF32BlockN * kP, kb, ks.s,
                                         ahead * kF32BlockN, Sk, D, vec, tid);
      load_rows_f32<kF32BlockN, kDP, kP>(Vs + st * kF32BlockN * kP, vb, vs.s,
                                         ahead * kF32BlockN, Sk, D, vec, tid);
    }
    cp_async_commit();                // possibly empty: the group count stays fixed
    cp_async_wait<kF32Stages - 1>();  // tile j (and Q) have landed
    __syncthreads();
    const float* Kt = Ks + stage * kF32BlockN * kP;
    const float* Vt = Vs + stage * kF32BlockN * kP;

    // s = Q K^T for the warp's rows and the tile's keys (n8 tiles)
    float s[kMT][kKeySteps][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kKeySteps; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    {
      // ldmatrix row addresses of B fragments of two key tiles: keys g
      // (+ 8), words t, t + 4
      const float* krow = Kt + ((lane & 7) + (lane >> 4) * 8) * kP + ((lane >> 3) & 1) * 4;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        uint32_t qh[kMT][4], ql[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if constexpr (kQInRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              qh[mt][i] = qh_all[mt][kk][i];
              ql[mt][i] = ql_all[mt][kk][i];
            }
          } else {
            uint32_t w[4];
            ldmatrix_x4(w, qrow + 16 * mt * kP + 8 * kk);
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(w[i], qh[mt][i], ql[mt][i]);
          }
        }
        uint32_t kh[kKeySteps][2], kl[kKeySteps][2];
#pragma unroll
        for (int np = 0; np < kKeySteps / 2; ++np) {
          uint32_t w[4];  // b0, b1 of key tiles 2 np and 2 np + 1
          ldmatrix_x4(w, krow + 16 * np * kP + 8 * kk);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(w[i], kh[2 * np + i / 2][i % 2], kl[2 * np + i / 2][i % 2]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int n = 0; n < kKeySteps; ++n)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma_3xtf32(pass, s[mt][n], qh[mt], ql[mt], kh[n], kl[n]);
      }
    }

    const int k0 = j * kF32BlockN;
    if (k0 + kF32BlockN > Sk) {  // the ragged last tile
#pragma unroll
      for (int n = 0; n < kKeySteps; ++n) {
        const int key = k0 + 8 * n + 2 * t;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (key >= Sk) s[mt][n][0] = s[mt][n][2] = -CUDART_INF_F;
          if (key + 1 >= Sk) s[mt][n][1] = s[mt][n][3] = -CUDART_INF_F;
        }
      }
    }

    // online softmax; p (f32) replaces s
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < kKeySteps; ++n) mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][r], mx * scale_log2);  // finite: a tile holds a key
        const float alpha = fast_exp2(m_run[mt][r] - m_new);
        m_run[mt][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kKeySteps; ++n) {
          const float p0 = fast_exp2(fmaf(s[mt][n][2 * r], scale_log2, -m_new));
          const float p1 = fast_exp2(fmaf(s[mt][n][2 * r + 1], scale_log2, -m_new));
          s[mt][n][2 * r] = p0;
          s[mt][n][2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l_run[mt][r] = l_run[mt][r] * alpha + sum;
#pragma unroll
        for (int n = 0; n < kDSteps; ++n) {
          acc[mt][n][2 * r] *= alpha;
          acc[mt][n][2 * r + 1] *= alpha;
        }
      }
    }

    // acc += P V over the tile's 8-key slices, keys in the permuted order:
    // A fragment word (row, t) is key 2t and (row, t + 4) key 2t + 1, which
    // is where the S accumulator left them; V's B fragment reads the same
    // keys, rows 2t and 2t + 1, column g of each n8 tile of dims
    {
      const float* vrow = Vt + 2 * t * kP + g;
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
        uint32_t ph[kMT][4], pl[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          split_tf32(__float_as_uint(s[mt][kk][0]), ph[mt][0], pl[mt][0]);  // (g, 2t)
          split_tf32(__float_as_uint(s[mt][kk][2]), ph[mt][1], pl[mt][1]);  // (g + 8, 2t)
          split_tf32(__float_as_uint(s[mt][kk][1]), ph[mt][2], pl[mt][2]);  // (g, 2t + 1)
          split_tf32(__float_as_uint(s[mt][kk][3]), ph[mt][3], pl[mt][3]);  // (g + 8, 2t + 1)
        }
        uint32_t vh[kDSteps][2], vl[kDSteps][2];
#pragma unroll
        for (int n = 0; n < kDSteps; ++n) {
          const float* p = vrow + 8 * kk * kP + 8 * n;
          split_tf32(__float_as_uint(p[0]), vh[n][0], vl[n][0]);
          split_tf32(__float_as_uint(p[kP]), vh[n][1], vl[n][1]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int n = 0; n < kDSteps; ++n)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma_3xtf32(pass, acc[mt][n], ph[mt], pl[mt], vh[n], vl[n]);
      }
    }
    __syncthreads();  // this stage is refilled by a later iteration's copies
  }

  // epilogue: divide by the row sums and store rows g and g + 8 of each
  // m-tile; columns 2t, 2t + 1 of each n8 tile below D
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = q0 + warp * 16 * kMT + 16 * mt + g + 8 * r;
      if (row >= Sq) continue;
      float* orow = ob + (long long)row * os.s;
#pragma unroll
      for (int n = 0; n < kDSteps; ++n) {
        const int col = 8 * n + 2 * t;
        const float x0 = acc[mt][n][2 * r] * inv, x1 = acc[mt][n][2 * r + 1] * inv;
        if (vec) {  // D % 4 == 0: both columns or neither
          if (col < D) *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        } else {
          if (col < D) orow[col] = x0;
          if (col + 1 < D) orow[col + 1] = x1;
        }
      }
    }
  }
}

template <int kDP>
cudaError_t launch_f32_mma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                           int Sk, int H, int D, bool vec, Strides qs, Strides ks, Strides vs,
                           Strides os, float scale, cudaStream_t stream) {
  using Shape = F32Shape<kDP>;
  constexpr size_t smem = Shape::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_f32_mma<kDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + Shape::kBlockM - 1) / Shape::kBlockM));
  attention_fwd_f32_mma<kDP><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, D, vec, qs, ks, vs, os, scale * kLog2e);
  return cudaGetLastError();
}

bool strides4(Strides st) { return st.b % 4 == 0 && st.s % 4 == 0 && st.h % 4 == 0; }

// ---------------------------------------------------------------------------
// f32: CUDA cores (the first kernel; the variant kF32TensorCores = false)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 32 queries per block
constexpr int kBlockK = 64;                     // keys per shared-memory tile
constexpr int kKeysPerLane = kBlockK / 32;
constexpr int kDimsPerLane = kMaxD / 32;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// For the logits each lane owns kKeysPerLane keys of the tile; for the
// output each lane owns the dims lane, lane+32, lane+64, lane+96 of every row
// it holds. Shared memory: Qs [kBlockQ][ld], Ks and Vs [kBlockK][ld],
// Ps [kWarps * kRowsPerWarp][kBlockK]. ld is D rounded up to 4, plus 4 when
// that is a multiple of 8, so that the float4 reads of eight lanes on eight
// different key rows fall in eight different bank groups.
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                      int H, int D, int ld, Strides qs, Strides ks, Strides vs, Strides os,
                      float scale_log2) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockQ * ld;
  float* Vs = Ks + kBlockK * ld;
  float* Ps = Vs + kBlockK * ld;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int ld4 = ld / 4;
  const int d4_end = (D + 3) / 4;
  const int dims = (D + 31) / 32;  // output dims a lane holds, warp-uniform

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  // Q tile, pre-scaled by D^-1/2 * log2(e) so the softmax runs on exp2.
  for (int idx = tid; idx < kBlockQ * ld; idx += blockDim.x) {
    const int r = idx / ld;
    const int d = idx - r * ld;
    float val = 0.f;
    if (q0 + r < Sq && d < D) val = qb[(q0 + r) * qs.s + d] * scale_log2;
    Qs[idx] = val;
  }

  float m[kRowsPerWarp];        // running max of each row (log2 domain)
  float l[kRowsPerWarp];        // this lane's part of each row's running sum
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  const float4* Q4 = reinterpret_cast<const float4*>(Qs) + warp * kRowsPerWarp * ld4;
  const float4* K4 = reinterpret_cast<const float4*>(Ks);
  float* Pw = Ps + warp * kRowsPerWarp * kBlockK;

  for (int k0 = 0; k0 < Sk; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBlockK * ld; idx += blockDim.x) {
      const int r = idx / ld;
      const int d = idx - r * ld;
      float kval = 0.f, vval = 0.f;
      if (k0 + r < Sk && d < D) {
        kval = kb[(k0 + r) * ks.s + d];
        vval = vb[(k0 + r) * vs.s + d];
      }
      Ks[idx] = kval;
      Vs[idx] = vval;
    }
    __syncthreads();

    // Logits: lane owns keys lane + 32 * c of the tile.
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[r][c] = 0.f;
    for (int d4 = 0; d4 < d4_end; ++d4) {
      float4 kv[kKeysPerLane];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) kv[c] = K4[(lane + 32 * c) * ld4 + d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = Q4[r * ld4 + d4];  // same address in every lane
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) s[r][c] = dot4(qv, kv[c], s[r][c]);
      }
    }

    // Online softmax: rescale what was accumulated to the new running max.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        if (k0 + lane + 32 * c >= Sk) s[r][c] = -CUDART_INF_F;
        tile_max = fmaxf(tile_max, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(tile_max));  // finite: a tile holds a key
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const float p = exp2f(s[r][c] - m_new);
        l[r] += p;
        Pw[r * kBlockK + lane + 32 * c] = p;
      }
    }
    __syncwarp();

    // acc += P V over the tile, four keys at a time.
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][kDimsPerLane];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int d = lane + 32 * i;
          vv[jj][i] = (i < dims && d < D) ? Vs[(j + jj) * ld + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Pw + r * kBlockK + j);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          if (i < dims) {
            float a = acc[r][i];
            a = fmaf(p.x, vv[0][i], a);
            a = fmaf(p.y, vv[1][i], a);
            a = fmaf(p.z, vv[2][i], a);
            acc[r][i] = fmaf(p.w, vv[3][i], a);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    const float inv = 1.f / warp_sum(l[r]);
    if (row < Sq) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (i < dims && d < D) ob[row * os.s + d] = acc[r][i] * inv;
      }
    }
  }
}

int f32_pitch(int D) {
  const int dp = (D + 3) / 4 * 4;
  return dp % 8 == 0 ? dp + 4 : dp;
}

size_t f32_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)(kBlockQ + 2 * kBlockK) * f32_pitch(D) + (size_t)kBlockQ * kBlockK);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                       int H, int D, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, cudaStream_t stream) {
  if ((Sq + kBlockQ - 1) / kBlockQ > 65535) return cudaErrorInvalidValue;
  const int ld = f32_pitch(D);
  const size_t smem = f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBlockQ - 1) / kBlockQ));
  attention_fwd_f32<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, D, ld, qs, ks, vs, os,
      scale * kLog2e);
  return cudaGetLastError();
}

// 16-byte copies need D % 4 == 0 and every base and stride 16-byte aligned
bool f32_vec(const void* q, const void* k, const void* v, const void* o, int D, Strides qs,
             Strides ks, Strides vs, Strides os) {
  return D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
         strides4(qs) && strides4(ks) && strides4(vs) && strides4(os);
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Sk, int H, int D, Strides qs, Strides ks, Strides vs, Strides os,
                         float scale, cudaStream_t st) {
  if (!kF32TensorCores) return launch_f32(q, k, v, o, B, Sq, Sk, H, D, qs, ks, vs, os, scale, st);
  const bool vec = f32_vec(q, k, v, o, D, qs, ks, vs, os);
  return with_head_dim((D + 7) / 8 * 8, [&](auto d) {
    return launch_f32_mma<decltype(d)::value>(q, k, v, o, B, Sq, Sk, H, D, vec, qs, ks, vs, os,
                                              scale, st);
  });
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise. Returns
// a cudaError_t: 0 when the launch was accepted.
extern "C" int reed_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B, int Sq, int Sk,
    int H, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || D < 1 || D > kMaxD ||
      (long long)B * H > 0x7fffffffLL || (Sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_bf16(q, k, v, o, B, Sq, Sk, H, D, qs, ks, vs, os, scale, st)
              : dispatch_f32(q, k, v, o, B, Sq, Sk, H, D, qs, ks, vs, os, scale, st);
  return (int)err;
}

// The dynamic shared memory of one block of the kernel that takes this dtype
// and head dim, and how many such blocks fit on one SM.
extern "C" int reed_flash_attention_info(int is_bf16, int D, int* smem_bytes,
                                         int* blocks_per_sm) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (!is_bf16 && kF32TensorCores) {
    return (int)with_head_dim((D + 7) / 8 * 8, [&](auto d) {
      constexpr int kDP = decltype(d)::value;
      *smem_bytes = (int)F32Shape<kDP>::kSmemBytes;
      cudaError_t err = cudaFuncSetAttribute(
          attention_fwd_f32_mma<kDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
      if (err != cudaSuccess) return err;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, attention_fwd_f32_mma<kDP>, kF32Threads, *smem_bytes);
    });
  }
  if (!is_bf16) {
    *smem_bytes = (int)f32_smem_bytes(D);
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_fwd_f32, kWarps * 32, *smem_bytes);
  }
  return (int)with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    *smem_bytes = (int)MmaShape<kD>::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_bf16_mma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_fwd_bf16_mma<kD>, kMmaThreads, *smem_bytes);
  });
}

extern "C" const char* reed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
