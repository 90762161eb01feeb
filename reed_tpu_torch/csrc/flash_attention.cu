// Flash attention forward for Hopper (sm_90a), the port of the TPU kernel
// `_attn_kernel` in reed_tpu/ops/flash_attention.py.
//
// Computes o = softmax(q k^T * D^-1/2) v for every (batch, head), exact
// softmax over all keys, with f32 logits and f32 accumulation, and writes o
// once in the input dtype. q, k, v and o are [B, S, H, D] views given by
// their strides (last dim contiguous), so the q/k/v slices of a fused qkv
// projection need no copy.
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
// f32: the first version's kernel on the CUDA cores (f32 FMA, no TF32), one
// block of 4 warps per (b*h, 32 queries), K and V through shared memory in
// 64-key tiles.
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
                           int S, int H, Strides qs, Strides ks, Strides vs, Strides os,
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
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  load_tile<kBlockM, kD, kPitchQK>(Qs, qb, qs.s, q0, S, tid);
  cp_async_commit();
  load_tile<kBlockN, kD, kPitchQK>(Ks, kb, ks.s, 0, S, tid);
  load_tile<kBlockN, kD, kPitchV>(Vs, vb, vs.s, 0, S, tid);
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
                                       (j + 1) * kBlockN, S, tid);
      load_tile<kBlockN, kD, kPitchV>(Vs + next * kBlockN * kPitchV, vb, vs.s,
                                      (j + 1) * kBlockN, S, tid);
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
    if (k0 + kBlockN > S) {  // the ragged last tile
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int key = k0 + 8 * t + 2 * (lane & 3);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (key >= S) s[mt][t][0] = s[mt][t][2] = -CUDART_INF_F;
          if (key + 1 >= S) s[mt][t][1] = s[mt][t][3] = -CUDART_INF_F;
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
    if (row < S)
      *reinterpret_cast<uint4*>(ob + (long long)row * os.s + 8 * c) =
          *reinterpret_cast<const uint4*>(Qw + r * kPitchQK + 8 * c);
  }
}

template <int kD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                        cudaStream_t stream) {
  using Shape = MmaShape<kD>;
  constexpr size_t smem = Shape::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_bf16_mma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + Shape::kBlockM - 1) / Shape::kBlockM));
  attention_fwd_bf16_mma<kD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, qs, ks, vs,
      os, scale * kLog2e);
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

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                          int H, int D, Strides qs, Strides ks, Strides vs, Strides os,
                          float scale, cudaStream_t st) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) || !strides8(qs) ||
      !strides8(ks) || !strides8(vs) || !strides8(os))
    return cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    return launch_bf16<decltype(d)::value>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  });
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
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
                      const float* __restrict__ v, float* __restrict__ o, int S, int H, int D,
                      int ld, Strides qs, Strides ks, Strides vs, Strides os,
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
    if (q0 + r < S && d < D) val = qb[(q0 + r) * qs.s + d] * scale_log2;
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

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBlockK * ld; idx += blockDim.x) {
      const int r = idx / ld;
      const int d = idx - r * ld;
      float kval = 0.f, vval = 0.f;
      if (k0 + r < S && d < D) {
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
        if (k0 + lane + 32 * c >= S) s[r][c] = -CUDART_INF_F;
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
    if (row < S) {
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

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int H, int D, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, cudaStream_t stream) {
  if ((S + kBlockQ - 1) / kBlockQ > 65535) return cudaErrorInvalidValue;
  const int ld = f32_pitch(D);
  const size_t smem = f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockQ - 1) / kBlockQ));
  attention_fwd_f32<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, D, ld, qs, ks, vs, os,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise. Returns
// a cudaError_t: 0 when the launch was accepted.
extern "C" int reed_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B, int S,
    int H, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > kMaxD ||
      (long long)B * H > 0x7fffffffLL || (S + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_bf16(q, k, v, o, B, S, H, D, qs, ks, vs, os, scale, st)
              : launch_f32(q, k, v, o, B, S, H, D, qs, ks, vs, os, scale, st);
  return (int)err;
}

// The dynamic shared memory of one block of the kernel that takes this dtype
// and head dim, and how many such blocks fit on one SM.
extern "C" int reed_flash_attention_info(int is_bf16, int D, int* smem_bytes,
                                         int* blocks_per_sm) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
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
