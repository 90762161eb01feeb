// Flash attention forward for Hopper (sm_90a), the port of the TPU kernel
// `_attn_kernel` in reed_tpu/ops/flash_attention.py.
//
// Computes o = softmax(q k^T * D^-1/2) v for every (batch, head), exact
// softmax over all keys, with f32 logits and f32 accumulation, and writes o
// once in the input dtype (f32 or bf16). q, k, v and o are [B, S, H, D]
// views given by their strides (last dim contiguous), so the q/k/v slices
// of a fused qkv projection need no copy.
//
// What bounds it on this card: per (batch, head) attention does 4*S^2*D
// flops on 8*S*D bytes of bf16 q/k/v/o, S/2 flops per byte: 128 at
// SiT-XL/2's S = 256, below the H100's ~295 flops/byte ridge, so its bound
// there is the bytes (q, k, v read once, o written once); at S = 1024 it is
// the flops. The Pallas kernel keeps all of K and V for one (b, h)
// resident in VMEM; a block here gets at most 227 KB of shared memory (K and
// V at S = 1024, D = 72, f32 alone are 590 KB), so K and V stream through
// shared memory in tiles of kBlockK keys with an online softmax (running max
// and sum in f32). No padding of D to 128 lanes and no S % 128 rule: the
// ragged last tile is masked. This first version runs on the CUDA cores in
// f32; tensor cores (wgmma) and TMA are left for a later version.
//
// Layout of the work: one block of kWarps warps per (b*h, tile of kBlockQ
// queries); each warp owns kRowsPerWarp query rows. For the logits each lane
// owns kKeysPerLane keys of the tile; for the output each lane owns the
// dims lane, lane+32, lane+64, lane+96 of every row it holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 32 queries per block
constexpr int kBlockK = 64;                     // keys per shared-memory tile
constexpr int kKeysPerLane = kBlockK / 32;
constexpr int kMaxD = 128;
constexpr int kDimsPerLane = kMaxD / 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements; the last dim has stride 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// Shared memory, all f32: Qs [kBlockQ][ld], Ks and Vs [kBlockK][ld],
// Ps [kWarps * kRowsPerWarp][kBlockK]. ld is D rounded up to 4, plus 4 when
// that is a multiple of 8, so that the float4 reads of eight lanes on eight
// different key rows fall in eight different bank groups.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int S, int H,
                         int D, int ld, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale_log2) {
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  // Q tile, pre-scaled by D^-1/2 * log2(e) so the softmax runs on exp2.
  for (int idx = tid; idx < kBlockQ * ld; idx += blockDim.x) {
    const int r = idx / ld;
    const int d = idx - r * ld;
    float val = 0.f;
    if (q0 + r < S && d < D) val = to_float(qb[(q0 + r) * qs.s + d]) * scale_log2;
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
        kval = to_float(kb[(k0 + r) * ks.s + d]);
        vval = to_float(vb[(k0 + r) * vs.s + d]);
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
        if (i < dims && d < D) ob[row * os.s + d] = from_float<T>(acc[r][i] * inv);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int D, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, cudaStream_t stream) {
  const int dp = (D + 3) / 4 * 4;
  const int ld = dp % 8 == 0 ? dp + 4 : dp;
  const size_t smem = sizeof(float) *
                      ((size_t)(kBlockQ + 2 * kBlockK) * ld + (size_t)kBlockQ * kBlockK);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBlockQ - 1) / kBlockQ));
  attention_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, D, ld, qs, ks, vs, os, scale * kLog2e);
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
      (long long)B * H > 0x7fffffffLL || (S + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, S, H, D, qs, ks, vs, os, scale, st)
              : launch<float>(q, k, v, o, B, S, H, D, qs, ks, vs, os, scale, st);
  return (int)err;
}

extern "C" const char* reed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
