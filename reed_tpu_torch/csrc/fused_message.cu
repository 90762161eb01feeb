// Fused k-NN message MLP forward for Hopper (sm_90a), the port of the TPU
// kernel `_fwd_kernel` in reed_tpu/ops/fused_message.py.
//
// For every node i (flattened over batch and length) and neighbour slot k:
//   et  = e_feat[i,k] . W_e + nbr_src[b, e_idx[i,k]]   (times mask[i,k] in mode pre)
//   m1  = gelu(et + pre_self[i])
//   m2  = gelu(m1 . W2 + b2)
//   msg = m2 . W3 + b3                                 (times mask[i,k] in mode post)
// and writes dh[i] = sum_k msg[i,k] / scale and/or msg, as asked. GELU is the
// erf form in f32 (erff). Products accumulate in f32; with bf16 inputs their
// operands are bf16 values (m1 and m2 are rounded to bf16 before their
// product, as the TPU kernel's .astype(cdt) does); f32 inputs stay full f32.
// Outputs are written in the input dtype.
//
// What bounds it on this card: per edge the three products are
// 2*(Ce*D + 2*D*D) flops on ~(Ce + D)*bytes of input and output, so at
// ProteinMPNN's D = 128, Ce = 128/256 the f32 chain is bound by operations
// (67 TFLOP/s without tensor cores) and the bf16 one by bytes or operations
// depending on the outputs asked for (PERF.md has the table). This first
// version runs all three products on the CUDA cores in f32.
//
// What does not carry over from the TPU: the Pallas kernel holds all of
// nbr_src[b] in VMEM and gathers it with a one-hot matmul; here the gather
// is an indexed row load from global memory (L2). The weights (Ce*D + 2*D*D
// values: 256 KB in f32 at Ce = 256) do not fit a block's shared memory
// beside the activations, so each product streams its weight through shared
// memory in chunks of kChunk input rows. Every block reads all weights once
// (from L2): that and the CUDA-core products are what hold it back; tensor
// cores (wgmma), TMA and larger node tiles are later work.
//
// Layout of the work: one block of 8 warps per tile of kMaxRows / K whole
// nodes (2 nodes, 60 edge rows at K = 30), so the K-sum is reduced inside
// the block with no atomics. Warp w owns edge rows 8w..8w+7 of the tile and
// lane l owns output columns 4l..4l+3, so D <= 128. The activations of a
// stage stay in shared memory (Act) as the next product's left operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // edge rows per block
constexpr int kMaxD = 128;                       // 32 lanes x 4 columns
constexpr int kChunk = 32;                       // weight rows per shared-memory chunk
constexpr float kInvSqrt2 = 0.70710678118654752f;

enum MaskMode { kMaskNone = 0, kMaskPre = 1, kMaskPost = 2 };

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

// x rounded to T and back: the operand rounding of a product's left side
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * kInvSqrt2));
}

__device__ __forceinline__ void fma4(float* acc, float s, float4 w) {
  acc[0] = fmaf(s, w.x, acc[0]);
  acc[1] = fmaf(s, w.y, acc[1]);
  acc[2] = fmaf(s, w.z, acc[2]);
  acc[3] = fmaf(s, w.w, acc[3]);
}

// Ws[c][d] = w[(c0 + c) * D + d] for c < kChunk, d < kMaxD; zero outside
// [Cin, D), so padded rows and columns add nothing.
template <typename T>
__device__ __forceinline__ void load_weight_chunk(float* Ws, const T* __restrict__ w,
                                                  int c0, int Cin, int D) {
  for (int idx = threadIdx.x; idx < kChunk * kMaxD; idx += kThreads) {
    const int c = idx / kMaxD;
    const int d = idx - c * kMaxD;
    Ws[idx] = (c0 + c < Cin && d < D) ? to_float(w[(long long)(c0 + c) * D + d]) : 0.f;
  }
}

// acc[i][j] += sum_{c < kChunk} A[row_i][c] * Ws[c][col_j] for this thread's
// rows (warp * 8 + i) and columns (4 * lane + j). A rows are read as float4
// at one address per warp (a broadcast); Ws rows as consecutive float4s.
__device__ __forceinline__ void accumulate(const float* A, int lda, const float* Ws,
                                           int warp, int lane,
                                           float (&acc)[kRowsPerWarp][4]) {
  const float4* W4 = reinterpret_cast<const float4*>(Ws) + lane;
#pragma unroll 2
  for (int c = 0; c < kChunk; c += 4) {
    float4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = W4[(c + j) * (kMaxD / 4)];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (warp * kRowsPerWarp + i) * lda + c);
      fma4(acc[i], a.x, w[0]);
      fma4(acc[i], a.y, w[1]);
      fma4(acc[i], a.z, w[2]);
      fma4(acc[i], a.w, w[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRowsPerWarp][4]) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc += Act[:, :Cin] . w over the tile, with w streamed in chunks.
template <typename T>
__device__ __forceinline__ void product_from_act(const float* Act, float* Ws,
                                                 const T* __restrict__ w, int Cin, int D,
                                                 int warp, int lane,
                                                 float (&acc)[kRowsPerWarp][4]) {
  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    __syncthreads();  // the previous chunk (and, first, Act's writers) are done
    load_weight_chunk(Ws, w, c0, Cin, D);
    __syncthreads();
    accumulate(Act + c0, kMaxD, Ws, warp, lane, acc);
  }
}

// Shared memory (dynamic, 16-byte aligned): Ws [kChunk][kMaxD],
// As [kMaxRows][kChunk], Act [kMaxRows][kMaxD] f32, then row_nbr [kMaxRows]
// int (row of nbr_src, -1 for none) and row_mask [kMaxRows] f32.
constexpr size_t kSmemBytes =
    sizeof(float) * (kChunk * kMaxD + kMaxRows * kChunk + kMaxRows * kMaxD) +
    kMaxRows * (sizeof(int) + sizeof(float));

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_message_fwd_kernel(const T* __restrict__ pre_self, const T* __restrict__ e_feat,
                             const T* __restrict__ nbr_src, const int* __restrict__ e_idx,
                             const float* __restrict__ mask, const T* __restrict__ w_e,
                             const T* __restrict__ w2, const T* __restrict__ b2,
                             const T* __restrict__ w3, const T* __restrict__ b3,
                             T* __restrict__ dh, T* __restrict__ msg, int num_nodes, int L,
                             int K, int D, int Ce, int nodes_per_block, int mask_mode,
                             float scale) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* As = Ws + kChunk * kMaxD;
  float* Act = As + kMaxRows * kChunk;
  int* row_nbr = reinterpret_cast<int*>(Act + kMaxRows * kMaxD);
  float* row_mask = reinterpret_cast<float*>(row_nbr + kMaxRows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int node0 = blockIdx.x * nodes_per_block;
  const int nodes = min(nodes_per_block, num_nodes - node0);
  const int rows = nodes * K;              // valid edge rows, a prefix of the tile
  const long long e0 = (long long)node0 * K;  // first edge of the tile

  for (int r = tid; r < kMaxRows; r += kThreads) {
    int nbr = -1;
    float m = 0.f;
    if (r < rows) {
      const int j = e_idx[e0 + r];
      const int b = (node0 + r / K) / L;
      // an index outside [0, L) selects nothing, as the one-hot gather does
      nbr = (j >= 0 && j < L) ? b * L + j : -1;
      m = mask_mode == kMaskNone ? 1.f : mask[e0 + r];
    }
    row_nbr[r] = nbr;
    row_mask[r] = m;
  }

  float acc[kRowsPerWarp][4];

  // Stage 1: e_feat . W_e, both operands streamed in chunks of Ce.
  zero(acc);
  for (int c0 = 0; c0 < Ce; c0 += kChunk) {
    __syncthreads();
    for (int idx = tid; idx < kMaxRows * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int c = idx - r * kChunk;
      As[idx] = (r < rows && c0 + c < Ce) ? to_float(e_feat[(e0 + r) * Ce + c0 + c]) : 0.f;
    }
    load_weight_chunk(Ws, w_e, c0, Ce, D);
    __syncthreads();
    accumulate(As, kChunk, Ws, warp, lane, acc);
  }
  // m1 = gelu(et + pre_self) into Act (Act is not read in stage 1)
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * lane + j;
      float v = 0.f;
      if (r < rows && col < D) {
        const int nbr = row_nbr[r];
        float et = acc[i][j] + (nbr >= 0 ? to_float(nbr_src[(long long)nbr * D + col]) : 0.f);
        if (mask_mode == kMaskPre) et *= row_mask[r];
        const float pre = et + to_float(pre_self[(long long)(node0 + r / K) * D + col]);
        v = round_to<T>(gelu(pre));
      }
      Act[r * kMaxD + col] = v;
    }
  }

  // Stage 2: m2 = gelu(m1 . W2 + b2)
  zero(acc);
  product_from_act(Act, Ws, w2, D, D, warp, lane, acc);
  __syncthreads();  // every read of m1 is done before m2 overwrites it
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * lane + j;
      float v = 0.f;
      if (r < rows && col < D) v = round_to<T>(gelu(acc[i][j] + to_float(b2[col])));
      Act[r * kMaxD + col] = v;
    }
  }

  // Stage 3: msg = m2 . W3 + b3
  zero(acc);
  product_from_act(Act, Ws, w3, D, D, warp, lane, acc);
  __syncthreads();  // every read of m2 is done before msg overwrites it
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * lane + j;
      float v = 0.f;
      if (r < rows && col < D) {
        v = acc[i][j] + to_float(b3[col]);
        if (mask_mode == kMaskPost) v *= row_mask[r];
        if (msg != nullptr) msg[(e0 + r) * D + col] = from_float<T>(v);
      }
      Act[r * kMaxD + col] = v;
    }
  }
  if (dh == nullptr) return;

  // dh = sum over each node's K rows / scale, summed in slot order in f32
  __syncthreads();
  for (int idx = tid; idx < nodes * D; idx += kThreads) {
    const int n = idx / D;
    const int col = idx - n * D;
    const float* a = Act + n * K * kMaxD + col;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += a[k * kMaxD];
    dh[(long long)(node0 + n) * D + col] = from_float<T>(s / scale);
  }
}

template <typename T>
cudaError_t launch(const void* pre_self, const void* e_feat, const void* nbr_src,
                   const int* e_idx, const float* mask, const void* w_e, const void* w2,
                   const void* b2, const void* w3, const void* b3, void* dh, void* msg,
                   int num_nodes, int L, int K, int D, int Ce, int mask_mode, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_message_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const int nodes_per_block = kMaxRows / K;
  const int blocks = (num_nodes + nodes_per_block - 1) / nodes_per_block;
  fused_message_fwd_kernel<T><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(pre_self), static_cast<const T*>(e_feat),
      static_cast<const T*>(nbr_src), e_idx, mask, static_cast<const T*>(w_e),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(dh), static_cast<T*>(msg), num_nodes, L,
      K, D, Ce, nodes_per_block, mask_mode, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (K2b), the port of the TPU kernel `_bwd_kernel` in
// reed_tpu/ops/fused_message.py. Per tile of edge rows it recomputes pre, m1,
// z2 and m2 as the forward does, then
//   g3 = (gdh / scale broadcast over K + gmsg)        (times mask in mode post)
//   g2 = g3 . W3^T * gelu'(z2)
//   g1 = g2 . W2^T * gelu'(pre)
//   d pre_self = sum_k g1;  ge = g1                  (times mask in mode pre)
//   d e_feat = ge . W_e^T;  d nbr_src[e_idx] += ge
//   dW_e = e_feat^T ge, dW2 = m1^T g2, db2 = sum g2, dW3 = m2^T g3, db3 = sum g3
// with the TPU kernel's bf16 rounding points: g3, g2, ge, m1 and m2 are
// rounded to the input dtype where they enter a product; db2, db3 and
// d pre_self sum the f32 values.
//
// What does not carry over: the TPU grid runs in order, so the Pallas
// kernel accumulates d nbr_src over a batch's L-tiles and the weight
// gradients over the whole grid in its outputs. Here blocks run in no order:
//   - d nbr_src is an atomicAdd into a zeroed f32 [B*L, D] buffer (the order
//     of the adds, so the last bits, vary from run to run);
//   - the grid is persistent (about one block per SM); each block walks its
//     tiles and keeps a private f32 partial of dW_e, dW2, db2, dW3, db3 in
//     its slice of a [grid, Ce*D + 2*D*D + 2*D] workspace, and a second
//     kernel sums the slices in block order, so the weight gradients are the
//     same on every run.
//
// What bounds it: 2*E*(3*Ce*D + 5*D*D) flops (two recomputed products, five
// backward ones) on the CUDA cores in f32, against ~(Ce + 2*D) values read
// and Ce values written per edge: bound by operations in f32. Four [64, 128]
// f32 tiles stay in shared memory (m1, m2, g3, g2, then g1 over m2's), with
// the weight chunk and an e_feat chunk: 160 KB, one block per SM; gelu'(pre)
// and gelu'(z2) stay in registers, in the same row/column ownership as the
// product accumulators.

__device__ __forceinline__ float dgelu(float x) {
  constexpr float kInvSqrt2Pi = 0.39894228040143268f;
  return 0.5f * (1.f + erff(x * kInvSqrt2)) + x * kInvSqrt2Pi * expf(-0.5f * x * x);
}

// Ws[k][c] = w[(row0 + c) * ldw + k0 + k] for k < kChunk, c < kMaxD: a chunk
// of w^T, zero outside k0 + k < kdim and row0 + c < nrows. Consecutive
// threads take consecutive c, so the shared-memory stores do not conflict.
template <typename T>
__device__ __forceinline__ void load_weight_chunk_t(float* Ws, const T* __restrict__ w,
                                                    int k0, int kdim, int row0, int nrows,
                                                    int ldw) {
  for (int idx = threadIdx.x; idx < kChunk * kMaxD; idx += kThreads) {
    const int k = idx / kMaxD;
    const int c = idx - k * kMaxD;
    Ws[idx] = (k0 + k < kdim && row0 + c < nrows)
                  ? to_float(w[(long long)(row0 + c) * ldw + k0 + k])
                  : 0.f;
  }
}

// acc += Act[:, :Cin] . w^T chunk by chunk, w [nrows, ldw] read transposed
// (output column c is w's row row0 + c).
template <typename T>
__device__ __forceinline__ void product_t_from_act(const float* Act, float* Ws,
                                                   const T* __restrict__ w, int Cin, int row0,
                                                   int nrows, int ldw, int warp, int lane,
                                                   float (&acc)[kRowsPerWarp][4]) {
  for (int k0 = 0; k0 < Cin; k0 += kChunk) {
    __syncthreads();
    load_weight_chunk_t(Ws, w, k0, Cin, row0, nrows, ldw);
    __syncthreads();
    accumulate(Act + k0, kMaxD, Ws, warp, lane, acc);
  }
}

// acc[i][j] += sum_{r < kMaxRows} A[r * lda + orow0 + 8 * warp + i] * Bm[r * kMaxD + 4 * lane + j]:
// a tile's share of a weight gradient A^T B, output rows orow0 + 8 * warp + i.
__device__ __forceinline__ void accumulate_tn(const float* A, int lda, int orow0,
                                              const float* Bm, int warp, int lane,
                                              float (&acc)[kRowsPerWarp][4]) {
  const float* a_col = A + orow0 + warp * kRowsPerWarp;
  const float4* B4 = reinterpret_cast<const float4*>(Bm) + lane;
#pragma unroll 4
  for (int r = 0; r < kMaxRows; ++r) {
    const float4 b = B4[r * (kMaxD / 4)];
    const float4 a0 = *reinterpret_cast<const float4*>(a_col + r * lda);
    const float4 a1 = *reinterpret_cast<const float4*>(a_col + r * lda + 4);
    fma4(acc[0], a0.x, b);
    fma4(acc[1], a0.y, b);
    fma4(acc[2], a0.z, b);
    fma4(acc[3], a0.w, b);
    fma4(acc[4], a1.x, b);
    fma4(acc[5], a1.y, b);
    fma4(acc[6], a1.z, b);
    fma4(acc[7], a1.w, b);
  }
}

// The block's partial ws[row][col] (row stride D) = (first ? 0 : ws) + acc,
// for rows orow0 + 8 * warp + i < nrows and columns 4 * lane + j < D.
__device__ __forceinline__ void add_partial(float* ws, int orow0, int nrows, int D, bool first,
                                            int warp, int lane,
                                            const float (&acc)[kRowsPerWarp][4]) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = orow0 + warp * kRowsPerWarp + i;
    if (row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * lane + j;
      if (col >= D) continue;
      float* p = ws + (long long)row * D + col;
      *p = first ? acc[i][j] : *p + acc[i][j];
    }
  }
}

// ws[c] = (first ? 0 : ws[c]) + sum_{r < rows} Buf[r][c] for c < D, then
// Buf rounded in place to T (the operand rounding of the products it feeds).
template <typename T>
__device__ __forceinline__ void bias_partial_and_round(float* Buf, float* ws, int rows, int D,
                                                       bool first) {
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += Buf[r * kMaxD + c];
    ws[c] = first ? s : ws[c] + s;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kMaxRows * kMaxD; idx += kThreads)
    Buf[idx] = round_to<T>(Buf[idx]);
}

// Shared memory (dynamic): Ws [kChunk][kMaxD], As [kMaxRows][2 * kChunk],
// four [kMaxRows][kMaxD] f32 tiles, row_nbr [kMaxRows] int, row_mask
// [kMaxRows] f32.
constexpr int kEfChunk = 2 * kChunk;  // e_feat columns per dW_e pass (64 output rows)
constexpr size_t kBwdSmemBytes =
    sizeof(float) * (kChunk * kMaxD + kMaxRows * kEfChunk + 4 * kMaxRows * kMaxD) +
    kMaxRows * (sizeof(int) + sizeof(float));

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_message_bwd_kernel(const T* __restrict__ pre_self, const T* __restrict__ e_feat,
                             const T* __restrict__ nbr_src, const int* __restrict__ e_idx,
                             const float* __restrict__ mask, const T* __restrict__ w_e,
                             const T* __restrict__ w2, const T* __restrict__ b2,
                             const T* __restrict__ w3, const T* __restrict__ gdh,
                             const T* __restrict__ gmsg,
                             T* __restrict__ d_pre_self, T* __restrict__ d_e_feat,
                             float* __restrict__ d_nbr_src, float* __restrict__ workspace,
                             int num_nodes, int L, int K, int D, int Ce, int nodes_per_block,
                             int mask_mode, float scale) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* As = Ws + kChunk * kMaxD;
  float* M1 = As + kMaxRows * kEfChunk;   // round(m1)
  float* M2 = M1 + kMaxRows * kMaxD;      // round(m2); later g1, then ge
  float* G3 = M2 + kMaxRows * kMaxD;
  float* G2 = G3 + kMaxRows * kMaxD;
  int* row_nbr = reinterpret_cast<int*>(G2 + kMaxRows * kMaxD);
  float* row_mask = reinterpret_cast<float*>(row_nbr + kMaxRows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_tiles = (num_nodes + nodes_per_block - 1) / nodes_per_block;
  // this block's partial weight gradients
  float* ws = workspace + (long long)blockIdx.x * ((long long)Ce * D + 2 * D * D + 2 * D);
  float* ws_we = ws;
  float* ws_w2 = ws_we + (long long)Ce * D;
  float* ws_b2 = ws_w2 + D * D;
  float* ws_w3 = ws_b2 + D;
  float* ws_b3 = ws_w3 + D * D;

  float acc[kRowsPerWarp][4];
  float dpre[kRowsPerWarp][4];  // gelu'(pre) of this thread's elements
  float dz2[kRowsPerWarp][4];   // gelu'(z2)

  bool first = true;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, first = false) {
    const int node0 = tile * nodes_per_block;
    const int nodes = min(nodes_per_block, num_nodes - node0);
    const int rows = nodes * K;
    const long long e0 = (long long)node0 * K;

    __syncthreads();  // the previous tile's readers of row_nbr / row_mask are done
    for (int r = tid; r < kMaxRows; r += kThreads) {
      int nbr = -1;
      float m = 0.f;
      if (r < rows) {
        const int j = e_idx[e0 + r];
        const int b = (node0 + r / K) / L;
        nbr = (j >= 0 && j < L) ? b * L + j : -1;
        m = mask_mode == kMaskNone ? 1.f : mask[e0 + r];
      }
      row_nbr[r] = nbr;
      row_mask[r] = m;
    }

    // Recompute 1: pre = (e_feat . W_e + nbr_src[e_idx]) (* mask) + pre_self
    zero(acc);
    for (int c0 = 0; c0 < Ce; c0 += kChunk) {
      __syncthreads();
      for (int idx = tid; idx < kMaxRows * kChunk; idx += kThreads) {
        const int r = idx / kChunk;
        const int c = idx - r * kChunk;
        As[idx] = (r < rows && c0 + c < Ce) ? to_float(e_feat[(e0 + r) * Ce + c0 + c]) : 0.f;
      }
      load_weight_chunk(Ws, w_e, c0, Ce, D);
      __syncthreads();
      accumulate(As, kChunk, Ws, warp, lane, acc);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * lane + j;
        float v = 0.f, dp = 0.f;
        if (r < rows && col < D) {
          const int nbr = row_nbr[r];
          float et = acc[i][j] + (nbr >= 0 ? to_float(nbr_src[(long long)nbr * D + col]) : 0.f);
          if (mask_mode == kMaskPre) et *= row_mask[r];
          const float pre = et + to_float(pre_self[(long long)(node0 + r / K) * D + col]);
          v = round_to<T>(gelu(pre));
          dp = dgelu(pre);
        }
        M1[r * kMaxD + col] = v;
        dpre[i][j] = dp;
      }
    }

    // Recompute 2: z2 = m1 . W2 + b2, m2 = gelu(z2)
    zero(acc);
    product_from_act(M1, Ws, w2, D, D, warp, lane, acc);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * lane + j;
        float v = 0.f, dz = 0.f;
        if (r < rows && col < D) {
          const float z2 = acc[i][j] + to_float(b2[col]);
          v = round_to<T>(gelu(z2));
          dz = dgelu(z2);
        }
        M2[r * kMaxD + col] = v;
        dz2[i][j] = dz;
      }
    }

    // g3 = (gdh / scale + gmsg) (* mask in mode post), f32
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * lane + j;
        float g = 0.f;
        if (r < rows && col < D) {
          if (gdh != nullptr) g = to_float(gdh[(long long)(node0 + r / K) * D + col]) / scale;
          if (gmsg != nullptr) g += to_float(gmsg[(e0 + r) * D + col]);
          if (mask_mode == kMaskPost) g *= row_mask[r];
        }
        G3[r * kMaxD + col] = g;
      }
    }
    bias_partial_and_round<T>(G3, ws_b3, rows, D, first);  // db3 = sum g3; g3 -> round(g3)

    // g2 = round(g3) . W3^T * gelu'(z2)
    zero(acc);
    product_t_from_act(G3, Ws, w3, D, 0, D, D, warp, lane, acc);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) G2[r * kMaxD + 4 * lane + j] = acc[i][j] * dz2[i][j];
    }
    bias_partial_and_round<T>(G2, ws_b2, rows, D, first);  // db2 = sum g2; g2 -> round(g2)
    __syncthreads();

    // dW3 += round(m2)^T round(g3), dW2 += round(m1)^T round(g2)
    for (int orow0 = 0; orow0 < D; orow0 += kWarps * kRowsPerWarp) {
      zero(acc);
      accumulate_tn(M2, kMaxD, orow0, G3, warp, lane, acc);
      add_partial(ws_w3, orow0, D, D, first, warp, lane, acc);
      zero(acc);
      accumulate_tn(M1, kMaxD, orow0, G2, warp, lane, acc);
      add_partial(ws_w2, orow0, D, D, first, warp, lane, acc);
    }

    // g1 = round(g2) . W2^T * gelu'(pre), into M2 (m2 and g3 are done)
    zero(acc);
    product_t_from_act(G2, Ws, w2, D, 0, D, D, warp, lane, acc);
    float* GE = M2;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) GE[r * kMaxD + 4 * lane + j] = acc[i][j] * dpre[i][j];
    }
    __syncthreads();
    // d pre_self = sum over each node's K rows of the unmasked g1, in slot order
    for (int idx = tid; idx < nodes * D; idx += kThreads) {
      const int n = idx / D;
      const int col = idx - n * D;
      const float* a = GE + n * K * kMaxD + col;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += a[k * kMaxD];
      d_pre_self[(long long)(node0 + n) * D + col] = from_float<T>(s);
    }
    __syncthreads();
    // ge = round(g1 (* mask in mode pre))
    for (int idx = tid; idx < kMaxRows * kMaxD; idx += kThreads) {
      const int r = idx / kMaxD;
      const float m = mask_mode == kMaskPre ? row_mask[r] : 1.f;
      GE[idx] = round_to<T>(GE[idx] * m);
    }
    __syncthreads();

    // d nbr_src[b, e_idx] += ge (an index outside [0, L) adds nothing)
    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int r = idx / D;
      const int col = idx - r * D;
      const int nbr = row_nbr[r];
      if (nbr >= 0) atomicAdd(d_nbr_src + (long long)nbr * D + col, GE[r * kMaxD + col]);
    }

    // d e_feat = ge . W_e^T, 128 output columns at a time
    for (int ce0 = 0; ce0 < Ce; ce0 += kMaxD) {
      zero(acc);
      product_t_from_act(GE, Ws, w_e, D, ce0, Ce, D, warp, lane, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ce0 + 4 * lane + j;
          if (c < Ce) d_e_feat[(e0 + r) * Ce + c] = from_float<T>(acc[i][j]);
        }
      }
    }

    // dW_e += e_feat^T ge, kEfChunk rows of dW_e at a time
    for (int c0 = 0; c0 < Ce; c0 += kEfChunk) {
      __syncthreads();
      for (int idx = tid; idx < kMaxRows * kEfChunk; idx += kThreads) {
        const int r = idx / kEfChunk;
        const int c = idx - r * kEfChunk;
        As[idx] = (r < rows && c0 + c < Ce) ? to_float(e_feat[(e0 + r) * Ce + c0 + c]) : 0.f;
      }
      __syncthreads();
      zero(acc);
      accumulate_tn(As, kEfChunk, 0, GE, warp, lane, acc);
      add_partial(ws_we + (long long)c0 * D, 0, min(kEfChunk, Ce - c0), D, first, warp, lane,
                  acc);
    }
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

template <typename T>
cudaError_t bwd_grid(int num_nodes, int K, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(fused_message_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kBwdSmemBytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_message_bwd_kernel<T>, kThreads, kBwdSmemBytes)) != cudaSuccess)
    return err;
  const int nodes_per_block = kMaxRows / K;
  const int tiles = (num_nodes + nodes_per_block - 1) / nodes_per_block;
  *blocks = max(1, min(tiles, sms * max(per_sm, 1)));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const void* pre_self, const void* e_feat, const void* nbr_src,
                       const int* e_idx, const float* mask, const void* w_e, const void* w2,
                       const void* b2, const void* w3, const void* gdh,
                       const void* gmsg, void* d_pre_self, void* d_e_feat, float* d_nbr_src,
                       float* d_weights, float* workspace, int blocks, int num_nodes, int L,
                       int K, int D, int Ce, int mask_mode, float scale,
                       cudaStream_t stream) {
  int want = 0;
  cudaError_t err = bwd_grid<T>(num_nodes, K, &want);
  if (err != cudaSuccess) return err;
  if (blocks != want) return cudaErrorInvalidValue;  // the workspace was sized for `want`
  const int nodes_per_block = kMaxRows / K;
  fused_message_bwd_kernel<T><<<blocks, kThreads, kBwdSmemBytes, stream>>>(
      static_cast<const T*>(pre_self), static_cast<const T*>(e_feat),
      static_cast<const T*>(nbr_src), e_idx, mask, static_cast<const T*>(w_e),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(gdh), static_cast<const T*>(gmsg),
      static_cast<T*>(d_pre_self), static_cast<T*>(d_e_feat), d_nbr_src, workspace, num_nodes,
      L, K, D, Ce, nodes_per_block, mask_mode, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = Ce * D + 2 * D * D + 2 * D;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(workspace, blocks, n, d_weights);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous, on one device: pre_self, nbr_src [B, L, D];
// e_feat [B, L, K, Ce]; e_idx int32 and mask f32 [B, L, K] (mask may be null
// with mask_mode 0); w_e [Ce, D], w2 and w3 [D, D], b2 and b3 [D]; outputs
// dh [B, L, D] and msg [B, L, K, D], either may be null but not both. Float
// tensors are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Launches on `stream`,
// allocates nothing and does not synchronise. Returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int reed_fused_message_fwd(const void* pre_self, const void* e_feat,
                                      const void* nbr_src, const void* e_idx,
                                      const void* mask, const void* w_e, const void* w2,
                                      const void* b2, const void* w3, const void* b3,
                                      void* dh, void* msg, int is_bf16, int B, int L, int K,
                                      int D, int Ce, int mask_mode, float scale,
                                      void* stream) {
  if (B < 1 || L < 1 || K < 1 || K > kMaxRows || D < 1 || D > kMaxD || Ce < 1 ||
      (long long)B * L > 0x7fffffffLL || mask_mode < kMaskNone || mask_mode > kMaskPost ||
      (mask_mode != kMaskNone && mask == nullptr) || (dh == nullptr && msg == nullptr))
    return (int)cudaErrorInvalidValue;
  const int num_nodes = B * L;
  const int* idx = static_cast<const int*>(e_idx);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3,
                                      b3, dh, msg, num_nodes, L, K, D, Ce, mask_mode,
                                      scale, st)
              : launch<float>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3, b3, dh,
                              msg, num_nodes, L, K, D, Ce, mask_mode, scale, st);
  return (int)err;
}

// The backward's grid for these sizes (about one block per SM, at most one
// per tile): the wrapper sizes the workspace with it. Returns a cudaError_t.
extern "C" int reed_fused_message_bwd_blocks(int is_bf16, int B, int L, int K, int* blocks) {
  if (B < 1 || L < 1 || K < 1 || K > kMaxRows || (long long)B * L > 0x7fffffffLL ||
      blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? bwd_grid<__nv_bfloat16>(B * L, K, blocks)
                       : bwd_grid<float>(B * L, K, blocks));
}

// Inputs as reed_fused_message_fwd's, plus the cotangents gdh [B, L, D] and
// gmsg [B, L, K, D] in the input dtype (either may be null: a zero
// cotangent). Outputs: d_pre_self [B, L, D] and d_e_feat [B, L, K, Ce] in the
// input dtype; d_nbr_src f32 [B, L, D], zeroed by the caller (atomic adds);
// d_weights f32 [Ce*D + D*D + D + D*D + D] = dW_e, dW2, db2, dW3, db3 in that
// order. workspace: f32 [blocks, Ce*D + 2*D*D + 2*D], no initial value, with
// blocks from reed_fused_message_bwd_blocks. Launches on `stream`, allocates
// nothing and does not synchronise. Returns a cudaError_t.
extern "C" int reed_fused_message_bwd(const void* pre_self, const void* e_feat,
                                      const void* nbr_src, const void* e_idx, const void* mask,
                                      const void* w_e, const void* w2, const void* b2,
                                      const void* w3, const void* gdh,
                                      const void* gmsg, void* d_pre_self, void* d_e_feat,
                                      void* d_nbr_src, void* d_weights, void* workspace,
                                      int blocks, int is_bf16, int B, int L, int K, int D,
                                      int Ce, int mask_mode, float scale, void* stream) {
  if (B < 1 || L < 1 || K < 1 || K > kMaxRows || D < 1 || D > kMaxD || Ce < 1 ||
      (long long)B * L > 0x7fffffffLL || mask_mode < kMaskNone || mask_mode > kMaskPost ||
      (mask_mode != kMaskNone && mask == nullptr) || d_pre_self == nullptr ||
      d_e_feat == nullptr || d_nbr_src == nullptr || d_weights == nullptr ||
      workspace == nullptr || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int num_nodes = B * L;
  const int* idx = static_cast<const int*>(e_idx);
  const float* m = static_cast<const float*>(mask);
  float* dns = static_cast<float*>(d_nbr_src);
  float* dw = static_cast<float*>(d_weights);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3,
                                          gdh, gmsg, d_pre_self, d_e_feat, dns, dw, ws,
                                          blocks, num_nodes, L, K, D, Ce, mask_mode, scale, st)
              : launch_bwd<float>(pre_self, e_feat, nbr_src, idx, m, w_e, w2, b2, w3, gdh,
                                  gmsg, d_pre_self, d_e_feat, dns, dw, ws, blocks, num_nodes, L,
                                  K, D, Ce, mask_mode, scale, st);
  return (int)err;
}

extern "C" const char* reed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
