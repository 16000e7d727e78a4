// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_attn_kernel` of src/repro/kernels/flash_attention.py
// (launched by `flash_attention` there): o = softmax(q k^T * scale) v, causal
// or not, GQA through the kv-head index, online softmax with f32 m/l/acc,
// fully masked causal tiles skipped, and a row with l == 0 divided by 1.
//
// What bounds it on the H100: at the main path's prefill (S = 512, D = 128)
// the work is ~2 S^2 D FLOPs per head against ~4 S D bytes, far above the
// card's ~295 FLOP/byte ridge, so operations bound it. This first kernel
// computes with scalar f32 FMAs on the CUDA cores, not the tensor cores
// (mma/wgmma are later work), so its bound is the 67 TFLOP/s f32 rate in
// practice, not the 989 TFLOP/s bf16 one. What the design does about it:
// each thread register-blocks a 4x4 tile of the 64x64 score block and a
// 4 x D/16 tile of the output, so one shared-memory read feeds four FMAs;
// K and V tiles share one padded f32 buffer (no bank conflicts on the
// column reads), which keeps shared memory at ~81 KB for D = 128 and lets
// two blocks run on one SM.
//
// Layout: q, o (B, H, S, D); k, v (B, KH, S, D); all contiguous. One block
// of 256 threads per (query tile of 64 rows, b * H + h).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// probabilities are rounded to the value dtype before the PV product, as
// the TPU kernel does (`p.astype(v.dtype)`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// tile rows [row0, row0 + rows) of a (S, D) matrix into smem as f32 with
// a row pitch of D + 1; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int S, int tid) {
  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D, c = e % D, gr = row0 + r;
    dst[r * (D + 1) + c] =
        gr < S ? to_f32(src[static_cast<int64_t>(gr) * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int S, float scale, int causal) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // BM x (D + 1)
  float* kv_s = q_s + BM * (D + 1);   // BN x (D + 1): K, then V
  float* p_s = kv_s + BN * (D + 1);   // BM x (BN + 1)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const T* qp = q + static_cast<int64_t>(bh) * S * D;
  const T* kp = k + (static_cast<int64_t>(b) * KH + kh) * S * D;
  const T* vp = v + (static_cast<int64_t>(b) * KH + kh) * S * D;
  T* op = o + static_cast<int64_t>(bh) * S * D;

  load_tile<T, D>(q_s, qp, q0, S, tid);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  // causal: kv tiles past the last query row of this block are fully masked
  const int kv_end = causal ? min(S, q0 + BM) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // previous PV done with kv_s (and q_s written)
    load_tile<T, D>(kv_s, kp, k0, S, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = q_s[(ty * 4 + a) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qv[a], kv[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty * 4 + a;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < S && (!causal || kj <= qi);
        s[a][j] = ok ? s[a][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][j]);
      }
      // the 16 threads of one row are lanes [0,16) or [16,32) of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked
      const float alpha = expf(m[a] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[a][j] - m_use);  // masked: exp(-inf) = 0
        rs += p;
        p_s[(ty * 4 + a) * (BN + 1) + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = alpha * l[a] + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();  // everyone done reading K; p_s complete
    load_tile<T, D>(kv_s, vp, k0, S, tid);
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BN; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = p_s[(ty * 4 + a) * (BN + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kv_s[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty * 4 + a;
    if (qi >= S) continue;
    const float inv = 1.f / (l[a] == 0.f ? 1.f : l[a]);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      op[static_cast<int64_t>(qi) * D + tx + 16 * c] =
          from_f32<T>(acc[a][c] * inv);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BM * (BN + 1));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int S, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KH, int S, int D, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KH, S, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KH, S, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KH, S, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KH, S, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KH, int S, int D, float scale,
                        int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH != 0 || B * H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KH, S, D, scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KH, S, D, scale, causal, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
