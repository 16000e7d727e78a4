// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_attn_kernel` of src/repro/kernels/flash_attention.py
// (launched by `flash_attention` there): o = softmax(q k^T * scale) v, causal
// or not, GQA through the kv-head index, online softmax with f32 m/l/acc,
// fully masked causal tiles skipped, and a row with l == 0 divided by 1.
//
// What bounds it on the H100: at the main path's prefill (bf16, B 4, H 24,
// KH 8, S 512, D 128, causal) the work is 6.45 GFLOP against 33.6 MB of q, k,
// v and o, so memory bounds it on paper (0.0100 ms at 3.35 TB/s; the
// operations take 0.0065 ms at 989 TFLOP/s bf16) and, in practice, how fast
// the tensor cores are fed.
//
// Two entry points, chosen by the wrapper from the input dtype before it
// launches (never as a fallback after a failure):
//
// bf16 (the model path): FlashAttention-2's structure on mma.sync.
// - One block of 4 warps per (b * H + h, query tile of 64 rows); each warp
//   owns 16 query rows, held in registers as m16n8k16 A fragments
//   (ldmatrix from the staged tile).
// - K and V tiles of 64 rows stay bf16 in shared memory in a 2-stage ring
//   filled by 16-byte cp.async, so tile j + 1 loads while tile j computes.
//   Rows are padded by 8 bf16 (16 bytes), which makes the 8 row addresses
//   of every ldmatrix fall in distinct banks. (64 + 4 * 64) x (D + 8) bf16
//   = 87 KB at D = 128: 2 blocks per SM.
// - S = Q K^T and O += P V run on the bf16 tensor cores with f32
//   accumulators; K is read with ldmatrix, V with ldmatrix.trans.
// - The online softmax works on the accumulator fragments: row max and sum
//   over the 4 lanes of a quad by shuffles, exp2 with scale * log2(e)
//   folded into the logits. P is rounded to bf16 in registers and fed
//   straight in as the A operand of P V (the C layout of two n-tiles is the
//   A layout of one k-step), the rounding the TPU kernel does
//   (`p.astype(v.dtype)`); l sums the unrounded p, as there.
// - Causal: tiles past a query tile's last row are skipped; the mask is
//   applied only on tiles that cross the diagonal or the ragged end of S.
//   The grid is (B * H, query tiles) with the query-tile index reversed, so
//   the heaviest tiles start first and the heads that share a kv head run
//   side by side (K and V stay in the 50 MB L2).
// - Any S: rows past S load as zeros (cp.async zero fill) and are masked
//   or not stored.
//
// f32 (the f32 smoke and parity runs only): scalar f32 FMAs on the CUDA
// cores, each thread register-blocking a 4 x 4 tile of the 64 x 64 score
// block and a 4 x D/16 tile of the output; K and V share one padded f32
// buffer (~81 KB at D = 128). TF32 tensor cores would miss the 2e-3 f32
// tolerance, and this path is not on the model's bf16 path.
//
// Layout: q, o (B, H, S, D); k, v (B, KH, S, D); all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 --

constexpr int TC_BM = 64;                  // query rows per block
constexpr int TC_BN = 64;                  // kv rows per tile
constexpr int TC_THREADS = TC_BM / 16 * 32;  // a warp per 16 query rows

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (TC_BM + 4 * TC_BN) * (D + 8);
}

// rows [row0, row0 + ROWS) of a (S, D) bf16 matrix into shared memory with
// a row pitch of D + 8, by 16-byte cp.async; rows past S are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int row0, int S, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int e = tid; e < ROWS * CPR; e += TC_THREADS) {
    const int r = e / CPR, c = e % CPR, gr = row0 + r;
    const bool ok = gr < S;
    mma::cp_async16(dst + r * (D + 8) + c * 8,
                    src + static_cast<int64_t>(ok ? gr : 0) * D + c * 8,
                    ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                      int KH, int S, float scale_log2, int causal) {
  constexpr int PITCH = D + 8;
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int ND = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BM x PITCH
  bf16* k_s = q_s + TC_BM * PITCH;                // 2 stages x BN x PITCH
  bf16* v_s = k_s + 2 * TC_BN * PITCH;            // 2 stages x BN x PITCH

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BM;  // heaviest first
  const bf16* qp = q + static_cast<int64_t>(bh) * S * D;
  const bf16* kp = k + (static_cast<int64_t>(b) * KH + kh) * S * D;
  const bf16* vp = v + (static_cast<int64_t>(b) * KH + kh) * S * D;
  bf16* op = o + static_cast<int64_t>(bh) * S * D;

  const int kv_end = causal ? min(S, q0 + TC_BM) : S;
  const int n_tiles = (kv_end + TC_BN - 1) / TC_BN;

  load_tile_async<D, TC_BM>(q_s, qp, q0, S, tid);
  load_tile_async<D, TC_BN>(k_s, kp, 0, S, tid);
  load_tile_async<D, TC_BN>(v_s, vp, 0, S, tid);
  mma::cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // rows r0 and r0 + 8 of this thread; m in the log2 domain
  const int r0 = q0 + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile_async<D, TC_BN>(k_s + (st ^ 1) * TC_BN * PITCH, kp,
                                (j + 1) * TC_BN, S, tid);
      load_tile_async<D, TC_BN>(v_s + (st ^ 1) * TC_BN * PITCH, vp,
                                (j + 1) * TC_BN, S, tid);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma::ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * PITCH +
                                     kk * 16 + (lane >> 4) * 8);
    }
    const bf16* ks = k_s + st * TC_BN * PITCH;
    const bf16* vs = v_s + st * TC_BN * PITCH;

    // S = Q K^T: 8 n-tiles of 8 kv columns
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t r[4];
        mma::ldmatrix_x4(r, ks + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     PITCH +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * nn], qf[kk], r[0], r[1]);
        mma::mma_bf16(s[2 * nn + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale into the log2 domain, mask, row max
    const int k0 = j * TC_BN;
    const bool need_mask = k0 + TC_BN > S || (causal && k0 + TC_BN - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale_log2;
        if (need_mask) {
          const int row = r0 + (i >> 1) * 8, col = k0 + n * 8 + 2 * qd + (i & 1);
          if (col >= S || (causal && col > row)) x = -INFINITY;
        }
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
      const float alpha = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // P = exp2(s - m) in registers, rounded to bf16 as A fragments
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = exp2f(s[n][i] - mu[i >> 1]);  // masked: exp2(-inf) = 0
        l[i >> 1] += p[i];
      }
      pf[n / 2][(n & 1) * 2] = mma::pack_bf16(p[0], p[1]);
      pf[n / 2][(n & 1) * 2 + 1] = mma::pack_bf16(p[2], p[3]);
    }

    // O += P V: 4 k-steps of 16 kv rows, D / 8 n-tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                   dd * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * dd], pf[kk], r[0], r[1]);
        mma::mma_bf16(acc[2 * dd + 1], pf[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's load
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(op + static_cast<int64_t>(row) * D + n * 8 +
                                   2 * qd) =
          mma::pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KH, int S, float scale, int causal,
                        cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kern = flash_fwd_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + TC_BM - 1) / TC_BM);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, KH, S,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16

// tile rows [row0, row0 + rows) of a (S, D) matrix into smem with a row
// pitch of D + 1; rows past S are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S, int tid) {
  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D, c = e % D, gr = row0 + r;
    dst[r * (D + 1) + c] = gr < S ? src[static_cast<int64_t>(gr) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H,
                     int KH, int S, float scale, int causal) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // BM x (D + 1)
  float* kv_s = q_s + BM * (D + 1);   // BN x (D + 1): K, then V
  float* p_s = kv_s + BN * (D + 1);   // BM x (BN + 1)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const float* qp = q + static_cast<int64_t>(bh) * S * D;
  const float* kp = k + (static_cast<int64_t>(b) * KH + kh) * S * D;
  const float* vp = v + (static_cast<int64_t>(b) * KH + kh) * S * D;
  float* op = o + static_cast<int64_t>(bh) * S * D;

  load_tile<D>(q_s, qp, q0, S, tid);

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
    load_tile<D>(kv_s, kp, k0, S, tid);
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
        p_s[(ty * 4 + a) * (BN + 1) + tx + 16 * j] = p;
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
    load_tile<D>(kv_s, vp, k0, S, tid);
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
      op[static_cast<int64_t>(qi) * D + tx + 16 * c] = acc[a][c] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KH, int S, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BM * (BN + 1));
  auto kern = flash_fwd_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KH, S, scale,
      causal);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               int, int, int, int, float, int, cudaStream_t);

cudaError_t dispatch(const Launch (&by_d)[4], const void* q, const void* k,
                     const void* v, void* o, int B, int H, int KH, int S,
                     int D, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH != 0)
    return cudaErrorInvalidValue;
  const int i = D == 16 ? 0 : D == 32 ? 1 : D == 64 ? 2 : D == 128 ? 3 : -1;
  if (i < 0) return cudaErrorInvalidValue;
  return by_d[i](q, k, v, o, B, H, KH, S, scale, causal,
                 static_cast<cudaStream_t>(stream));
}

constexpr Launch kBf16[4] = {launch_bf16<16>, launch_bf16<32>, launch_bf16<64>,
                             launch_bf16<128>};
constexpr Launch kF32[4] = {launch_f32<16>, launch_f32<32>, launch_f32<64>,
                            launch_f32<128>};

}  // namespace

extern "C" {

// bf16 q, k, v, o on the tensor cores. Returns a cudaError_t (0 = success).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int KH, int S, int D,
                             float scale, int causal, void* stream) {
  if ((S + TC_BM - 1) / TC_BM > 65535) return cudaErrorInvalidValue;
  return dispatch(kBf16, q, k, v, o, B, H, KH, S, D, scale, causal, stream);
}

// f32 q, k, v, o on the CUDA cores. Returns a cudaError_t (0 = success).
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int KH, int S, int D,
                            float scale, int causal, void* stream) {
  if (B * H > 65535) return cudaErrorInvalidValue;
  return dispatch(kF32, q, k, v, o, B, H, KH, S, D, scale, causal, stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
