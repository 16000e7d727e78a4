// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a), plain C
// interface.
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
// the tensor cores are fed. At zamba2's prefill (bf16, B 4, H = KH = 32,
// S 512, D 80, causal) q, k, v and o are 41.9 MB (0.0125 ms at 3.35 TB/s)
// against 5.4 GFLOP (0.0054 ms at 989 TFLOP/s): bytes bound it there too.
//
// Head dims 16, 32, 64, 80 and 128, each its own template instance. D = 80
// (not a multiple of 64) needs nothing of its own: a row is 10 16-byte
// chunks (5 per thread for a 64-row tile), the 88-bf16 pitch puts the 8 row
// addresses of an ldmatrix 176 bytes apart, in distinct bank quads, and the
// products take 5 k-steps of 16 and 10 n-tiles of 8.
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
//   = 87 KB at D = 128 (56 KB at D = 80): 2 blocks per SM.
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
// Both forward entries also write each query row's natural-log log-sum-exp
// (m + log l, as the JAX package's blocked forward) into an f32 (B, H, S)
// lse when the caller passes one (training); the serve path passes null,
// and then nothing else of the forward changes. The backward, for
// training, follows the forward kernels below.
//
// Layout: q, o (B, H, S, D); k, v (B, KH, S, D); all contiguous. k and v
// have q's length S, as in the Pallas kernel: cross-attention over an
// encoder output of another length is not taken (whisper serves encoder
// outputs of the prompt's length, as the JAX server does; ROADMAP A13.6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// natural-log log-sum-exp of a row from its running max m (natural log
// domain) and sum l = sum exp(s - m): m + log(l). A row with nothing
// unmasked (l = 0; never one of S rows of self-attention over S keys)
// stores +inf, so the backward's exp(s - lse) gives it no gradient.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l == 0.f ? INFINITY : m + logf(l);
}

// One call's operands: q, o, dout, dq (B, H, S, D); k, v, dk, dv
// (B, KH, S, D); lse and delta (B, H, S) f32. The forward reads q, k, v
// and writes o (and lse where it is not null); the backward reads q, k,
// v, o, dout and lse and writes delta (scratch), dq, dk and dv.
struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float *lse, *delta;
  int B, H, KH, S;
  float scale;
  int causal;
  cudaStream_t stream;
  // the wgmma backward's work lists (int32 [starts | items]) and grids
  const int* dkdv_work = nullptr;
  const int* dq_work = nullptr;
  int dkdv_programs = 0, dq_programs = 0;
};

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
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int KH, int S,
                      float scale_log2, int causal) {
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
    if (lse != nullptr && qd == 0)
      lse[static_cast<int64_t>(bh) * S + row] = row_lse(m[r] * kLn2, l[r]);
  }
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kern = flash_fwd_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + TC_BM - 1) / TC_BM);
  kern<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.H,
      a.KH, a.S, a.scale * kLog2e, a.causal);
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
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int KH, int S, float scale,
                     int causal) {
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
    if (lse != nullptr && tx == 0)
      lse[static_cast<int64_t>(bh) * S + qi] = row_lse(m[a], l[a]);
  }
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem =
      sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BM * (BN + 1));
  auto kern = flash_fwd_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BM - 1) / BM, a.B * a.H);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H,
      a.KH, a.S, a.scale, a.causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------ backward --
//
// The gradient of o = softmax(q k^T * scale) v, as `_flash_bwd` of
// src/repro/models/layers.py computes it (the TPU package's backward is
// jnp, not Pallas; this kernel has no TPU counterpart). From the saved
// q, k, v, o and the forward's row log-sum-exp lse (natural log):
//   delta = rowsum(dO * O)                       (one f32 per query row)
//   P     = exp(S * scale - lse),  S = Q K^T     (recomputed, never stored)
//   dS    = P * (dP - delta) * scale,  dP = dO V^T
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
// Three launches:
// - flash_bwd_delta_kernel: one warp per query row.
// - dk/dv: one block per (b, kv head, 64-row kv tile). It walks the H / KH
//   query heads of its kv head and, causal, only the query tiles at or
//   past its own, and keeps dK and dV in f32 registers, written once: the
//   GQA sum over the group stays inside the block, with no atomics.
// - dq: one block per (b * H + h, 64-row query tile), walking the kv
//   tiles up to the diagonal, dQ in f32 registers.
// bf16: each warp owns 16 rows (kv rows in dk/dv, query rows in dq). The
// four products of a tile run on mma.sync with f32 accumulators: in dk/dv,
// S^T = K Q^T and dP^T = V dO^T (K and V as A fragments by ldmatrix, Q and
// dO as B), then dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded
// to bf16 in registers as A fragments and dO, Q read by ldmatrix.trans; in
// dq, S = Q K^T, dP = dO V^T, dQ += dS K. The plain version and the JAX
// backward keep P and dS in f32; their bf16 rounding here is the one the
// forward makes of P before P V. The query (or kv) tiles of the walk are
// double-buffered by 16-byte cp.async, as the forward's kv tiles.
// f32: the same blocks on the CUDA cores (16 x 16 threads, a 4 x 4 tile of
// each score block and a 4 x D/16 tile of each gradient a thread), for the
// f32 parity runs, as the forward.
//
// What bounds it on the H100: at the dense training path's attention
// (bf16, B 2, H 24, KH 8, S 4096, D 128, causal) the backward is 5 products
// of 2 * S(S+1)/2 * D MACs each per (b, h), 515 GFLOP (0.52 ms at
// 989 TFLOP/s), against 269 MB read and written once (0.080 ms at
// 3.35 TB/s): the operations bound it. This design issues mma.sync from 4
// warps with no warp specialisation. Its bf16 entry runs at every
// head_dim; the wrapper sends 64, 80 and 128 to the wgmma kernels
// further down.
//
// Ragged S: rows past S load as zeros and are masked or not stored; a
// query column past S gets P = 0.

__global__ void __launch_bounds__(256)
flash_bwd_delta_bf16_kernel(const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += __bfloat162float(o[row * D + d]) * __bfloat162float(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

__global__ void __launch_bounds__(256)
flash_bwd_delta_f32_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += o[row * D + d] * dout[row * D + d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// 64 floats of a (rows,) vector into shared memory, zero past S
__device__ __forceinline__ void load_vec_async(float* dst,
                                               const float* __restrict__ src,
                                               int row0, int S, int i) {
  const bool ok = row0 + i < S;
  mma::cp_async4(dst + i, src + (ok ? row0 + i : 0), ok ? 4 : 0);
}

template <int D>
constexpr size_t tc_bwd_smem_bytes() {
  return sizeof(bf16) * 6 * TC_BM * (D + 8) + sizeof(float) * 4 * TC_BM;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                           int KH, int S, float scale, int causal) {
  constexpr int PITCH = D + 8;
  constexpr int KD = D / 16;  // k-steps of the score products
  constexpr int ND = D / 8;   // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // BN x PITCH
  bf16* v_s = k_s + TC_BN * PITCH;                // BN x PITCH
  bf16* q_s = v_s + TC_BN * PITCH;                // 2 stages x BM x PITCH
  bf16* do_s = q_s + 2 * TC_BM * PITCH;           // 2 stages x BM x PITCH
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TC_BM * PITCH);  // 2 x BM
  float* dl_s = lse_s + 2 * TC_BM;                                    // 2 x BM

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int bkh = blockIdx.x, b = bkh / KH, kh = bkh % KH, rep = H / KH;
  const int kv0 = blockIdx.y * TC_BN;  // the heaviest tiles (first) first
  const int n_qt = (S + TC_BM - 1) / TC_BM;
  const int qt0 = causal ? kv0 / TC_BM : 0;  // query tiles that see this one
  const int nq = n_qt - qt0, n_it = rep * nq;
  const float sl2 = scale * kLog2e;

  auto load_q = [&](int it, int st) {
    const int bh = b * H + kh * rep + it / nq, q0 = (qt0 + it % nq) * TC_BM;
    const int64_t off = static_cast<int64_t>(bh) * S * D;
    load_tile_async<D, TC_BM>(q_s + st * TC_BM * PITCH, q + off, q0, S, tid);
    load_tile_async<D, TC_BM>(do_s + st * TC_BM * PITCH, dout + off, q0, S,
                              tid);
    if (tid < TC_BM)
      load_vec_async(lse_s + st * TC_BM, lse + static_cast<int64_t>(bh) * S,
                     q0, S, tid);
    else
      load_vec_async(dl_s + st * TC_BM, delta + static_cast<int64_t>(bh) * S,
                     q0, S, tid - TC_BM);
  };
  const int64_t kv_off = static_cast<int64_t>(bkh) * S * D;
  load_tile_async<D, TC_BN>(k_s, k + kv_off, kv0, S, tid);
  load_tile_async<D, TC_BN>(v_s, v + kv_off, kv0, S, tid);
  load_q(0, 0);
  mma::cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  const int kr0 = kv0 + warp * 16 + g;  // this thread's kv rows: kr0, kr0 + 8

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % nq) * TC_BM;
    const bf16* qs = q_s + st * TC_BM * PITCH;
    const bf16* dos = do_s + st * TC_BM * PITCH;
    const float* ls = lse_s + st * TC_BM;
    const float* ds = dl_s + st * TC_BM;

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 64 query columns a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      const int a_off = (warp * 16 + (lane & 15)) * PITCH + kk * 16 +
                        (lane >> 4) * 8;
      mma::ldmatrix_x4(ka, k_s + a_off);
      mma::ldmatrix_x4(va, v_s + a_off);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int b_off = (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        mma::ldmatrix_x4(r, qs + b_off);
        mma::mma_bf16(s[2 * nn], ka, r[0], r[1]);
        mma::mma_bf16(s[2 * nn + 1], ka, r[2], r[3]);
        mma::ldmatrix_x4(r, dos + b_off);
        mma::mma_bf16(dp[2 * nn], va, r[0], r[1]);
        mma::mma_bf16(dp[2 * nn + 1], va, r[2], r[3]);
      }
    }

    // P^T and dS^T, rounded to bf16 as the A fragments of the updates
    const bool need_mask = q0 + TC_BM > S || (causal && kv0 + TC_BN - 1 > q0);
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n * 8 + 2 * qd + (i & 1);
        p[i] = exp2f(s[n][i] * sl2 - ls[c] * kLog2e);
        if (need_mask) {
          const int qc = q0 + c, kr = kr0 + (i >> 1) * 8;
          if (qc >= S || (causal && kr > qc)) p[i] = 0.f;
        }
        d[i] = p[i] * (dp[n][i] - ds[c]) * scale;
      }
      pf[n / 2][(n & 1) * 2] = mma::pack_bf16(p[0], p[1]);
      pf[n / 2][(n & 1) * 2 + 1] = mma::pack_bf16(p[2], p[3]);
      dsf[n / 2][(n & 1) * 2] = mma::pack_bf16(d[0], d[1]);
      dsf[n / 2][(n & 1) * 2 + 1] = mma::pack_bf16(d[2], d[3]);
    }

    // dV += P^T dO, dK += dS^T Q: 4 k-steps of 16 query rows, D / 8 n-tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const int t_off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              PITCH +
                          dd * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        mma::ldmatrix_x4_trans(r, dos + t_off);
        mma::mma_bf16(dv_acc[2 * dd], pf[kk], r[0], r[1]);
        mma::mma_bf16(dv_acc[2 * dd + 1], pf[kk], r[2], r[3]);
        mma::ldmatrix_x4_trans(r, qs + t_off);
        mma::mma_bf16(dk_acc[2 * dd], dsf[kk], r[0], r[1]);
        mma::mma_bf16(dk_acc[2 * dd + 1], dsf[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's load
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr0 + r * 8;
    if (row >= S) continue;
    const int64_t base = kv_off + static_cast<int64_t>(row) * D + 2 * qd;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + n * 8) =
          mma::pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + n * 8) =
          mma::pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int KH, int S,
                         float scale, int causal) {
  constexpr int PITCH = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BM x PITCH
  bf16* do_s = q_s + TC_BM * PITCH;               // BM x PITCH
  bf16* k_s = do_s + TC_BM * PITCH;               // 2 stages x BN x PITCH
  bf16* v_s = k_s + 2 * TC_BN * PITCH;            // 2 stages x BN x PITCH

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BM;  // heaviest first
  const int64_t q_off = static_cast<int64_t>(bh) * S * D;
  const bf16* kp = k + (static_cast<int64_t>(b) * KH + kh) * S * D;
  const bf16* vp = v + (static_cast<int64_t>(b) * KH + kh) * S * D;
  const int kv_end = causal ? min(S, q0 + TC_BM) : S;
  const int n_tiles = (kv_end + TC_BN - 1) / TC_BN;
  const float sl2 = scale * kLog2e;

  load_tile_async<D, TC_BM>(q_s, q + q_off, q0, S, tid);
  load_tile_async<D, TC_BM>(do_s, dout + q_off, q0, S, tid);
  load_tile_async<D, TC_BN>(k_s, kp, 0, S, tid);
  load_tile_async<D, TC_BN>(v_s, vp, 0, S, tid);
  mma::cp_async_commit();

  const int r0 = q0 + warp * 16 + g;  // this thread's query rows: r0, r0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    const int64_t i = static_cast<int64_t>(bh) * S + (row < S ? row : 0);
    lse2[r] = lse[i] * kLog2e;
    dl[r] = delta[i];
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

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
    const bf16* ks = k_s + st * TC_BN * PITCH;
    const bf16* vs = v_s + st * TC_BN * PITCH;

    // S = Q K^T and dP = dO V^T: 16 query rows x 64 kv columns a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      const int a_off = (warp * 16 + (lane & 15)) * PITCH + kk * 16 +
                        (lane >> 4) * 8;
      mma::ldmatrix_x4(qa, q_s + a_off);
      mma::ldmatrix_x4(da, do_s + a_off);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int b_off = (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        mma::ldmatrix_x4(r, ks + b_off);
        mma::mma_bf16(s[2 * nn], qa, r[0], r[1]);
        mma::mma_bf16(s[2 * nn + 1], qa, r[2], r[3]);
        mma::ldmatrix_x4(r, vs + b_off);
        mma::mma_bf16(dp[2 * nn], da, r[0], r[1]);
        mma::mma_bf16(dp[2 * nn + 1], da, r[2], r[3]);
      }
    }

    // dS, rounded to bf16 as the A fragments of dQ += dS K
    const int k0 = j * TC_BN;
    const bool need_mask = k0 + TC_BN > S || (causal && k0 + TC_BN - 1 > q0);
    uint32_t dsf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2f(s[n][i] * sl2 - lse2[i >> 1]);
        if (need_mask) {
          const int col = k0 + n * 8 + 2 * qd + (i & 1), row = r0 + (i >> 1) * 8;
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        d[i] = p * (dp[n][i] - dl[i >> 1]) * scale;
      }
      dsf[n / 2][(n & 1) * 2] = mma::pack_bf16(d[0], d[1]);
      dsf[n / 2][(n & 1) * 2 + 1] = mma::pack_bf16(d[2], d[3]);
    }

    // dQ += dS K: 4 k-steps of 16 kv rows, D / 8 n-tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                   dd * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * dd], dsf[kk], r[0], r[1]);
        mma::mma_bf16(acc[2 * dd + 1], dsf[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's load
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dq + q_off + static_cast<int64_t>(row) * D +
                                   n * 8 + 2 * qd) =
          mma::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
cudaError_t launch_bwd_bf16(const Args& a) {
  constexpr size_t smem = tc_bwd_smem_bytes<D>();
  auto dkdv = flash_bwd_dkdv_bf16_kernel<D>;
  auto dqk = flash_bwd_dq_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.S;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  flash_bwd_delta_bf16_kernel<<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), dout, a.delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (a.S + TC_BM - 1) / TC_BM;
  dkdv<<<dim3(a.B * a.KH, tiles), TC_THREADS, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.H, a.KH, a.S, a.scale, a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3(a.B * a.H, tiles), TC_THREADS, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.H, a.KH, a.S,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H,
                          int KH, int S, float scale, int causal) {
  constexpr int DC = D / 16;  // gradient columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;                  // BN x (D + 1)
  float* v_s = k_s + BN * (D + 1);    // BN x (D + 1)
  float* q_s = v_s + BN * (D + 1);    // BM x (D + 1)
  float* do_s = q_s + BM * (D + 1);   // BM x (D + 1)
  float* p_s = do_s + BM * (D + 1);   // BN x (BM + 1): P^T
  float* ds_s = p_s + BN * (BM + 1);  // BN x (BM + 1): dS^T
  float* lse_s = ds_s + BN * (BM + 1);
  float* dl_s = lse_s + BM;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kv0 = blockIdx.x * BN;
  const int bkh = blockIdx.y, b = bkh / KH, kh = bkh % KH, rep = H / KH;
  const int64_t kv_off = static_cast<int64_t>(bkh) * S * D;
  load_tile<D>(k_s, k + kv_off, kv0, S, tid);
  load_tile<D>(v_s, v + kv_off, kv0, S, tid);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int qt0 = causal ? kv0 / BM : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int bh = b * H + kh * rep + hh;
    const int64_t q_off = static_cast<int64_t>(bh) * S * D;
    for (int q0 = qt0 * BM; q0 < S; q0 += BM) {
      __syncthreads();  // the previous tile's updates are done with q_s
      load_tile<D>(q_s, q + q_off, q0, S, tid);
      load_tile<D>(do_s, dout + q_off, q0, S, tid);
      if (tid < BM) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse[static_cast<int64_t>(bh) * S + q0 + tid] : 0.f;
        dl_s[tid] = ok ? delta[static_cast<int64_t>(bh) * S + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kv[a] = k_s[(ty * 4 + a) * (D + 1) + d];
          vv[a] = v_s[(ty * 4 + a) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * (D + 1) + d];
          ov[j] = do_s[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[a][j] = fmaf(kv[a], qv[j], s[a][j]);
            dp[a][j] = fmaf(vv[a], ov[j], dp[a][j]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kr = kv0 + ty * 4 + a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qc = q0 + c;
          const bool ok = qc < S && (!causal || kr <= qc);
          const float p = ok ? expf(s[a][j] * scale - lse_s[c]) : 0.f;
          p_s[(ty * 4 + a) * (BM + 1) + c] = p;
          ds_s[(ty * 4 + a) * (BM + 1) + c] = p * (dp[a][j] - dl_s[c]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < BM; ++i) {
        float pv[4], dsv[4], ov[DC], qv[DC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = p_s[(ty * 4 + a) * (BM + 1) + i];
          dsv[a] = ds_s[(ty * 4 + a) * (BM + 1) + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = do_s[i * (D + 1) + tx + 16 * c];
          qv[c] = q_s[i * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[a][c] = fmaf(pv[a], ov[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dsv[a], qv[c], dk_acc[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = kv0 + ty * 4 + a;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int64_t i = kv_off + static_cast<int64_t>(row) * D + tx + 16 * c;
      dk[i] = dk_acc[a][c];
      dv[i] = dv_acc[a][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int KH, int S,
                        float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // BM x (D + 1)
  float* do_s = q_s + BM * (D + 1);   // BM x (D + 1)
  float* k_s = do_s + BM * (D + 1);   // BN x (D + 1)
  float* v_s = k_s + BN * (D + 1);    // BN x (D + 1)
  float* ds_s = v_s + BN * (D + 1);   // BM x (BN + 1)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int64_t q_off = static_cast<int64_t>(bh) * S * D;
  const float* kp = k + (static_cast<int64_t>(b) * KH + kh) * S * D;
  const float* vp = v + (static_cast<int64_t>(b) * KH + kh) * S * D;
  load_tile<D>(q_s, q + q_off, q0, S, tid);
  load_tile<D>(do_s, dout + q_off, q0, S, tid);

  float lr[4], dl[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    const int64_t i = static_cast<int64_t>(bh) * S + (row < S ? row : 0);
    lr[a] = lse[i];
    dl[a] = delta[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BM) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's dQ update is done with k_s
    load_tile<D>(k_s, kp, k0, S, tid);
    load_tile<D>(v_s, vp, k0, S, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = q_s[(ty * 4 + a) * (D + 1) + d];
        ov[a] = do_s[(ty * 4 + a) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * (D + 1) + d];
        vv[j] = v_s[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = fmaf(qv[a], kv[j], s[a][j]);
          dp[a][j] = fmaf(ov[a], vv[j], dp[a][j]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty * 4 + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < S && (!causal || kj <= qi);
        const float p = ok ? expf(s[a][j] * scale - lr[a]) : 0.f;
        ds_s[(ty * 4 + a) * (BN + 1) + tx + 16 * j] =
            p * (dp[a][j] - dl[a]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BN; ++i) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = ds_s[(ty * 4 + a) * (BN + 1) + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = k_s[i * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(dsv[a], kv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[q_off + static_cast<int64_t>(row) * D + tx + 16 * c] = acc[a][c];
  }
}

template <int D>
cudaError_t launch_bwd_f32(const Args& a) {
  constexpr size_t smem_kv =
      sizeof(float) * (4 * BM * (D + 1) + 2 * BN * (BM + 1) + 2 * BM);
  constexpr size_t smem_q = sizeof(float) * (4 * BM * (D + 1) + BM * (BN + 1));
  auto dkdv = flash_bwd_dkdv_f32_kernel<D>;
  auto dqk = flash_bwd_dq_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.S;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* dout = static_cast<const float*>(a.dout);
  flash_bwd_delta_f32_kernel<<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const float*>(a.o), dout, a.delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (a.S + BM - 1) / BM;
  dkdv<<<dim3(tiles, a.B * a.KH), THREADS, smem_kv, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.H, a.KH, a.S, a.scale, a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3(tiles, a.B * a.H), THREADS, smem_q, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.KH,
      a.S, a.scale, a.causal);
  return cudaGetLastError();
}

// ------------------------------------------------- backward, wgmma (sm90) --
//
// The bf16 backward at head_dim 64, 80 and 128, entry
// flash_attention_bwd_bf16_sm90 (the wrapper, flash_attention.bwd_kernel,
// chooses the entry by head_dim before the launch; 16 and 32 keep the
// mma.sync kernels above, entry flash_attention_bwd_bf16, which runs at
// every head_dim). Three launches, as there: a prep launch, dk/dv, dq.
// Head_dim 64 and 80 take them because they are faster there too
// (chip_smoke.py times both at (2, 16, 16, 4096, 64) and at zamba2's
// (2, 32, 32, 4096, 80); PERF.md §6).
//
// Head_dim 80 (zamba2's shared block) is a row of two 128-byte-swizzle
// boxes, as at 128: TMA loads the second at column 64 and writes its
// columns 80-127, past the tensor's edge, as zeros. The products that
// run along the head dim (S = Q K^T, dP = dO V^T) take 5 k-steps of 16,
// the last one from the second box, so no multiply is wasted; the ones
// whose N is the head dim (dV, dK, dQ) are m64n80k16, whose descriptor
// steps from the first box to the second by its LBO as the n128 form
// does. Shared memory is that of head_dim 128.
//
// What bounds it: at the dense training path's attention (B 2, H 24, KH 8,
// S 4096, D 128, causal) the five products the algorithm needs are
// 515 GFLOP (0.52 ms at 989 TFLOP/s), the bytes 0.080 ms: the tensor
// cores, and how well they are kept fed. What the design does about what
// held the mma.sync kernels back:
// 1. Seven products for five: S and dP are still computed in both the
//    dk/dv and the dq launch (722 GFLOP, a 0.73 ms floor). A dQ summed
//    in the dk/dv block, from each kv tile's part, would drop two; to be
//    bitwise reproducible those parts have to be added in a fixed order
//    (a turn counter per query tile), and that ordered f32 traffic cost
//    more than the two products save on the H100 (PERF.md §6).
// 2. Every product is a wgmma from one warpgroup (4 warps, 64 rows):
//    the tensor cores read Q, dO, K and V from shared memory through
//    descriptors (128-byte swizzle, as TMA writes them); the transposed
//    products (dV += P^T dO, dK += dS^T Q, dQ += dS K) take the same
//    tiles MN-major, with no transposed copy and no ldmatrix. P^T and
//    dS^T (and dS in dq) go back in as register A operands: the f32
//    accumulator of one product, rounded to bf16, is the A fragment of
//    the next (the rounding of the mma.sync kernels and of the forward).
// 3. Warp specialisation: 3 warpgroups a block. One producer thread keeps
//    the walk's tiles in flight (TMA boxes of Q and dO, bulk copies of
//    their lse and delta rows; K and V in dq) in a 3-stage ring, one
//    full and one empty mbarrier a stage. The producer's warpgroup gives
//    up its registers (setmaxnreg) to the two consumer warpgroups, which
//    hold a 64-row slice of the block's tile with dK and dV (or dQ) in
//    f32 registers (2 x D / 2 a thread) beside the two 64 x 64 score
//    tiles. A consumer releases a stage with one arrival a warp, not one
//    a thread (PERF.md §6: the dq kernel went from 0.75 to 0.57 ms
//    with that and ex2.approx.ftz for exp2). In dq a tile's dQ product is
//    waited for, and its stage released, in the next tile, so it runs
//    while that tile's S and dP are started.
// 4. 128-row work items: a dk/dv block owns 128 kv rows (64 a consumer),
//    so each Q + dO tile brought in from L2 feeds twice the rows it fed;
//    a dq block owns 128 query rows and walks 64-row K, V tiles.
// 5. A persistent grid of one block an SM: the host orders the work
//    items (b, kv head, kv tile) and (b, head, query tile) heaviest
//    first and deals them to the programs, each to the least loaded so
//    far (`flash_attention.bwd_schedule`), and passes the lists as an
//    int32 tensor [starts (programs + 1) | items]. A block walks its
//    list; the producer loads the next item's K and V (or Q and dO)
//    while the consumers write the last item's gradients.
// Causal: a dk/dv block starts at the query tile of its own first row; a
// consumer warpgroup whose 64 rows are all past a tile's last query (or,
// in dq, before its first key) skips the products and still releases
// the stage; masks are applied only on tiles that cross the diagonal.
// Ragged S: TMA zero-fills rows past S; a prep launch writes
// delta = rowsum(dO * O) and lse * log2(e) into rows padded to a
// multiple of 128, +inf past S, so a padded query gets P = 0 with no
// mask; kv rows past S are not stored.
// Deterministic: every gradient element is summed by one warpgroup in one
// order, with no atomics; two calls give the same bits.
// ptxas (sm_90a, CUDA 12.9): 168 registers at entry, no spill in either
// kernel at any of the three head dims (chip_smoke.py's build phase
// checks it).

constexpr int SM90_BN = 128;     // kv rows per dk/dv work item
constexpr int SM90_BM = 64;      // query rows per step of the dk/dv walk
constexpr int SM90_DQ_BM = 128;  // query rows per dq work item
constexpr int SM90_DQ_BN = 64;   // kv rows per step of the dq walk
static_assert(SM90_BM == 64 && SM90_DQ_BN == 64,
              "the products below take 64 x 64 score tiles");
constexpr int SM90_PAD = 128;    // lse / delta rows padded to this
constexpr int SM90_STAGES = 3;   // the rings of both walks
constexpr int SM90_THREADS = 384;   // 2 consumer warpgroups + 1 producer
constexpr int SM90_CONSUMERS = 256;
// registers a thread after setmaxnreg (2 x 128 x consumer + 128 x
// producer <= 65,536): the producer's copies need few, a consumer's
// accumulators many (at D 128: 2 x 64 of dK and dV, or 64 of dQ, beside
// two 64 x 64 score tiles)
__host__ __device__ constexpr int sm90_producer_regs(int D) {
  return D == 128 ? 24 : 40;
}
__host__ __device__ constexpr int sm90_consumer_regs(int D) {
  return D == 128 ? 240 : 232;
}

// threads a row of the prep launch: D / 8 rounded up to a power of two
__host__ __device__ constexpr int prep_threads_a_row(int D) {
  return D <= 64 ? D / 8 : 16;
}

// delta = rowsum(dO * O) and lse2 = lse * log2(e) of every query row into
// (B * H, S_pad) rows; rows past S get delta 0 and lse2 +inf (P = 0).
// prep_threads_a_row(D) threads a row, the first D / 8 of them 16 bytes of
// O and of dO each.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_bf16_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta, float* __restrict__ lse2,
                           int S, int S_pad, int64_t rows) {
  constexpr int TPR = prep_threads_a_row(D);
  static_assert(TPR * 8 >= D && (TPR & (TPR - 1)) == 0, "a row's threads");
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (256 / TPR) + threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  if (row >= rows) return;  // whole blocks: rows is a multiple of 128
  const int64_t bh = row / S_pad;
  const int i = static_cast<int>(row % S_pad);
  const int64_t src = bh * S + i;
  float s = 0.f;
  if (i < S && 8 * t < D) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + src * D + 8 * t);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + src * D + 8 * t);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[j]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&bv[j]));
      s += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (t == 0) {
    delta[row] = s;
    lse2[row] = i < S ? lse[src] * kLog2e : INFINITY;
  }
}

// boxes of 64 bf16 columns in a row of D (at D 80 the second box holds
// columns 64-79 and TMA's zeros)
__host__ __device__ constexpr int sm90_boxes(int D) { return (D + 63) / 64; }

// Shared memory of a dk/dv block: each tile is sm90_boxes(D) boxes of rows
// x 64 bf16, every box at a 1024-byte boundary
template <int D>
struct DkdvSmem {
  static constexpr int NB = sm90_boxes(D);
  bf16 k[NB][SM90_BN][64];
  bf16 v[NB][SM90_BN][64];
  bf16 q[SM90_STAGES][NB][SM90_BM][64];
  bf16 dout[SM90_STAGES][NB][SM90_BM][64];
  float lse2[SM90_STAGES][SM90_BM];
  float delta[SM90_STAGES][SM90_BM];
  uint64_t kv_full, kv_empty, q_full[SM90_STAGES], q_empty[SM90_STAGES];
};

template <int D>
struct DqSmem {
  static constexpr int NB = sm90_boxes(D);
  bf16 q[NB][SM90_DQ_BM][64];
  bf16 dout[NB][SM90_DQ_BM][64];
  bf16 k[SM90_STAGES][NB][SM90_DQ_BN][64];
  bf16 v[SM90_STAGES][NB][SM90_DQ_BN][64];
  float lse2[SM90_DQ_BM];
  float delta[SM90_DQ_BM];
  uint64_t q_full, q_empty, kv_full[SM90_STAGES], kv_empty[SM90_STAGES];
};

template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

template <typename T>
constexpr size_t sm90_smem_bytes() {
  return sizeof(T) + 1024;  // room to align the base to 1024
}

// a 64 x 64 f32 accumulator (32 a thread) as bf16 register A fragments:
// n-blocks 2kk, 2kk + 1 of each warp's rows are k-step kk
__device__ __forceinline__ void acc_to_a(const float (&c)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = mma::pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = mma::pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = mma::pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = mma::pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// d (64 x D) += a (64 x 64, four k-steps in registers) . b (64 x D bf16
// in shared memory, MN-major, boxes of `box_bytes`)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b, uint32_t box_bytes) {
  static_assert(D == 64 || D == 80 || D == 128, "a wgmma N of the head dim");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hopper::desc_sw128(b + kk * 2048, box_bytes, 1024);
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs(d, a[kk], db);
    else if constexpr (D == 80)
      hopper::wgmma_m64n80k16_rs(d, a[kk], db);
    else
      hopper::wgmma_m64n64k16_rs(d, a[kk], db);
  }
}

// d (64 x 64) = a (64 x D) . b (64 x D)^T, both K-major in shared memory,
// boxes of a_box and b_box bytes (k-step kk in box kk / 4)
template <int D>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint32_t a,
                                         uint32_t a_box, uint32_t b,
                                         uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in = (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(
        d, hopper::desc_sw128(a + (kk / 4) * a_box + in, 0, 1024),
        hopper::desc_sw128(b + (kk / 4) * b_box + in, 0, 1024), kk > 0);
  }
}

// rows row and row + 8 of a thread's f32 (64 x D) accumulator as bf16 into
// an (S, D) matrix, rows at or past S skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[D / 2], int row,
                                           int S, int qd) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= S) continue;
    bf16* p = out + static_cast<int64_t>(row + 8 * h) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          mma::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ lse2,
                           const float* __restrict__ delta,
                           const int* __restrict__ work,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int KH, int S, int S_pad, float scale,
                           int causal) {
  using Smem = DkdvSmem<D>;
  constexpr int NB = Smem::NB;
  constexpr uint32_t KV_BOX = SM90_BN * 128, Q_BOX = SM90_BM * 128;
  constexpr uint32_t KV_BYTES = 2 * NB * KV_BOX;
  constexpr uint32_t Q_BYTES = 2 * NB * Q_BOX + 2 * SM90_BM * 4;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    hopper::mbar_init(&sm.kv_empty, SM90_CONSUMERS / 32);
#pragma unroll
    for (int s = 0; s < SM90_STAGES; ++s) {
      hopper::mbar_init(&sm.q_full[s], 1);
      hopper::mbar_init(&sm.q_empty[s], SM90_CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_kt = (S + SM90_BN - 1) / SM90_BN;
  const int n_qt = (S + SM90_BM - 1) / SM90_BM;
  const int rep = H / KH;
  const int first = work[blockIdx.x], last = work[blockIdx.x + 1];
  const int* items = work + gridDim.x + 1;

  if (tid >= SM90_CONSUMERS) {  // the producer warpgroup
    hopper::reg_dealloc<sm90_producer_regs(D)>();
    if (tid == SM90_CONSUMERS) {
      int stage = 0;
      uint32_t q_par = 1, kv_par = 1;  // empty barriers: the first waits pass
      for (int w = first; w < last; ++w) {
        const int bkh = items[w] / n_kt, kv0 = items[w] % n_kt * SM90_BN;
        const int b = bkh / KH, kh = bkh % KH;
        const int qt0 = causal ? kv0 / SM90_BM : 0, nq = n_qt - qt0;
        hopper::mbar_wait(&sm.kv_empty, kv_par);
        kv_par ^= 1;
        hopper::mbar_arrive_expect_tx(&sm.kv_full, KV_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_3d(sm.k[c], &tm_k, &sm.kv_full, 64 * c, kv0, bkh);
          hopper::tma_load_3d(sm.v[c], &tm_v, &sm.kv_full, 64 * c, kv0, bkh);
        }
        for (int it = 0; it < rep * nq; ++it) {
          const int bh = b * H + kh * rep + it / nq;
          const int q0 = (qt0 + it % nq) * SM90_BM;
          hopper::mbar_wait(&sm.q_empty[stage], q_par);
          hopper::mbar_arrive_expect_tx(&sm.q_full[stage], Q_BYTES);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            hopper::tma_load_3d(sm.q[stage][c], &tm_q, &sm.q_full[stage],
                                64 * c, q0, bh);
            hopper::tma_load_3d(sm.dout[stage][c], &tm_do, &sm.q_full[stage],
                                64 * c, q0, bh);
          }
          const int64_t row = static_cast<int64_t>(bh) * S_pad + q0;
          hopper::bulk_load(sm.lse2[stage], lse2 + row, SM90_BM * 4,
                            &sm.q_full[stage]);
          hopper::bulk_load(sm.delta[stage], delta + row, SM90_BM * 4,
                            &sm.q_full[stage]);
          if (++stage == SM90_STAGES) {
            stage = 0;
            q_par ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 kv rows each
    hopper::reg_alloc<sm90_consumer_regs(D)>();
    const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const float sl2 = scale * kLog2e;
    const uint32_t k_s = hopper::smem_u32(&sm.k[0][64 * wg][0]);
    const uint32_t v_s = hopper::smem_u32(&sm.v[0][64 * wg][0]);
    int stage = 0;
    uint32_t q_par = 0, kv_par = 0;
    for (int w = first; w < last; ++w) {
      const int bkh = items[w] / n_kt, kv0 = items[w] % n_kt * SM90_BN;
      const int qt0 = causal ? kv0 / SM90_BM : 0, nq = n_qt - qt0;
      const int r_lo = kv0 + 64 * wg;          // this warpgroup's first row
      const int row0 = r_lo + 16 * warp + g;   // this thread's: row0, row0 + 8
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      hopper::mbar_wait(&sm.kv_full, kv_par);
      kv_par ^= 1;
      for (int it = 0; it < rep * nq; ++it) {
        const int q0 = (qt0 + it % nq) * SM90_BM;
        hopper::mbar_wait(&sm.q_full[stage], q_par);
        if (!causal || q0 + SM90_BM - 1 >= r_lo) {
          const uint32_t q_s = hopper::smem_u32(sm.q[stage][0]);
          const uint32_t do_s = hopper::smem_u32(sm.dout[stage][0]);
          const float* ls = sm.lse2[stage];
          const float* dl = sm.delta[stage];
          // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 queries
          float st[32], dpt[32];
          hopper::wgmma_fence();
          wgmma_ss<D>(st, k_s, KV_BOX, q_s, Q_BOX);
          hopper::wgmma_commit();
          wgmma_ss<D>(dpt, v_s, KV_BOX, do_s, Q_BOX);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          hopper::fence_operand(st);
          // P^T = exp2(S^T * scale * log2(e) - lse2[query]); padded
          // queries have lse2 = +inf
          const bool mask = causal && r_lo + 63 > q0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j +
                                                               2 * qd);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = 8 * j + 2 * qd + (i & 1);
              float p = hopper::exp2_ftz(st[4 * j + i] * sl2 -
                                         (i & 1 ? l.y : l.x));
              if (mask && row0 + 8 * (i >> 1) > q0 + c) p = 0.f;
              st[4 * j + i] = p;
            }
          }
          uint32_t pa[4][4], da[4][4];
          acc_to_a(st, pa);
          hopper::wgmma_wait<0>();
          hopper::fence_operand(dpt);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j +
                                                               2 * qd);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dpt[4 * j + i] =
                  st[4 * j + i] * (dpt[4 * j + i] - (i & 1 ? d.y : d.x)) *
                  scale;
          }
          acc_to_a(dpt, da);
          // dV += P^T dO, dK += dS^T Q: the tiles MN-major
          hopper::fence_operand(dv_acc);
          hopper::fence_operand(dk_acc);
          hopper::wgmma_fence();
          wgmma_rs<D>(dv_acc, pa, do_s, Q_BOX);
          wgmma_rs<D>(dk_acc, da, q_s, Q_BOX);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_operand(dv_acc);
          hopper::fence_operand(dk_acc);
        }
        hopper::mbar_arrive_warp(&sm.q_empty[stage]);
        if (++stage == SM90_STAGES) {
          stage = 0;
          q_par ^= 1;
        }
      }
      hopper::mbar_arrive_warp(&sm.kv_empty);  // K and V reloaded meanwhile
      const int64_t off = static_cast<int64_t>(bkh) * S * D;
      store_rows<D>(dk + off, dk_acc, row0, S, qd);
      store_rows<D>(dv + off, dv_acc, row0, S, qd);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta,
                         const int* __restrict__ work, bf16* __restrict__ dq,
                         int H, int KH, int S, int S_pad, float scale,
                         int causal) {
  using Smem = DqSmem<D>;
  constexpr int NB = Smem::NB;
  constexpr uint32_t Q_BOX = SM90_DQ_BM * 128, KV_BOX = SM90_DQ_BN * 128;
  constexpr uint32_t Q_BYTES = 2 * NB * Q_BOX + 2 * SM90_DQ_BM * 4;
  constexpr uint32_t KV_BYTES = 2 * NB * KV_BOX;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init(&sm.q_empty, SM90_CONSUMERS / 32);
#pragma unroll
    for (int s = 0; s < SM90_STAGES; ++s) {
      hopper::mbar_init(&sm.kv_full[s], 1);
      hopper::mbar_init(&sm.kv_empty[s], SM90_CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_qt = (S + SM90_DQ_BM - 1) / SM90_DQ_BM;
  const int rep = H / KH;
  const int first = work[blockIdx.x], last = work[blockIdx.x + 1];
  const int* items = work + gridDim.x + 1;
  // kv tiles a query tile walks: up to its last row if causal
  auto n_kv = [&](int q0) {
    return ((causal ? min(S, q0 + SM90_DQ_BM) : S) + SM90_DQ_BN - 1) /
           SM90_DQ_BN;
  };

  if (tid >= SM90_CONSUMERS) {  // the producer warpgroup
    hopper::reg_dealloc<sm90_producer_regs(D)>();
    if (tid == SM90_CONSUMERS) {
      int stage = 0;
      uint32_t kv_par = 1, q_par = 1;
      for (int w = first; w < last; ++w) {
        const int bh = items[w] / n_qt, q0 = items[w] % n_qt * SM90_DQ_BM;
        const int bkh = bh / H * KH + bh % H / rep;
        hopper::mbar_wait(&sm.q_empty, q_par);
        q_par ^= 1;
        hopper::mbar_arrive_expect_tx(&sm.q_full, Q_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_3d(sm.q[c], &tm_q, &sm.q_full, 64 * c, q0, bh);
          hopper::tma_load_3d(sm.dout[c], &tm_do, &sm.q_full, 64 * c, q0, bh);
        }
        const int64_t row = static_cast<int64_t>(bh) * S_pad + q0;
        hopper::bulk_load(sm.lse2, lse2 + row, SM90_DQ_BM * 4, &sm.q_full);
        hopper::bulk_load(sm.delta, delta + row, SM90_DQ_BM * 4, &sm.q_full);
        const int nk = n_kv(q0);
        for (int j = 0; j < nk; ++j) {
          hopper::mbar_wait(&sm.kv_empty[stage], kv_par);
          hopper::mbar_arrive_expect_tx(&sm.kv_full[stage], KV_BYTES);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            hopper::tma_load_3d(sm.k[stage][c], &tm_k, &sm.kv_full[stage],
                                64 * c, j * SM90_DQ_BN, bkh);
            hopper::tma_load_3d(sm.v[stage][c], &tm_v, &sm.kv_full[stage],
                                64 * c, j * SM90_DQ_BN, bkh);
          }
          if (++stage == SM90_STAGES) {
            stage = 0;
            kv_par ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 query rows each
    hopper::reg_alloc<sm90_consumer_regs(D)>();
    const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const float sl2 = scale * kLog2e;
    const uint32_t q_s = hopper::smem_u32(&sm.q[0][64 * wg][0]);
    const uint32_t do_s = hopper::smem_u32(&sm.dout[0][64 * wg][0]);
    int stage = 0;
    uint32_t kv_par = 0, q_par = 0;
    for (int w = first; w < last; ++w) {
      const int bh = items[w] / n_qt, q0 = items[w] % n_qt * SM90_DQ_BM;
      const int r_lo = q0 + 64 * wg;          // this warpgroup's first row
      const int row0 = r_lo + 16 * warp + g;  // this thread's: row0, row0 + 8
      hopper::mbar_wait(&sm.q_full, q_par);
      q_par ^= 1;
      float lr[2], dl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lr[h] = sm.lse2[row0 - q0 + 8 * h];
        dl[h] = sm.delta[row0 - q0 + 8 * h];
      }
      float dq_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
      constexpr int BN = SM90_DQ_BN;
      const int nk = n_kv(q0);
      int pending = -1;  // the stage whose dQ product is in flight
      for (int j = 0; j < nk; ++j) {
        const int k0 = j * BN;
        hopper::mbar_wait(&sm.kv_full[stage], kv_par);
        if (!causal || k0 <= r_lo + 63) {
          const uint32_t k_s = hopper::smem_u32(sm.k[stage][0]);
          const uint32_t v_s = hopper::smem_u32(sm.v[stage][0]);
          // S = Q K^T and dP = dO V^T: 64 queries x BN kv rows
          float s[BN / 2], dp[BN / 2];
          hopper::wgmma_fence();
          wgmma_ss<D>(s, q_s, Q_BOX, k_s, KV_BOX);
          hopper::wgmma_commit();
          wgmma_ss<D>(dp, do_s, Q_BOX, v_s, KV_BOX);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // and the previous tile's dQ
          hopper::fence_operand(s);
          if (pending >= 0) hopper::mbar_arrive_warp(&sm.kv_empty[pending]);
          const bool mask = (causal && k0 + BN - 1 > r_lo) || k0 + BN > S;
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = k0 + 8 * jj + 2 * qd + (i & 1);
              const int row = row0 + 8 * (i >> 1);
              float p = hopper::exp2_ftz(s[4 * jj + i] * sl2 - lr[i >> 1]);
              if (mask && (col >= S || (causal && col > row))) p = 0.f;
              s[4 * jj + i] = p;
            }
          hopper::wgmma_wait<0>();
          hopper::fence_operand(dp);
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dp[4 * jj + i] =
                  s[4 * jj + i] * (dp[4 * jj + i] - dl[i >> 1]) * scale;
          uint32_t da[4][4];
          acc_to_a(dp, da);
          // dQ += dS K: K MN-major
          hopper::fence_operand(dq_acc);
          hopper::wgmma_fence();
          wgmma_rs<D>(dq_acc, da, k_s, KV_BOX);
          hopper::wgmma_commit();  // waited for in the next tile
          pending = stage;
        } else {
          hopper::mbar_arrive_warp(&sm.kv_empty[stage]);
        }
        if (++stage == SM90_STAGES) {
          stage = 0;
          kv_par ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dq_acc);
      if (pending >= 0) hopper::mbar_arrive_warp(&sm.kv_empty[pending]);
      hopper::mbar_arrive_warp(&sm.q_empty);  // the next Q, dO load meanwhile
      store_rows<D>(dq + static_cast<int64_t>(bh) * S * D, dq_acc, row0, S,
                    qd);
    }
  }
}

template <int D>
cudaError_t launch_bwd_sm90(const Args& a) {
  if (a.dkdv_work == nullptr || a.dq_work == nullptr ||
      a.dkdv_programs <= 0 || a.dq_programs <= 0)
    return cudaErrorInvalidValue;
  using SK = DkdvSmem<D>;
  using SQ = DqSmem<D>;
  constexpr size_t smem_kv = sm90_smem_bytes<SK>();
  constexpr size_t smem_q = sm90_smem_bytes<SQ>();
  auto dkdv = flash_bwd_dkdv_sm90_kernel<D>;
  auto dqk = flash_bwd_dq_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H, BKH = a.B * a.KH;
  CUtensorMap q_kv, do_kv, k_kv, v_kv, q_q, do_q, k_q, v_q;
  const struct {
    CUtensorMap* map;
    const void* base;
    int n, rows;
  } maps[8] = {{&q_kv, a.q, BH, SM90_BM},      {&do_kv, a.dout, BH, SM90_BM},
               {&k_kv, a.k, BKH, SM90_BN},     {&v_kv, a.v, BKH, SM90_BN},
               {&q_q, a.q, BH, SM90_DQ_BM},    {&do_q, a.dout, BH, SM90_DQ_BM},
               {&k_q, a.k, BKH, SM90_DQ_BN},   {&v_q, a.v, BKH, SM90_DQ_BN}};
  for (const auto& m : maps)
    if ((err = hopper::bf16_tile_map(m.map, m.base, D, a.S, m.n, m.rows)) !=
        cudaSuccess)
      return err;
  const int S_pad = (a.S + SM90_PAD - 1) / SM90_PAD * SM90_PAD;
  const int64_t rows = static_cast<int64_t>(BH) * S_pad;
  float* delta = a.delta;
  float* lse2 = a.delta + rows;
  constexpr int rows_a_block = 256 / prep_threads_a_row(D);
  flash_bwd_prep_bf16_kernel<D>
      <<<(rows + rows_a_block - 1) / rows_a_block, 256, 0, a.stream>>>(
          static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
          a.lse, delta, lse2, a.S, S_pad, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<a.dkdv_programs, SM90_THREADS, smem_kv, a.stream>>>(
      q_kv, do_kv, k_kv, v_kv, lse2, delta, a.dkdv_work,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.KH, a.S,
      S_pad, a.scale, a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<a.dq_programs, SM90_THREADS, smem_q, a.stream>>>(
      q_q, do_q, k_q, v_q, lse2, delta, a.dq_work, static_cast<bf16*>(a.dq),
      a.H, a.KH, a.S, S_pad, a.scale, a.causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------ dispatch --

using Launch = cudaError_t (*)(const Args&);

cudaError_t dispatch(const Launch (&by_d)[5], const Args& a, int D) {
  if (a.B <= 0 || a.H <= 0 || a.KH <= 0 || a.S <= 0 || a.H % a.KH != 0)
    return cudaErrorInvalidValue;
  const int i = D == 16    ? 0
                : D == 32  ? 1
                : D == 64  ? 2
                : D == 80  ? 3
                : D == 128 ? 4
                           : -1;
  if (i < 0) return cudaErrorInvalidValue;
  return by_d[i](a);
}

constexpr Launch kBf16[5] = {launch_bf16<16>, launch_bf16<32>, launch_bf16<64>,
                             launch_bf16<80>, launch_bf16<128>};
constexpr Launch kF32[5] = {launch_f32<16>, launch_f32<32>, launch_f32<64>,
                            launch_f32<80>, launch_f32<128>};
constexpr Launch kBwdBf16[5] = {launch_bwd_bf16<16>, launch_bwd_bf16<32>,
                                launch_bwd_bf16<64>, launch_bwd_bf16<80>,
                                launch_bwd_bf16<128>};
constexpr Launch kBwdF32[5] = {launch_bwd_f32<16>, launch_bwd_f32<32>,
                               launch_bwd_f32<64>, launch_bwd_f32<80>,
                               launch_bwd_f32<128>};

Args fwd_args(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int KH, int S, float scale, int causal,
              void* stream) {
  return Args{q, k, v, nullptr, o, nullptr, nullptr, nullptr,
              static_cast<float*>(lse), nullptr, B, H, KH, S, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

Args bwd_args(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* delta, void* dq,
              void* dk, void* dv, int B, int H, int KH, int S, float scale,
              int causal, void* stream) {
  return Args{q, k, v, dout, const_cast<void*>(o), dq, dk, dv,
              static_cast<float*>(const_cast<void*>(lse)),
              static_cast<float*>(delta), B, H, KH, S, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// bf16 q, k, v, o on the tensor cores; lse (B, H, S) f32, or null to skip
// it. Returns a cudaError_t (0 = success).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int KH, int S,
                             int D, float scale, int causal, void* stream) {
  if ((S + TC_BM - 1) / TC_BM > 65535) return cudaErrorInvalidValue;
  return dispatch(kBf16, fwd_args(q, k, v, o, lse, B, H, KH, S, scale, causal,
                                  stream), D);
}

// f32 q, k, v, o on the CUDA cores; lse as above. Returns a cudaError_t.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int KH, int S,
                            int D, float scale, int causal, void* stream) {
  if (B * H > 65535) return cudaErrorInvalidValue;
  return dispatch(kF32, fwd_args(q, k, v, o, lse, B, H, KH, S, scale, causal,
                                 stream), D);
}

// The backward of a bf16 call on the mma.sync kernels: dq (B, H, S, D),
// dk and dv (B, KH, S, D), from q, k, v, o, the forward's lse and dout;
// delta is an f32 scratch of B * H * S. Three launches. Returns a
// cudaError_t (0 = success).
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* lse, const void* dout,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int H, int KH, int S, int D, float scale,
                             int causal, void* stream) {
  if ((S + TC_BM - 1) / TC_BM > 65535) return cudaErrorInvalidValue;
  return dispatch(kBwdBf16, bwd_args(q, k, v, o, lse, dout, delta, dq, dk, dv,
                                     B, H, KH, S, scale, causal, stream), D);
}

// The same on the wgmma kernels, at head_dim 64, 80 and 128 only: delta is an
// f32 scratch of 2 * B * H * S_pad (S_pad: S rounded up to 128), and the
// persistent grids walk the work lists (int32 [starts (programs + 1) |
// items]). Three launches. Returns a cudaError_t.
int flash_attention_bwd_bf16_sm90(const void* q, const void* k, const void* v,
                                  const void* o, const void* lse,
                                  const void* dout, void* delta, void* dq,
                                  void* dk, void* dv, int B, int H, int KH,
                                  int S, int D, float scale, int causal,
                                  const int* dkdv_work, int dkdv_programs,
                                  const int* dq_work, int dq_programs,
                                  void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH != 0)
    return cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KH, S,
                    scale, causal, stream);
  a.dkdv_work = dkdv_work;
  a.dq_work = dq_work;
  a.dkdv_programs = dkdv_programs;
  a.dq_programs = dq_programs;
  return D == 64    ? launch_bwd_sm90<64>(a)
         : D == 80  ? launch_bwd_sm90<80>(a)
         : D == 128 ? launch_bwd_sm90<128>(a)
                    : cudaErrorInvalidValue;
}

// The same for an f32 call, on the CUDA cores. Returns a cudaError_t.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int H, int KH, int S, int D, float scale,
                            int causal, void* stream) {
  if (B * H > 65535) return cudaErrorInvalidValue;
  return dispatch(kBwdF32, bwd_args(q, k, v, o, lse, dout, delta, dq, dk, dv,
                                    B, H, KH, S, scale, causal, stream), D);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
