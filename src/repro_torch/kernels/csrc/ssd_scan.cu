// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py
// (launched by `ssd_scan` there over the grid of `ssd_layout`), and also
// returns the final state, as `ssd_scan_jnp(..., return_state=True)` does.
// Per chunk of L steps, with seg_t = sum_{u<=t} dt_u A (A = -exp(a_log)):
//   y_t = sum_{s<=t} (C_t.B_s) exp(seg_t - seg_s) dt_s x_s
//         + exp(seg_t) C_t.h + D x_t
//   h   = exp(seg_L) h + sum_t exp(seg_L - seg_t) dt_t B_t (x) x_t
//
// What bounds it on the H100: at the serve shape (B 4, S 512, H 64, P 64,
// N 128, chunk 128) the function moves ~78 MB (x in, y out, the state out)
// and needs ~5.4 GFLOP, so the 67 TFLOP/s f32 rate bounds it (~0.08 ms)
// before the 3.35 TB/s of memory does (~0.02 ms). This first kernel runs
// scalar f32 FMAs on the CUDA cores and recomputes C.B^T for every head,
// so it sits several times above that bound; tensor-core products and a
// C.B^T shared across heads are later work. What the design does:
// - one block per (b, h); a loop over chunks inside the block replaces
//   the TPU grid's sequential chunk axis, and the (N, P) f32 state stays in
//   shared memory for the whole sequence;
// - B and C are read by batch index and dt, a_log, d_skip per head, with
//   none of the TPU wrapper's per-head copies or 128-lane replication; x
//   and y keep their (B, S, H, P) layout;
// - the 4 products of a chunk are shared-memory GEMMs with 4x4 (scores) or
//   4x2 (P-wide) register tiles, so one shared-memory read feeds two to
//   four FMAs; row pitches of N + 1 keep the column reads of B and C free
//   of bank conflicts;
// - the causal score tile is built in strips of 32 rows (the full 128x128
//   tile would take shared memory over the 227 KB a block may have);
//   exp(seg_t - seg_s), which overflows for t < s, is evaluated only under
//   the causal mask, and masked entries are selected to 0, never
//   multiplied (inf * 0 = NaN);
// - a ragged last chunk (S % chunk != 0) runs its true length: steps past
//   S would carry dt = 0 (decay 1, no input), so the final state is exact.
//
// Layout: x, y (B, S, H, P); dt (B, S, H); b, c (B, S, N); a_log, d_skip
// (H,); h_out (B, H, N, P) or null. All f32 and contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 32;  // threads along the columns of a register tile
constexpr int TY = 8;   // threads along its rows; 4 rows each -> 32 rows
constexpr int R = 32;   // rows of C and of the score strip per pass

__host__ __device__ inline size_t smem_floats(int L, int P, int N) {
  return static_cast<size_t>(N) * P       // h
         + static_cast<size_t>(L) * (N + 1)  // B chunk
         + static_cast<size_t>(L) * P        // x chunk
         + static_cast<size_t>(R) * (N + 1)  // C strip
         + static_cast<size_t>(R) * L        // score strip
         + 3 * static_cast<size_t>(L);       // seg, dt, exp(seg_L - seg) dt
}

__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ d_skip,
                float* __restrict__ y, float* __restrict__ h_out, int S, int H,
                int P, int N, int L) {
  extern __shared__ float smem[];
  float* h_s = smem;                  // N x P
  float* b_s = h_s + N * P;           // L x (N + 1)
  float* x_s = b_s + L * (N + 1);     // L x P
  float* c_s = x_s + L * P;           // R x (N + 1)
  float* s_s = c_s + R * (N + 1);     // R x L
  float* seg_s = s_s + R * L;         // L
  float* dt_s = seg_s + L;            // L
  float* w_s = dt_s + L;              // L

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float A = -expf(a_log[h]);
  const float Dh = d_skip[h];
  const int64_t x_step = static_cast<int64_t>(H) * P;  // one step t of x, y
  const float* xb = x + static_cast<int64_t>(b) * S * x_step +
                    static_cast<int64_t>(h) * P;
  float* yb = y + static_cast<int64_t>(b) * S * x_step +
              static_cast<int64_t>(h) * P;
  const float* dtb = dt + static_cast<int64_t>(b) * S * H + h;
  const float* bb = bm + static_cast<int64_t>(b) * S * N;
  const float* cb = cm + static_cast<int64_t>(b) * S * N;

  for (int e = tid; e < N * P; e += THREADS) h_s[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lc = min(L, S - t0);
    __syncthreads();  // the previous chunk is done with b_s, x_s, w_s, h_s
    for (int e = tid; e < Lc * P; e += THREADS) {
      const int t = e / P, p = e % P;
      x_s[t * P + p] = xb[(t0 + t) * x_step + p];
    }
    for (int e = tid; e < Lc * N; e += THREADS) {
      const int t = e / N, n = e % N;
      b_s[t * (N + 1) + n] = bb[static_cast<int64_t>(t0 + t) * N + n];
    }
    for (int t = tid; t < Lc; t += THREADS)
      dt_s[t] = dtb[static_cast<int64_t>(t0 + t) * H];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < Lc; ++t) {
        acc += dt_s[t] * A;
        seg_s[t] = acc;
      }
    }
    __syncthreads();
    const float total = seg_s[Lc - 1];
    for (int t = tid; t < Lc; t += THREADS)
      w_s[t] = expf(total - seg_s[t]) * dt_s[t];  // <= dt: total <= seg_t

    for (int r0 = 0; r0 < Lc; r0 += R) {
      const int Rc = min(R, Lc - r0);
      const int Sc = r0 + Rc;  // score columns s < Sc can be unmasked
      for (int e = tid; e < Rc * N; e += THREADS) {
        const int r = e / N, n = e % N;
        c_s[r * (N + 1) + n] = cb[static_cast<int64_t>(t0 + r0 + r) * N + n];
      }
      __syncthreads();

      // score strip: s_s[r][s] = (C_{r0+r} . B_s) exp(seg_{r0+r} - seg_s) dt_s
      // for s <= r0 + r, else 0. Out-of-range rows and columns are clamped
      // to valid ones for the reads and never stored.
      for (int s0 = 0; s0 < Sc; s0 += 4 * TX) {
        int rows[4], cols[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rows[i] = min(ty + TY * i, Rc - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) cols[j] = min(s0 + tx + TX * j, Sc - 1);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = c_s[rows[i] * (N + 1) + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b_s[cols[j] * (N + 1) + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + TY * i, t = r0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + TX * j;
            if (r < Rc && s < Sc)
              s_s[r * L + s] =
                  s <= t ? acc[i][j] * expf(seg_s[t] - seg_s[s]) * dt_s[s] : 0.f;
          }
        }
      }
      __syncthreads();

      // y rows of the strip: scores . x + exp(seg_t) (C_t . h) + D x_t
      for (int p0 = 0; p0 < P; p0 += 2 * TX) {
        int rows[4], cols[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) rows[i] = min(ty + TY * i, Rc - 1);
#pragma unroll
        for (int j = 0; j < 2; ++j) cols[j] = min(p0 + tx + TX * j, P - 1);
        float ya[4][2], yc[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) ya[i][j] = yc[i][j] = 0.f;
#pragma unroll 4
        for (int s = 0; s < Sc; ++s) {
          float av[4], bv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = s_s[rows[i] * L + s];
#pragma unroll
          for (int j = 0; j < 2; ++j) bv[j] = x_s[s * P + cols[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) ya[i][j] = fmaf(av[i], bv[j], ya[i][j]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float av[4], bv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = c_s[rows[i] * (N + 1) + n];
#pragma unroll
          for (int j = 0; j < 2; ++j) bv[j] = h_s[n * P + cols[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) yc[i][j] = fmaf(av[i], bv[j], yc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + TY * i, t = r0 + r;
          if (r >= Rc) continue;
          const float et = expf(seg_s[t]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = p0 + tx + TX * j;
            if (p < P)
              yb[(t0 + t) * x_step + p] =
                  ya[i][j] + et * yc[i][j] + Dh * x_s[t * P + p];
          }
        }
      }
      __syncthreads();  // c_s and s_s are rewritten by the next strip
    }

    // state: h = exp(seg_L) h + sum_t (B_t w_t) (x) x_t; every (n, p) is
    // owned by one thread, which alone reads and writes it here
    const float decay = expf(total);
    for (int n0 = 0; n0 < N; n0 += 4 * TY) {
      for (int p0 = 0; p0 < P; p0 += 2 * TX) {
        int rows[4], cols[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) rows[i] = min(n0 + ty + TY * i, N - 1);
#pragma unroll
        for (int j = 0; j < 2; ++j) cols[j] = min(p0 + tx + TX * j, P - 1);
        float acc[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int t = 0; t < Lc; ++t) {
          const float wt = w_s[t];
          float av[4], bv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = b_s[t * (N + 1) + rows[i]] * wt;
#pragma unroll
          for (int j = 0; j < 2; ++j) bv[j] = x_s[t * P + cols[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + ty + TY * i;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = p0 + tx + TX * j;
            if (p < P) h_s[n * P + p] = decay * h_s[n * P + p] + acc[i][j];
          }
        }
      }
    }
  }

  if (h_out != nullptr) {
    __syncthreads();
    float* hb = h_out + static_cast<int64_t>(bh) * N * P;
    for (int e = tid; e < N * P; e += THREADS) hb[e] = h_s[e];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks them
// against the card's limit before launching).
size_t ssd_scan_smem_bytes(int chunk, int P, int N) {
  return sizeof(float) * smem_floats(chunk, P, N);
}

// h_out may be null (no final state). Returns a cudaError_t (0 = success).
int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                 const void* bm, const void* cm, const void* d_skip, void* y,
                 void* h_out, int B, int S, int H, int P, int N, int chunk,
                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S;
  const size_t smem = sizeof(float) * smem_floats(L, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<<<B * H, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(d_skip),
      static_cast<float*>(y), static_cast<float*>(h_out), S, H, P, N, L);
  return cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
