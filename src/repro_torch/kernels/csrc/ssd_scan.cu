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
// and needs 4.87 GFLOP of products. It must hold f32 accuracy (2e-4
// relative), so the products run in 3xTF32 on the TF32 tensor cores:
// each operand is split into hi (a rounded to tf32) and lo = a - hi, and
// hi.hi + hi.lo + lo.hi accumulate in f32 (plain TF32 errs by ~1e-3 on a
// 128-term C.B^T; mma.cuh has the split). That is 495 / 3 = 165 TFLOP/s, 0.0295 ms for the work,
// above the 0.0233 ms that its bytes take at 3.35 TB/s.
//
// Two launches:
// (a) ssd_cb_kernel, a block per (chunk, b, 16 x 32 tile on or below the
//     diagonal): the causal half of C.B^T, once per (b, chunk) for all H
//     heads, into an f32 scratch that the wrapper allocates (1 MB at the
//     serve shape, read from L2 by the 64 heads).
// (b) ssd_scan_kernel, one block of 8 warps per (b, h), looping over the
//     chunks (the TPU grid's sequential chunk axis):
//     - the next chunk's x (16-byte cp.async) and dt arrive in a second
//       shared-memory stage while the current chunk computes;
//     - the in-chunk cumsum of dt A is a warp-level parallel scan;
//     - the per-head products are m16n8k8 3xTF32 mma.sync: scores.x with
//       scores = CB (x) exp(seg_t - seg_s) dt_s built in registers as A
//       fragments (k-steps past a row tile's diagonal are skipped), plus
//       (exp(seg_t) C).h into the same accumulator, and (B (x) w)^T.x for
//       the state, where w_t = exp(seg_L - seg_t) dt_t;
//     - each warp owns 16-row x 64-column output tiles (all of P = 64), so
//       each A fragment is built once, and runs each 3xTF32 pass over the
//       8 n-tiles of its tile, so 8 independent products separate two
//       dependent ones;
//     - C, B and CB rows are read straight from L2 as A fragments (each
//       element by one warp); x and the (N, P) f32 state are the B
//       operands in shared memory, row pitch P + 4 floats. 2 x L x (P + 4)
//       + N x (P + 4) floats: 104 KB at the serve shape, so 2 blocks per
//       SM and the 256 (b, h) blocks in one wave.
//     Kept from the first kernel: exp(seg_t - seg_s), which overflows for
//     t < s, is evaluated only under the causal mask, and masked entries
//     are selected to 0, never multiplied (inf * 0 = NaN); a ragged last
//     chunk (S % chunk != 0) runs its true length (steps past S would
//     carry dt = 0: decay 1, no input), with padded rows and columns
//     zero-filled; B and C are read by batch index, dt, a_log and d_skip
//     per head, with none of the TPU wrapper's per-head copies or 128-lane
//     replication; x and y keep their (B, S, H, P) layout.
//
// Layout: x, y (B, S, H, P); dt (B, S, H); b, c (B, S, N); a_log, d_skip
// (H,); cb scratch (B, n_chunks, L, ssd_cb_pitch(L)); h_out (B, H, N, P) or
// null; states (B, n_chunks, H, N, P), the state entering each chunk, or
// null. All f32 and contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// row pitch of the cb scratch: even, so a pair of columns is one 8-byte load
__host__ __device__ inline int cb_pitch(int L) { return round_up(L, 2); }

// shared memory of the scan: x in 2 stages (Lp x pitch), the state
// (Nr x pitch), dt in 2 stages, seg and w. The pitch, P + 4 floats, puts
// the rows 2q and 2q + 1 that a fragment read pairs (below) on distinct
// banks.
__host__ __device__ inline size_t scan_smem_floats(int L, int P, int N) {
  const size_t Lp = round_up(L, 16), pitch = round_up(P, 8) + 4;
  return 2 * Lp * pitch + static_cast<size_t>(round_up(N, 16)) * pitch +
         4 * Lp;
}

// p[0], p[1], zero past `avail` valid elements; one 8-byte load when vec
__device__ __forceinline__ float2 ld2(const float* p, int avail, bool vec) {
  if (avail >= 2 && vec) return *reinterpret_cast<const float2*>(p);
  return make_float2(avail > 0 ? p[0] : 0.f, avail > 1 ? p[1] : 0.f);
}

// Every product below permutes its k index inside each group of 8: the
// fragment's k = q and k = q + 4 (PTX layout, see mma.cuh) are taken from
// the neighbouring columns 2q and 2q + 1 of the operands in memory, for A
// and B alike, which leaves the sum unchanged and makes each lane's two A
// elements one 8-byte load.

// seg = inclusive cumsum of dt A over a chunk's Lc steps, by one warp:
// each lane sums a run of steps, a warp scan of the run totals gives each
// run its offset
__device__ __forceinline__ void chunk_seg(const float* dts, float A, int Lc,
                                          float* seg) {
  const int lane = threadIdx.x % 32;
  const int per = (Lc + 31) / 32;
  const int lo = min(lane * per, Lc), hi = min(lo + per, Lc);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) run += dts[t] * A;
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  float acc = inc - run;
  for (int t = lo; t < hi; ++t) {
    acc += dts[t] * A;
    seg[t] = acc;
  }
}

// (a) cb[b, c, t, s] = C_t . B_s for s <= t < Lc; nothing else is written
// (or read by the scan). One block of 4 warps per (chunk, b, 16 x 32
// output tile on or below the diagonal); the 4 warps split the N-long
// sum (k-steps w, w + 4, ...), so each warp waits on one round of loads,
// and add their partial tiles in shared memory.
constexpr int CB_WARPS = 4;

__global__ void __launch_bounds__(CB_WARPS * 32)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, int S, int N, int L, int vec) {
  __shared__ float part[CB_WARPS][16 * 32];
  const int c = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int t0 = c * L, Lc = min(L, S - t0), Lq = cb_pitch(L);
  const int nrt = (L + 15) / 16;
  const int r0 = (blockIdx.z % nrt) * 16, s0 = (blockIdx.z / nrt) * 32;
  if (r0 >= Lc || s0 > r0 + 15) return;  // past the chunk, above the diagonal
  const float* bb = bm + (static_cast<int64_t>(b) * S + t0) * N;
  const float* cc = cm + (static_cast<int64_t>(b) * S + t0) * N;
  float* out = cb + (static_cast<int64_t>(b) * n_chunks + c) * L * Lq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  auto ld = [&](const float* m, int row, int col) {
    return ld2(m + static_cast<int64_t>(row) * N + col,
               row < Lc ? N - col : 0, vec);
  };

  const int tA = r0 + g, tB = tA + 8;
  float acc[4][4] = {};
#pragma unroll 4
  for (int n0 = warp * 8; n0 < N; n0 += CB_WARPS * 8) {
    const int n = n0 + 2 * qd;
    const float2 cA = ld(cc, tA, n), cB = ld(cc, tB, n);
    float2 bv[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bv[nt] = ld(bb, s0 + nt * 8 + g, n);
    const mma::Split a[4] = {mma::split(cA.x), mma::split(cB.x),
                             mma::split(cA.y), mma::split(cB.y)};
    mma::Split b0[4], b1[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      b0[nt] = mma::split(bv[nt].x);
      b1[nt] = mma::split(bv[nt].y);
    }
    mma::mma_3xtf32(acc, a, b0, b1);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[warp][((i >> 1) * 8 + g) * 32 + nt * 8 + 2 * qd + (i & 1)] =
          acc[nt][i];
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * 32; e += CB_WARPS * 32) {
    const int t = r0 + e / 32, s = s0 + e % 32;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < CB_WARPS; ++w) v += part[w][e];
    if (s <= t && t < Lc) out[t * Lq + s] = v;
  }
}

// acc[nt] += a . b[nt] for JN n-tiles whose B fragments are read from two
// shared-memory rows (the pair 2q, 2q + 1 of a k-step), 8 columns apart
template <int JN>
__device__ __forceinline__ void mma_rows(float (&acc)[JN][4],
                                         const mma::Split (&a)[4],
                                         const float* row0, const float* row1) {
  mma::Split b0[JN], b1[JN];
#pragma unroll
  for (int nt = 0; nt < JN; ++nt) {
    b0[nt] = mma::split(row0[nt * 8]);
    b1[nt] = mma::split(row1[nt * 8]);
  }
  mma::mma_3xtf32(acc, a, b0, b1);
}

// (b) the scan of one (b, h) over all chunks; each warp job is 16 rows x
// JN n-tiles of 8 columns (JN divides round_up(P, 8) / 8, so no tile is
// partial)
template <int JN>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ cb,
                const float* __restrict__ d_skip, float* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ states, int S,
                int H, int P, int N, int L, int xvec, int nvec) {
  const int Lp = round_up(L, 16), Pp = round_up(P, 8), pitch = Pp + 4;
  const int Lq = cb_pitch(L);
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                    // 2 stages x Lp x pitch
  float* h_s = x_s + 2 * Lp * pitch;    // round_up(N, 16) x pitch
  float* dt_s = h_s + round_up(N, 16) * pitch;  // 2 stages x Lp
  float* seg_s = dt_s + 2 * Lp;         // Lp
  float* w_s = seg_s + Lp;              // Lp

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
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
  const float* ccb = cm + static_cast<int64_t>(b) * S * N;
  const int n_chunks = (S + L - 1) / L;
  const float* cbb = cb + static_cast<int64_t>(b) * n_chunks * L * Lq;

  // x and dt of chunk c into stage st, rows and columns past the chunk
  // and past P zero-filled
  auto load_chunk = [&](int c, int st) {
    const int t0 = c * L, Lc = min(L, S - t0);
    float* xd = x_s + st * Lp * pitch;
    if (xvec) {
      const int cpr = Pp / 4;
      for (int e = tid; e < Lp * cpr; e += THREADS) {
        const int r = e / cpr, p = (e % cpr) * 4;
        const bool ok = r < Lc && p < P;
        mma::cp_async16(xd + r * pitch + p,
                        xb + (ok ? (t0 + r) * x_step + p : 0), ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < Lp * Pp; e += THREADS) {
        const int r = e / Pp, p = e % Pp;
        const bool ok = r < Lc && p < P;
        mma::cp_async4(xd + r * pitch + p,
                       xb + (ok ? (t0 + r) * x_step + p : 0), ok ? 4 : 0);
      }
    }
    for (int t = tid; t < Lp; t += THREADS) {
      const bool ok = t < Lc;
      mma::cp_async4(dt_s + st * Lp + t,
                     dtb + (ok ? static_cast<int64_t>(t0 + t) * H : 0),
                     ok ? 4 : 0);
    }
    mma::cp_async_commit();
  };

  for (int e = tid; e < round_up(N, 16) * pitch; e += THREADS) h_s[e] = 0.f;
  load_chunk(0, 0);
  const int ncb = Pp / (8 * JN);  // column blocks of x, y and the state

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1, t0 = c * L, Lc = min(L, S - t0);
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, st ^ 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = x_s + st * Lp * pitch;
    const float* dts = dt_s + st * Lp;
    if (states != nullptr) {  // the state entering chunk c, for the backward
      float* sb = states + ((static_cast<int64_t>(b) * n_chunks + c) * H + h) *
                               static_cast<int64_t>(N) * P;
      for (int e = tid; e < N * P; e += THREADS)
        sb[e] = h_s[(e / P) * pitch + e % P];
    }

    if (warp == 0) chunk_seg(dts, A, Lc, seg_s);
    __syncthreads();
    const float total = seg_s[Lc - 1];
    for (int t = tid; t < Lp; t += THREADS)
      w_s[t] = t < Lc ? expf(total - seg_s[t]) * dts[t] : 0.f;  // <= dt

    // y = scores . x + (exp(seg_t) C_t) . h + D x: one 16-row x 64-column
    // tile per warp job, both products into one accumulator (the row scale
    // exp(seg_t) is folded into C's A fragments)
    const float* cbc = cbb + static_cast<int64_t>(c) * L * Lq;
    const float* cc = ccb + static_cast<int64_t>(t0) * N;
    const int nrt = (Lc + 15) / 16;
    for (int job = warp; job < nrt * ncb; job += NWARPS) {
      const int r0 = (job % nrt) * 16, p0 = (job / nrt) * 8 * JN;
      const int tA = r0 + g, tB = tA + 8;
      const float sgA = seg_s[tA], sgB = seg_s[tB];
      float acc[JN][4] = {};
      const int s_end = min(r0 + 16, Lc);
#pragma unroll 4
      for (int s0 = 0; s0 < s_end; s0 += 8) {
        const int s = s0 + 2 * qd;
        const float2 cA = ld2(cbc + tA * Lq + s, tA < Lc ? tA + 1 - s : 0,
                              true);
        const float2 cB = ld2(cbc + tB * Lq + s, tB < Lc ? tB + 1 - s : 0,
                              true);
        const float2 sg = *reinterpret_cast<const float2*>(seg_s + s);
        const float2 dv = *reinterpret_cast<const float2*>(dts + s);
        // causal: exp(seg_t - seg_s) only where s <= t (it overflows
        // above), masked entries selected to 0
        const bool ok0A = s <= tA && tA < Lc, ok1A = s + 1 <= tA && tA < Lc;
        const bool ok0B = s <= tB && tB < Lc, ok1B = s + 1 <= tB && tB < Lc;
        const mma::Split a[4] = {
            mma::split(ok0A ? cA.x * expf(sgA - sg.x) * dv.x : 0.f),
            mma::split(ok0B ? cB.x * expf(sgB - sg.x) * dv.x : 0.f),
            mma::split(ok1A ? cA.y * expf(sgA - sg.y) * dv.y : 0.f),
            mma::split(ok1B ? cB.y * expf(sgB - sg.y) * dv.y : 0.f)};
        mma_rows<JN>(acc, a, xs + s * pitch + p0 + g,
                     xs + (s + 1) * pitch + p0 + g);
      }
      if (c > 0) {  // the state entering the first chunk is zero
        const float eA = expf(sgA), eB = expf(sgB);
#pragma unroll 4
        for (int n0 = 0; n0 < N; n0 += 8) {
          const int n = n0 + 2 * qd;
          const float2 cA = ld2(cc + tA * N + n, tA < Lc ? N - n : 0, nvec);
          const float2 cB = ld2(cc + tB * N + n, tB < Lc ? N - n : 0, nvec);
          const mma::Split a[4] = {mma::split(eA * cA.x), mma::split(eB * cB.x),
                                   mma::split(eA * cA.y), mma::split(eB * cB.y)};
          mma_rows<JN>(acc, a, h_s + n * pitch + p0 + g,
                       h_s + (n + 1) * pitch + p0 + g);
        }
      }
#pragma unroll
      for (int nt = 0; nt < JN; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = i < 2 ? tA : tB;
          const int p = p0 + nt * 8 + 2 * qd + (i & 1);
          if (t < Lc && p < P)
            yb[(t0 + t) * x_step + p] = acc[nt][i] + Dh * xs[t * pitch + p];
        }
    }
    __syncthreads();  // every read of the state (C . h) is done

    // state: h = exp(seg_L) h + (B (x) w)^T . x, one 16 x 64 tile per job
    const float decay = expf(total);
    const float* bc = bb + static_cast<int64_t>(t0) * N;
    auto ldb = [&](int s, int n) {
      return s < Lc && n < N ? bc[s * N + n] : 0.f;
    };
    const int nnt = (N + 15) / 16;
    for (int job = warp; job < nnt * ncb; job += NWARPS) {
      const int n0 = (job % nnt) * 16, p0 = (job / nnt) * 8 * JN;
      const int nA = n0 + g, nB = nA + 8;
      float acc[JN][4] = {};
#pragma unroll 4
      for (int s0 = 0; s0 < Lc; s0 += 8) {
        const int s = s0 + 2 * qd;
        const float2 wv = *reinterpret_cast<const float2*>(w_s + s);
        const mma::Split a[4] = {mma::split(ldb(s, nA) * wv.x),
                                 mma::split(ldb(s, nB) * wv.x),
                                 mma::split(ldb(s + 1, nA) * wv.y),
                                 mma::split(ldb(s + 1, nB) * wv.y)};
        mma_rows<JN>(acc, a, xs + s * pitch + p0 + g,
                     xs + (s + 1) * pitch + p0 + g);
      }
#pragma unroll
      for (int nt = 0; nt < JN; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = i < 2 ? nA : nB;
          const int p = p0 + nt * 8 + 2 * qd + (i & 1);
          h_s[n * pitch + p] = decay * h_s[n * pitch + p] + acc[nt][i];
        }
    }
    __syncthreads();  // the state is complete; stage st may be refilled
  }

  if (h_out != nullptr) {
    float* hb = h_out + static_cast<int64_t>(bh) * N * P;
    for (int e = tid; e < N * P; e += THREADS)
      hb[e] = h_s[(e / P) * pitch + e % P];
  }
}

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }
bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t launch_cb(const void* bm, const void* cm, void* cb, int B, int S,
                      int N, int L, cudaStream_t stream) {
  const dim3 grid((S + L - 1) / L, B, ((L + 15) / 16) * ((L + 31) / 32));
  ssd_cb_kernel<<<grid, CB_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(cb), S, N, L,
      N % 2 == 0 && aligned8(bm) && aligned8(cm));
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward: dx, ddt, da_log, dB, dC and dD of y = SSD(x, dt, a_log, B,
// C, D) for an output gradient dy (and, where the forward returned it, a
// gradient dh_final of the final state). The TPU package has no kernel for
// it: its gradient is XLA's autodiff of `ssd_scan_jnp` under jax.grad.
// Per chunk, with M[t, s] = (C_t . B_s) exp(seg_t - seg_s) dt_s for s <= t
// and w_s = exp(seg_L - seg_s) dt_s, and dh the gradient of the state
// leaving the chunk:
//   dh_in = exp(seg_L) dh + sum_t exp(seg_t) C_t (x) dy_t      (reverse pass)
//   dx_s  = sum_t M[t, s] dy_t + w_s (B_s . dh) + D dy_s
//   GE[t, s] = (dy_t . x_s) exp(seg_t - seg_s), the score gradient
//   dC_t  = sum_s GE[t, s] dt_s B_s + exp(seg_t) dy_t . h_in^T
//   dB_s  = sum_t GE[t, s] dt_s C_t + w_s x_s . dh^T
// summed over the heads for dB and dC, and d(seg) from every term: its
// in-chunk reverse cumsum times A gives ddt beside the direct terms, and
// sum_t dt_t revcumsum_t times A gives da_log (A = -exp(a_log),
// dA/da_log = A).
//
// What bounds it on the H100: at mamba2-1.3b's train shape (B 2, S 4096,
// H 64, P 64, N 128, chunk 128) the function needs 42.3 GFLOP of products
// (per (b, h, chunk) G = dy . x^T and M^T . dy, L(L+1)/2 x P MACs each;
// B . dh, x . dh^T, dy . h_in^T and the local state gradient, L N P each
// where the state or its gradient is not zero; per (b, chunk) GE_sum . B,
// GE_sum^T . C and C . B^T, L(L+1)/2 x N each), in 3xTF32 (f32 accuracy,
// as the forward) 0.26 ms at 165 TFLOP/s, against 0.56 GB read and
// written once (x, dy, the chunk states in; dx out), 0.17 ms: bound by the
// products. The kernels below also form C . h_in per head, for d(seg),
// which dy . h_in^T could give; they take about 9x the bound on mma.sync
// (PERF.md §6), and wgmma's tf32 form is the next step.
//
// Six launches, each grid wide enough to fill the card:
// (a) ssd_cb_kernel, as the forward: C.B^T per (b, chunk).
// (b) ssd_bwd_local_kernel, a block per (chunk c >= 1, h, b): the chunk's
//     own part of the state gradient, local_c = (C o exp(seg))^T . dy, on
//     the tensor cores, into the state-gradient buffer's slot c - 1, and
//     the chunk's decay exp(seg_L).
// (c) ssd_bwd_pass_kernel: the state passing of Dao & Gu (2024, §7), in
//     reverse and elementwise only: dh_c = exp(seg_L of c + 1) dh_{c+1} +
//     local_{c+1}, a thread per element of (b, h, N x P), in place. This
//     replaces a walk of B x H blocks with a product on every step of the
//     chain.
// (d) ssd_bwd_chunk_kernel, a persistent grid of one 16-warp block an SM
//     over (b, chunk, group of BWD_GROUP heads): per head it stages x and
//     dy, then the state gradient and then the chunk's state, into shared
//     memory (float4 loads where rows of P allow), each element split into
//     TF32 hi / lo once as it is stored, and runs the products with them
//     (m16n8k8 3xTF32 mma.sync; C.B^T, B and C, shared by the heads, come
//     from L2 one k-step ahead): GE (its row and column sums against C.B^T
//     by warp shuffles into per-tile partials, summed in a fixed order),
//     dx = w (B . dh) + M^T . dy + D dy in one accumulator, C . h_in. GE
//     and dx share a phase, with no barrier between them, and the warps
//     with a second GE tile take the shortest M^T . dy. The per-step
//     vectors come from those partials, the
//     reverse cumsum of d(seg) from a warp scan (as the forward's seg), and
//     ddt, the chunk's dD and dA sums follow. dB and dC need GE summed over
//     the heads only as GE_sum[t, s] = sum_h dt_{h,s} GE_h[t, s]: each warp
//     keeps its GE tiles' sum over the group's heads in registers, in head
//     order, and the block writes one GE_sum partial a group (H / 8 of them,
//     not one dB and one dC a head).
// (e) ssd_bwd_dbdc_kernel, a block per (b, chunk, dB or dC, 64 x 64 output
//     tile): dB = GE_sum^T . C + [w x]_(h,p) . [dh^T]_(h,p) and dC = GE_sum .
//     B + [exp(seg) dy]_(h,p) . [h_in^T]_(h,p), one product each over the
//     chunk's steps and the H x P columns of every head, both operands
//     brought in by cp.async through a four-stage shared-memory ring (three
//     tiles in flight behind the one computing); the group partials are
//     summed in order as they are staged. Each output element is written
//     once, with no scratch per head.
// (f) ssd_bwd_reduce_kernel: dD and da_log summed over (b, chunk) in order.
// No float atomics, so two calls give the same bits. The forward's guards
// hold: exp(seg_t - seg_s) is evaluated only under the causal mask and
// masked entries are selected to 0; a ragged last chunk runs its true
// length; B and C are read by batch index; dh_final may be null.

// an operand element split into TF32 hi / lo (mma.cuh) as shared memory
// holds it
__device__ __forceinline__ mma::Split ld_split(const uint2& v) {
  return {v.x, v.y};
}

__device__ __forceinline__ uint2 to_split(float v) {
  const mma::Split s = mma::split(v);
  return make_uint2(s.hi, s.lo);
}

// the f32 value of a split element (hi + lo is exact)
__device__ __forceinline__ float split_value(const uint2& v) {
  return __uint_as_float(v.x) + __uint_as_float(v.y);
}

// acc[nt] += sum_k a(r, k) b(k, c) for the warp's rows r0 + [0, 16) and JN
// n-tiles of 8 columns c0 + [0, 8 JN), k over [k_lo, k_hi) in steps of 8,
// in 3xTF32; a and b return split operands (zero outside their matrices),
// in the fragment layout of mma.cuh
template <int JN, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[JN][4], int r0, int c0,
                                         int k_lo, int k_hi, const FA& a,
                                         const FB& b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    const int ka = k0 + q, kb = ka + 4;
    const mma::Split af[4] = {a(r0 + g, ka), a(r0 + g + 8, ka),
                              a(r0 + g, kb), a(r0 + g + 8, kb)};
    mma::Split b0[JN], b1[JN];
#pragma unroll
    for (int nt = 0; nt < JN; ++nt) {
      b0[nt] = b(ka, c0 + nt * 8 + g);
      b1[nt] = b(kb, c0 + nt * 8 + g);
    }
    mma::mma_3xtf32(acc, af, b0, b1);
  }
}

// warp_mma with A read from global memory: raw(r, k) loads one element
// (0 outside the operand; nothing but the load, so that no instruction
// waits for it) and make(r, k, v) turns it into the split operand. Each
// k-step's loads start before the previous k-step's products, so a
// warp waits for them once a k-step at most, behind that k-step's work.
template <int JN, class FR, class FM, class FB>
__device__ __forceinline__ void warp_mma_ld(float (&acc)[JN][4], int r0,
                                            int c0, int k_lo, int k_hi,
                                            const FR& raw, const FM& make,
                                            const FB& b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  if (k_lo >= k_hi) return;
  float cur[4] = {raw(r0 + g, k_lo + q), raw(r0 + g + 8, k_lo + q),
                  raw(r0 + g, k_lo + q + 4), raw(r0 + g + 8, k_lo + q + 4)};
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    const int kn = k0 + 8;
    float nxt[4] = {0.f, 0.f, 0.f, 0.f};
    if (kn < k_hi) {
      nxt[0] = raw(r0 + g, kn + q);
      nxt[1] = raw(r0 + g + 8, kn + q);
      nxt[2] = raw(r0 + g, kn + q + 4);
      nxt[3] = raw(r0 + g + 8, kn + q + 4);
    }
    const int ka = k0 + q, kb = ka + 4;
    const mma::Split af[4] = {make(r0 + g, ka, cur[0]),
                              make(r0 + g + 8, ka, cur[1]),
                              make(r0 + g, kb, cur[2]),
                              make(r0 + g + 8, kb, cur[3])};
    mma::Split b0[JN], b1[JN];
#pragma unroll
    for (int nt = 0; nt < JN; ++nt) {
      b0[nt] = b(ka, c0 + nt * 8 + g);
      b1[nt] = b(kb, c0 + nt * 8 + g);
    }
    mma::mma_3xtf32(acc, af, b0, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
  }
}

// the identity transform of warp_mma_ld: the element split as loaded
__device__ __forceinline__ mma::Split split_as_is(int, int, float v) {
  return mma::split(v);
}

// the sums of a lane's two rows (g, g + 8) over the 4 lanes that share
// them, in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the sum of a column over the 8 lanes (g) that hold its rows, fixed order
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// a warp's sum of one value a lane, fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int BWD_GROUP = 8;        // heads a chunk block sums GE over
constexpr int CHUNK_THREADS = 512;  // the chunk kernel's 16 warps
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;

// The shapes the backward's blocks pad to: steps to a multiple of 32 (GE's
// 16 x 32 tiles), P to a multiple of 32 (the 16 x 32 jobs), N to 8 (a
// k-step). A pre-split row holds P_pad + 4 elements of 8 bytes: the rows
// of the lanes' fragment reads then fall on distinct banks (2 (P_pad + 4)
// = 8 mod 32 words).
struct BwdDims {
  int Lp, Pp, Nk, pitch2;
};

__host__ __device__ inline BwdDims bwd_dims(int L, int P, int N) {
  const int Pp = round_up(P, 32);
  return {round_up(L, 32), Pp, round_up(N, 8), Pp + 4};
}

__host__ __device__ inline size_t local_smem_bytes(int L, int P, int N) {
  const BwdDims d = bwd_dims(L, P, N);
  return sizeof(uint2) * d.Lp * d.pitch2 + sizeof(float) * 3 * d.Lp;
}

// the chunk block's shared memory: x, dy (Lp x pitch2 split elements), the
// state slot (Nk x pitch2), the per-step vectors, the per-tile partials of
// the row and column sums, two per-warp partials
__host__ __device__ inline size_t chunk_smem_bytes(int L, int P, int N) {
  const BwdDims d = bwd_dims(L, P, N);
  const size_t floats = 10 * d.Lp + d.Lp * (d.Lp / 32) + d.Lp * (d.Lp / 16) +
                        2 * d.Lp * (d.Pp / 32) + 2 * CHUNK_WARPS;
  return sizeof(uint2) * (2 * d.Lp + d.Nk) * d.pitch2 +
         sizeof(float) * floats;
}

constexpr int DBDC_BM = 64, DBDC_BN = 64, DBDC_BK = 32, DBDC_STAGES = 4;
constexpr int DBDC_THREADS = 256;  // 4 x 2 warps of 16 x 32 outputs
// floats a staged row: the lanes' fragment reads (rows g, k-columns q)
// fall on banks 4 g + q, all distinct
constexpr int DBDC_PITCH = DBDC_BK + 4;

// the ring's stages: A and B tiles and A's row scales
__host__ __device__ inline size_t dbdc_smem_bytes() {
  return sizeof(float) * DBDC_STAGES *
         ((DBDC_BM + DBDC_BN) * DBDC_PITCH + DBDC_BM);
}

// rows x cols of an f32 matrix (row stride ld) into rows_pad x cols_pad
// split elements of pitch2, zero outside it, by the block's threads: each
// thread starts STAGE_BATCH loads before it stores any, so that many are
// in flight. Where `other` is not null, returns the thread's sum of each
// value times the split element of `other` at its place, read before the
// store (other may be dst). A thread stages the elements e = threadIdx.x
// + k blockDim.x, whatever the batch.
constexpr int STAGE_BATCH = 8;

__device__ __forceinline__ float stage_split(uint2* dst, int pitch2,
                                             const float* __restrict__ src,
                                             int64_t ld, int rows, int cols,
                                             int rows_pad, int cols_pad,
                                             const uint2* other = nullptr) {
  // (r, c) of element e, stepped without a division per element
  const int dr = blockDim.x / cols_pad, dc = blockDim.x % cols_pad;
  int r = threadIdx.x / cols_pad, c = threadIdx.x % cols_pad;
  float dot = 0.f;
  while (r < rows_pad) {
    float v[STAGE_BATCH];
    int rr[STAGE_BATCH], cc[STAGE_BATCH];
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      rr[j] = r;
      cc[j] = c;
      v[j] = r < rows && c < cols ? src[r * ld + c] : 0.f;
      r += dr;
      c += dc;
      if (c >= cols_pad) {
        c -= cols_pad;
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      if (rr[j] >= rows_pad) break;
      const int i = rr[j] * pitch2 + cc[j];
      if (other != nullptr) dot += v[j] * split_value(other[i]);
      dst[i] = to_split(v[j]);
    }
  }
  return dot;
}

// stage_split with four neighbouring columns a thread a step: float4 loads
// (cols and ld multiples of 4, src 16-byte aligned; cols_pad and pitch2
// multiples of 4), STAGE_BATCH4 in flight, two 16-byte stores each. A
// thread stages the same elements whatever the batch.
constexpr int STAGE_BATCH4 = 4;

__device__ __forceinline__ float stage_split4(uint2* dst, int pitch2,
                                              const float* __restrict__ src,
                                              int64_t ld, int rows, int cols,
                                              int rows_pad, int cols_pad,
                                              const uint2* other = nullptr) {
  const int q4 = cols_pad / 4;  // float4 a row
  const int dr = blockDim.x / q4, dc = blockDim.x % q4 * 4;
  int r = threadIdx.x / q4, c = threadIdx.x % q4 * 4;
  float dot = 0.f;
  while (r < rows_pad) {
    float4 v[STAGE_BATCH4];
    int rr[STAGE_BATCH4], cc[STAGE_BATCH4];
#pragma unroll
    for (int j = 0; j < STAGE_BATCH4; ++j) {
      rr[j] = r;
      cc[j] = c;
      v[j] = r < rows && c < cols
                 ? *reinterpret_cast<const float4*>(src + r * ld + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      r += dr;
      c += dc;
      if (c >= cols_pad) {
        c -= cols_pad;
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < STAGE_BATCH4; ++j) {
      if (rr[j] >= rows_pad) break;
      const int i = rr[j] * pitch2 + cc[j];
      const float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      uint2 sp[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (other != nullptr) dot += e[k] * split_value(other[i + k]);
        sp[k] = to_split(e[k]);
      }
      uint4* o = reinterpret_cast<uint4*>(dst + i);
      o[0] = make_uint4(sp[0].x, sp[0].y, sp[1].x, sp[1].y);
      o[1] = make_uint4(sp[2].x, sp[2].y, sp[3].x, sp[3].y);
    }
  }
  return dot;
}

// (b) local_c = sum_t exp(seg_t) C_t (x) dy_t over chunk c = blockIdx.x + 1
// of head blockIdx.y of batch row blockIdx.z, into dstates' slot c - 1 (the
// pass adds the decayed later chunks), and decay[b, c, h] = exp(seg_L).
// 16 x 32 warp jobs over the (N, P) output; dy pre-split in shared memory.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_local_kernel(const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const float* __restrict__ cm,
                     const float* __restrict__ dy, float* __restrict__ dstates,
                     float* __restrict__ decay, int S, int H, int P, int N,
                     int L, int vec) {
  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x + 1;
  const int t0 = c * L, Lc = min(L, S - t0);
  const BwdDims d = bwd_dims(L, P, N);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint2* dy_s = reinterpret_cast<uint2*>(smem_raw);   // Lp x pitch2
  float* dt_s = reinterpret_cast<float*>(dy_s + d.Lp * d.pitch2);
  float* seg_s = dt_s + d.Lp;
  float* es_s = seg_s + d.Lp;
  const int tid = threadIdx.x, warp = tid / 32;
  const int64_t x_step = static_cast<int64_t>(H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;
  const float A = -expf(a_log[h]);
  for (int t = tid; t < d.Lp; t += THREADS) {
    dt_s[t] = t < Lc ? dt[(row0 + t) * H + h] : 0.f;
    seg_s[t] = 0.f;
  }
  const float* dyh = dy + row0 * x_step + static_cast<int64_t>(h) * P;
  if (vec)
    stage_split4(dy_s, d.pitch2, dyh, x_step, Lc, P, d.Lp, d.Pp);
  else
    stage_split(dy_s, d.pitch2, dyh, x_step, Lc, P, d.Lp, d.Pp);
  __syncthreads();
  if (warp == 0) chunk_seg(dt_s, A, Lc, seg_s);
  __syncthreads();
  for (int t = tid; t < d.Lp; t += THREADS)
    es_s[t] = t < Lc ? expf(seg_s[t]) : 0.f;
  if (tid == 0)
    decay[(static_cast<int64_t>(b) * n_chunks + c) * H + h] =
        expf(seg_s[Lc - 1]);
  __syncthreads();
  const float* cc = cm + row0 * N;
  float* out = dstates +
               ((static_cast<int64_t>(b) * n_chunks + c - 1) * H + h) *
                   static_cast<int64_t>(N) * P;
  const int nrb = (N + 15) / 16, jobs = nrb * (d.Pp / 32);
  const int lane = tid % 32, g = lane >> 2, q = lane & 3;
  for (int job = warp; job < jobs; job += NWARPS) {
    const int n0 = (job % nrb) * 16, p0 = (job / nrb) * 32;
    float acc[4][4] = {};
    warp_mma_ld<4>(
        acc, n0, p0, 0, round_up(Lc, 8),
        [&](int n, int t) { return n < N && t < Lc ? cc[t * N + n] : 0.f; },
        [&](int, int t, float v) { return mma::split(es_s[t] * v); },
        [&](int t, int p) { return ld_split(dy_s[t * d.pitch2 + p]); });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + g + 8 * (i >> 1), p = p0 + nt * 8 + 2 * q + (i & 1);
        if (n < N && p < P) out[n * P + p] = acc[nt][i];
      }
  }
}

// (c) dstates[b, c, h] = the gradient of the state leaving chunk c:
// dh_final (or 0) for the last chunk, then dh_c = decay[b, c + 1, h] dh_{c+1}
// + local_{c+1} (which slot c holds), in place; a thread per element of
// (b, h, N x P), its locals read eight chunks ahead of the chain
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ dh_final,
                    const float* __restrict__ decay,
                    float* __restrict__ dstates,
                    int n_chunks, int H, int64_t NP, int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= total) return;
  const int64_t bh = e / NP, i = e % NP;
  const int64_t b = bh / H, h = bh % H;
  const int64_t cs = H * NP;  // one chunk of dstates
  float* p = dstates + (b * n_chunks * H + h) * NP + i;
  const float* dec = decay + b * n_chunks * H + h;
  float dh = dh_final != nullptr ? dh_final[e] : 0.f;
  p[(n_chunks - 1) * cs] = dh;
  for (int c0 = n_chunks - 2; c0 >= 0; c0 -= 8) {
    float loc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 - j >= 0) loc[j] = p[(c0 - j) * cs];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 - j >= 0) {
        dh = dec[(c0 - j + 1) * H] * dh + loc[j];
        p[(c0 - j) * cs] = dh;
      }
  }
}

// GE's 16 x 32 tiles on or below the diagonal of an Lp-step chunk, row
// block by row block: row block rb holds rb / 2 + 1 of them
__device__ __forceinline__ int ge_jobs(int Lp) {
  int n = 0;
  for (int rb = 0; rb < Lp / 16; ++rb) n += rb / 2 + 1;
  return n;
}

__device__ __forceinline__ void ge_tile(int job, int& rb, int& cb) {
  rb = 0;
  while (job > rb / 2) {
    job -= rb / 2 + 1;
    ++rb;
  }
  cb = job;
}


// (d) the per-head gradients of a chunk for a group of BWD_GROUP heads (see
// above): dx and ddt in place, the chunk's dD and dA sums into part, w and
// exp(seg) into ws and es for (e), and the group's GE_sum into gesum.
// Persistent: block blockIdx.x takes items blockIdx.x, + gridDim.x, ... of
// (b, chunk, group).
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const float* __restrict__ bm, const float* __restrict__ cm,
                     const float* __restrict__ d_skip,
                     const float* __restrict__ dy, const float* __restrict__ cb,
                     const float* __restrict__ states,
                     const float* __restrict__ dstates, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ ws,
                     float* __restrict__ es, float* __restrict__ gesum,
                     float* __restrict__ part, int B, int S, int H, int P,
                     int N, int L, int vec) {
  const BwdDims d = bwd_dims(L, P, N);
  const int Lp = d.Lp, pitch2 = d.pitch2, Lq = cb_pitch(L);
  const int nrb = Lp / 16, ncb = Lp / 32, npb = d.Pp / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint2* x_s = reinterpret_cast<uint2*>(smem_raw);  // Lp x pitch2
  uint2* dy_s = x_s + Lp * pitch2;                  // Lp x pitch2
  uint2* st_s = dy_s + Lp * pitch2;  // Nk x pitch2: dh, then h_in
  float* dt_s = reinterpret_cast<float*>(st_s + d.Nk * pitch2);
  float* seg_s = dt_s + Lp;
  float* es_s = seg_s + Lp;     // exp(seg)
  float* el_s = es_s + Lp;      // exp(seg_L - seg)
  float* w_s = el_s + Lp;       // exp(seg_L - seg) dt
  float* seg2_s = w_s + Lp;     // seg log2(e)
  float* cols_s = seg2_s + Lp;  // sum_t GE[t, s] CB[t, s]
  float* u_s = cols_s + Lp;     // x_s . (B_s . dh)
  float* r_s = u_s + Lp;        // exp(seg_t) dy_t . (C_t . h_in)
  float* dseg_s = r_s + Lp;
  float* rows_p = dseg_s + Lp;        // Lp x ncb, a GE tile's part
  float* cols_p = rows_p + Lp * ncb;  // Lp x nrb, a GE tile's part
  float* u_p = cols_p + Lp * nrb;     // Lp x npb, a dx job's part
  float* r_p = u_p + Lp * npb;        // Lp x npb, a C . h_in job's part
  float* red_s = r_p + Lp * npb;      // 2 x CHUNK_WARPS
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int n_chunks = (S + L - 1) / L;
  const int n_groups = (H + BWD_GROUP - 1) / BWD_GROUP;
  const int n_items = B * n_chunks * n_groups;
  const int n_ge = ge_jobs(Lp), n_jobs = nrb * npb;
  const int64_t x_step = static_cast<int64_t>(H) * P;
  const int64_t NP = static_cast<int64_t>(N) * P;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    // bc = b n_chunks + c
    const int grp = item % n_groups, bc = item / n_groups;
    const int c = bc % n_chunks, b = bc / n_chunks;
    const int t0 = c * L, Lc = min(L, S - t0);
    const int64_t row0 = static_cast<int64_t>(b) * S + t0;
    const float* cbc = cb + static_cast<int64_t>(bc) * L * Lq;
    const float* bmc = bm + row0 * N;
    const float* cmc = cm + row0 * N;
    float gs[2][4][4] = {};  // this warp's GE tiles summed over the heads
    const int h_end = min(H, (grp + 1) * BWD_GROUP);
    for (int h = grp * BWD_GROUP; h < h_end; ++h) {
      const int64_t bch = static_cast<int64_t>(bc) * H + h;
      const int64_t hoff = row0 * x_step + static_cast<int64_t>(h) * P;
      const float A = -expf(a_log[h]);
      const float Dh = d_skip[h];
      // x, dy and the state gradient leaving the chunk, split as they are
      // stored (with dD's part x . dy), by float4 loads where rows allow; a
      // thread reads back only what it stored itself
      const auto stage = [&](uint2* dst, const float* src, int64_t ld,
                             int rows, int cols, int rows_pad,
                             const uint2* other) {
        return vec ? stage_split4(dst, pitch2, src, ld, rows, cols, rows_pad,
                                  d.Pp, other)
                   : stage_split(dst, pitch2, src, ld, rows, cols, rows_pad,
                                 d.Pp, other);
      };
      stage(x_s, x + hoff, x_step, Lc, P, Lp, nullptr);
      float pd = stage(dy_s, dy + hoff, x_step, Lc, P, Lp, x_s);
      stage(st_s, dstates + bch * NP, P, N, P, d.Nk, nullptr);
      for (int t = tid; t < Lp; t += CHUNK_THREADS) {
        dt_s[t] = t < Lc ? dt[(row0 + t) * H + h] : 0.f;
        seg_s[t] = 0.f;
      }
      __syncthreads();
      if (warp == 0) chunk_seg(dt_s, A, Lc, seg_s);
      __syncthreads();
      const float total = seg_s[Lc - 1];
      for (int t = tid; t < Lp; t += CHUNK_THREADS) {
        const bool ok = t < Lc;
        es_s[t] = ok ? expf(seg_s[t]) : 0.f;
        el_s[t] = ok ? expf(total - seg_s[t]) : 0.f;
        w_s[t] = el_s[t] * dt_s[t];
        seg2_s[t] = seg_s[t] * 1.4426950408889634f;
        if (t < L) {
          ws[bch * L + t] = w_s[t];
          es[bch * L + t] = es_s[t];
        }
      }
      __syncthreads();

      // GE = (dy . x^T) exp(seg_t - seg_s) on and below the diagonal (the
      // exponential only under the mask: it overflows above), its row and
      // column sums against C.B^T, and dt_s GE into the group's sum. A
      // warp then goes on to its dx job with no barrier between: warps 0-3,
      // which hold a second GE tile, take the dx jobs of the last rows,
      // whose M^T . dy is the shortest.
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int job = warp + jj * CHUNK_WARPS;
        if (job >= n_ge) continue;
        int rb, cbk;
        ge_tile(job, rb, cbk);
        const int r0 = rb * 16, s0 = cbk * 32;
        float acc[4][4] = {};
        warp_mma<4>(
            acc, r0, s0, 0, d.Pp,
            [&](int t, int p) { return ld_split(dy_s[t * pitch2 + p]); },
            [&](int p, int s) { return ld_split(x_s[s * pitch2 + p]); });
        float rsum[2] = {0.f, 0.f}, csum[4][2] = {};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = r0 + g + 8 * (i >> 1);
            const int s = s0 + nt * 8 + 2 * q + (i & 1);
            const bool ok = s <= t && t < Lc;
            const float ge =
                ok ? acc[nt][i] * hopper::exp2_ftz(seg2_s[t] - seg2_s[s])
                   : 0.f;
            const float gc = ok ? ge * cbc[t * Lq + s] : 0.f;
            rsum[i >> 1] += gc * dt_s[s];
            csum[nt][i & 1] += gc;
            gs[jj][nt][i] += ge * dt_s[s];
          }
        rsum[0] = quad_sum(rsum[0]);
        rsum[1] = quad_sum(rsum[1]);
        if (q == 0) {
          rows_p[(r0 + g) * ncb + cbk] = rsum[0];
          rows_p[(r0 + g + 8) * ncb + cbk] = rsum[1];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float v = column_sum(csum[nt][k]);
            if (g == 0) cols_p[(s0 + nt * 8 + 2 * q + k) * nrb + rb] = v;
          }
      }

      // dx = w (B . dh) + M^T . dy + D dy in one accumulator: B . dh first,
      // whose rows give u = x . (B . dh), then scaled by w
      for (int job = warp; job < n_jobs; job += CHUNK_WARPS) {
        const int pb = job % npb, r0 = (nrb - 1 - job / npb) * 16;
        const int p0 = pb * 32;
        float acc[4][4] = {};
        float u[2] = {0.f, 0.f};
        if (r0 < Lc) {
          warp_mma_ld<4>(
              acc, r0, p0, 0, d.Nk,
              [&](int s, int n) {
                return s < Lc && n < N ? bmc[s * N + n] : 0.f;
              },
              split_as_is,
              [&](int n, int p) { return ld_split(st_s[n * pitch2 + p]); });
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int s = r0 + g + 8 * (i >> 1);
              u[i >> 1] += acc[nt][i] *
                           split_value(x_s[s * pitch2 + p0 + nt * 8 + 2 * q +
                                           (i & 1)]);
              acc[nt][i] *= w_s[s];
            }
          warp_mma_ld<4>(
              acc, r0, p0, r0, round_up(Lc, 8),
              [&](int s, int t) {
                return s <= t && t < Lc ? cbc[t * Lq + s] : 0.f;
              },
              [&](int s, int t, float v) {
                return mma::split(
                    s <= t && t < Lc
                        ? v * hopper::exp2_ftz(seg2_s[t] - seg2_s[s]) * dt_s[s]
                        : 0.f);
              },
              [&](int t, int p) { return ld_split(dy_s[t * pitch2 + p]); });
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = r0 + g + 8 * (i >> 1);
            const int p = p0 + nt * 8 + 2 * q + (i & 1);
            if (s < Lc && p < P)
              dx[hoff + s * x_step + p] =
                  acc[nt][i] + Dh * split_value(dy_s[s * pitch2 + p]);
          }
        u[0] = quad_sum(u[0]);
        u[1] = quad_sum(u[1]);
        if (q == 0) {
          u_p[(r0 + g) * npb + pb] = u[0];
          u_p[(r0 + g + 8) * npb + pb] = u[1];
        }
      }
      __syncthreads();  // every read of dh is done

      // the state entering the chunk over dh, with <dh, h_in> on the way
      // (the first chunk's is zero)
      const bool has_state = c > 0;
      float ph = 0.f;
      if (has_state)
        ph = stage(st_s, states + bch * NP, P, N, P, d.Nk, st_s);
      __syncthreads();

      // r = exp(seg_t) dy_t . (C_t . h_in) row by row
      for (int job = warp; job < n_jobs; job += CHUNK_WARPS) {
        const int r0 = (job % nrb) * 16, pb = job / nrb, p0 = pb * 32;
        float acc[4][4] = {};
        if (has_state && r0 < Lc)
          warp_mma_ld<4>(
              acc, r0, p0, 0, d.Nk,
              [&](int t, int n) {
                return t < Lc && n < N ? cmc[t * N + n] : 0.f;
              },
              split_as_is,
              [&](int n, int p) { return ld_split(st_s[n * pitch2 + p]); });
        float r[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = r0 + g + 8 * (i >> 1);
            const int p = p0 + nt * 8 + 2 * q + (i & 1);
            if (t < Lc && p < P)
              r[i >> 1] += acc[nt][i] * split_value(dy_s[t * pitch2 + p]);
          }
        r[0] = quad_sum(r[0]);
        r[1] = quad_sum(r[1]);
        if (q == 0) {
          r_p[(r0 + g) * npb + pb] = r[0];
          r_p[(r0 + g + 8) * npb + pb] = r[1];
        }
      }
      pd = warp_sum(pd);
      ph = warp_sum(ph);
      if (lane == 0) {
        red_s[warp] = pd;
        red_s[CHUNK_WARPS + warp] = ph;
      }
      __syncthreads();

      // the per-step vectors from the tiles' parts, each in a fixed order
      for (int t = tid; t < Lp; t += CHUNK_THREADS) {
        float rs = 0.f, cs = 0.f, uu = 0.f, rr = 0.f;
        for (int j = 0; j <= t / 32; ++j) rs += rows_p[t * ncb + j];
        for (int j = 2 * (t / 32); j < nrb; ++j) cs += cols_p[t * nrb + j];
        for (int j = 0; j < npb; ++j) {
          uu += u_p[t * npb + j];
          rr += r_p[t * npb + j];
        }
        cols_s[t] = cs;
        u_s[t] = uu;
        r_s[t] = es_s[t] * rr;
        dseg_s[t] = t < Lc ? rs - dt_s[t] * cs + r_s[t] - uu * w_s[t] : 0.f;
      }
      __syncthreads();

      // d(seg)'s last step, its reverse cumsum by a warp scan (lane l takes
      // a run of steps counted from the chunk's end), ddt, the chunk's dA
      if (warp == 0) {
        float sum_d = 0.f, hdot = 0.f;
        for (int w = 0; w < CHUNK_WARPS; ++w) {
          sum_d += red_s[w];
          hdot += red_s[CHUNK_WARPS + w];
        }
        float uw = 0.f;
        for (int t = lane; t < Lc; t += 32) uw += u_s[t] * w_s[t];
        uw = warp_sum(uw);
        if (lane == 0) dseg_s[Lc - 1] += es_s[Lc - 1] * hdot + uw;
        __syncwarp();
        const int per = (Lc + 31) / 32;
        const int lo = min(lane * per, Lc), hi = min(lo + per, Lc);
        float run = 0.f;
        for (int k = lo; k < hi; ++k) run += dseg_s[Lc - 1 - k];
        float inc = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, inc, off);
          if (lane >= off) inc += v;
        }
        float rc = inc - run, da = 0.f;
        for (int k = lo; k < hi; ++k) {
          const int t = Lc - 1 - k;
          rc += dseg_s[t];
          ddt[(row0 + t) * H + h] = cols_s[t] + u_s[t] * el_s[t] + A * rc;
          da += dt_s[t] * rc;
        }
        da = warp_sum(da);
        if (lane == 0) {
          part[bch * 2] = sum_d;
          part[bch * 2 + 1] = da;
        }
      }
      __syncthreads();  // before the next head's staging
    }

    // the group's GE_sum, each tile by the warp that holds it
    float* out = gesum + (static_cast<int64_t>(bc) * n_groups + grp) * Lp * Lp;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int job = warp + jj * CHUNK_WARPS;
      if (job >= n_ge) continue;
      int rb, cbk;
      ge_tile(job, rb, cbk);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          out[(rb * 16 + g + 8 * (i >> 1)) * Lp + cbk * 32 + nt * 8 + 2 * q +
              (i & 1)] = gs[jj][nt][i];
    }
  }
}

// (e) dB or dC of chunk rows [m0, m0 + 64) and columns [n0, n0 + 64), all
// heads summed: over the chunk's steps, A = GE_sum^T (dB, t >= s) or
// GE_sum (dC, s <= t) against C (dB) or B (dC), then over (h, p), A = w_h
// x_h (dB) or exp(seg_h) dy_h (dC) against the state gradients (dB) or the
// chunk states (dC). 8 warps of 16 x 32 outputs. 32-wide k-tiles of both
// operands arrive by cp.async in a ring of DBDC_STAGES stages, three tiles
// in flight while one computes (the step tiles' A, summed over the head
// groups, by plain loads and stores); A's row scale is applied and both
// operands split into TF32 hi / lo as the fragments are read.
__global__ void __launch_bounds__(DBDC_THREADS, 2)
ssd_bwd_dbdc_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ states,
                    const float* __restrict__ dstates,
                    const float* __restrict__ ws, const float* __restrict__ es,
                    const float* __restrict__ gesum, float* __restrict__ db,
                    float* __restrict__ dc, int S, int H, int P, int N, int L,
                    int vec) {
  const BwdDims d = bwd_dims(L, P, N);
  const int Lp = d.Lp;
  const int n_chunks = (S + L - 1) / L;
  const int n_groups = (H + BWD_GROUP - 1) / BWD_GROUP;
  const int nmb = (L + DBDC_BM - 1) / DBDC_BM;
  const int nnb = (N + DBDC_BN - 1) / DBDC_BN;
  int idx = blockIdx.x;
  const int nb = idx % nnb;
  idx /= nnb;
  const int mb = idx % nmb;
  idx /= nmb;
  const bool is_db = idx % 2 == 0;
  const int bc = idx / 2, c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int m0 = mb * DBDC_BM, n0 = nb * DBDC_BN;
  if (m0 >= Lc) return;  // rows past a ragged chunk's end
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_s = reinterpret_cast<float*>(smem_raw);  // STAGES x BM x PITCH
  float* b_s = a_s + DBDC_STAGES * DBDC_BM * DBDC_PITCH;  // STAGES x BN x PITCH
  float* sc_s = b_s + DBDC_STAGES * DBDC_BN * DBDC_PITCH;  // STAGES x BM
  const int tid = threadIdx.x;
  const int64_t x_step = static_cast<int64_t>(H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;
  const int64_t NP = static_cast<int64_t>(N) * P;
  const float* src = is_db ? x : dy;
  const float* scale = (is_db ? ws : es) + static_cast<int64_t>(bc) * H * L;
  const float* st =
      (is_db ? dstates : states) + static_cast<int64_t>(bc) * H * NP;
  const float* mat = is_db ? cm : bm;
  const float* gsum = gesum + static_cast<int64_t>(bc) * n_groups * Lp * Lp;
  const int ppt = d.Pp / DBDC_BK;  // k-tiles of one head's P
  // the steps: dB sums t >= s (from m0), dC s <= t (to m0 + BM)
  const int k_lo = is_db ? m0 : 0;
  const int k_hi = is_db ? Lc : min(m0 + DBDC_BM, Lc);
  const int n_step = (k_hi - k_lo + DBDC_BK - 1) / DBDC_BK;
  const int n_tiles = n_step + H * ppt;

  // tile `tile` into stage `sg`, one cp.async group a tile
  auto fetch = [&](int tile, int sg) {
    float* a = a_s + sg * DBDC_BM * DBDC_PITCH;
    float* bb = b_s + sg * DBDC_BN * DBDC_PITCH;
    float* sc = sc_s + sg * DBDC_BM;
    if (tile < n_step) {
      const int k0 = k_lo + tile * DBDC_BK;
#pragma unroll 1  // unrolled, its loads spill at 2 blocks an SM
      for (int j = 0; j < DBDC_BM * DBDC_BK / DBDC_THREADS; ++j) {
        const int e = tid + j * DBDC_THREADS;
        const int r = e / DBDC_BK, kk = e % DBDC_BK, k = k0 + kk;
        const int m = m0 + r, n = n0 + r;
        const int t = is_db ? k : m, s = is_db ? m : k;
        float v = 0.f;
        if (s <= t && t < Lc)
          for (int gr = 0; gr < n_groups; ++gr)
            v += gsum[(static_cast<int64_t>(gr) * Lp + t) * Lp + s];
        a[r * DBDC_PITCH + kk] = v;
        const bool ok = k < Lc && n < N;
        mma::cp_async4(&bb[r * DBDC_PITCH + kk],
                       ok ? mat + (row0 + k) * N + n : mat, ok ? 4 : 0);
      }
      for (int r = tid; r < DBDC_BM; r += DBDC_THREADS) sc[r] = 1.f;
    } else {
      const int hp = tile - n_step, h = hp / ppt, p0 = (hp % ppt) * DBDC_BK;
      const float* ah = src + row0 * x_step + static_cast<int64_t>(h) * P;
      const float* bh = st + h * NP;
      const int w = vec ? 4 : 1;  // floats a copy
      for (int e = tid; e < DBDC_BM * DBDC_BK / w; e += DBDC_THREADS) {
        const int r = e / (DBDC_BK / w), k = e % (DBDC_BK / w) * w;
        const int m = m0 + r, n = n0 + r, p = p0 + k;
        const bool oka = m < Lc && p < P, okb = n < N && p < P;
        const float* ga = oka ? ah + m * x_step + p : src;
        const float* gb = okb ? bh + static_cast<int64_t>(n) * P + p : st;
        if (vec) {
          mma::cp_async16(&a[r * DBDC_PITCH + k], ga, oka ? 16 : 0);
          mma::cp_async16(&bb[r * DBDC_PITCH + k], gb, okb ? 16 : 0);
        } else {
          mma::cp_async4(&a[r * DBDC_PITCH + k], ga, oka ? 4 : 0);
          mma::cp_async4(&bb[r * DBDC_PITCH + k], gb, okb ? 4 : 0);
        }
      }
      for (int r = tid; r < DBDC_BM; r += DBDC_THREADS) {
        const bool ok = m0 + r < Lc;
        mma::cp_async4(&sc[r], ok ? scale + h * L + m0 + r : scale,
                       ok ? 4 : 0);
      }
    }
    mma::cp_async_commit();
  };

  const int warp = tid / 32, wr = warp % 4, wc = warp / 4;
  const int g = (tid % 32) >> 2, q = tid & 3;
  float acc[4][4] = {};
#pragma unroll
  for (int i = 0; i < DBDC_STAGES - 1; ++i) {
    if (i < n_tiles)
      fetch(i, i);
    else
      mma::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<DBDC_STAGES - 2>();
    __syncthreads();  // tile i is in; the stage of tile i - 1 is free
    const int nxt = i + DBDC_STAGES - 1;
    if (nxt < n_tiles)
      fetch(nxt, nxt % DBDC_STAGES);
    else
      mma::cp_async_commit();
    const int sg = i % DBDC_STAGES;
    const float* a = a_s + sg * DBDC_BM * DBDC_PITCH;
    const float* bb = b_s + sg * DBDC_BN * DBDC_PITCH;
    const float sc0 = sc_s[sg * DBDC_BM + 16 * wr + g];
    const float sc1 = sc_s[sg * DBDC_BM + 16 * wr + g + 8];
    warp_mma<4>(
        acc, 16 * wr, 32 * wc, 0, DBDC_BK,
        [&](int r, int k) {
          return mma::split(a[r * DBDC_PITCH + k] * (r & 8 ? sc1 : sc0));
        },
        [&](int k, int col) { return mma::split(bb[col * DBDC_PITCH + k]); });
  }
  float* out = is_db ? db : dc;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mm = m0 + 16 * wr + g + 8 * (i >> 1);
      const int nn = n0 + 32 * wc + nt * 8 + 2 * q + (i & 1);
      if (mm < Lc && nn < N) out[(row0 + mm) * N + nn] = acc[nt][i];
    }
}

// (f) dD and da_log: the per-chunk sums summed over (b, chunk), each output
// by one thread, in order
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ part,
                      const float* __restrict__ a_log,
                      float* __restrict__ da_log, float* __restrict__ dd, int H,
                      int n_parts) {
  const int h = blockIdx.x * THREADS + threadIdx.x;
  if (h >= H) return;
  float sd = 0.f, sa = 0.f;
  for (int i = 0; i < n_parts; ++i) {
    sd += part[(static_cast<int64_t>(i) * H + h) * 2];
    sa += part[(static_cast<int64_t>(i) * H + h) * 2 + 1];
  }
  dd[h] = sd;
  da_log[h] = -expf(a_log[h]) * sa;
}

// the backward's scratch, carved from one workspace of
// ssd_scan_bwd_work_floats floats (each region a multiple of 4 floats):
// C.B^T, the state gradients (B, n_chunks, H, N, P), the chunks' decays
// (B, n_chunks, H), w and exp(seg) (B, n_chunks, H, L), the groups' GE_sum
// (B, n_chunks, H / BWD_GROUP, Lp, Lp), the per-chunk dD and dA sums
struct BwdWork {
  float *cb, *dstates, *decay, *ws, *es, *gesum, *part;
  size_t floats;
};

BwdWork bwd_work(float* base, int B, int S, int H, int P, int N, int L) {
  const size_t nc = (S + L - 1) / L, bnc = static_cast<size_t>(B) * nc;
  const size_t ng = (H + BWD_GROUP - 1) / BWD_GROUP;
  const size_t Lp = bwd_dims(L, P, N).Lp;
  const size_t sizes[7] = {bnc * L * cb_pitch(L),
                           bnc * H * N * P,
                           bnc * H,
                           bnc * H * L,
                           bnc * H * L,
                           bnc * ng * Lp * Lp,
                           bnc * H * 2};
  float* p[7];
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    p[i] = base == nullptr ? nullptr : base + off;
    off += (sizes[i] + 3) / 4 * 4;
  }
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], off};
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one scan block needs (the wrapper checks
// them against the card's limit before launching).
size_t ssd_scan_smem_bytes(int chunk, int P, int N) {
  return sizeof(float) * scan_smem_floats(chunk, P, N);
}

// The row pitch of the cb scratch (B, n_chunks, L, pitch) for L steps.
int ssd_cb_pitch(int L) { return cb_pitch(L); }

// Launch (a) alone into cb (B, n_chunks, L, ssd_cb_pitch(L)) with L =
// min(chunk, S); entries above the diagonal and in the padding are left
// as they were. Returns a cudaError_t.
int ssd_cb_fwd(const void* bm, const void* cm, void* cb, int B, int S, int N,
               int chunk, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || chunk <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  return launch_cb(bm, cm, cb, B, S, N, chunk < S ? chunk : S,
                   static_cast<cudaStream_t>(stream));
}

// (a) then (b), each launch checked. cb is the (B, n_chunks, L,
// ssd_cb_pitch(L)) f32 scratch; h_out may be null (no final state), and so
// may states, the (B, n_chunks, H, N, P) state entering each chunk that the
// backward reads. Returns a cudaError_t (0 = success).
int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                 const void* bm, const void* cm, const void* d_skip, void* cb,
                 void* y, void* h_out, void* states, int B, int S, int H,
                 int P, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_cb(bm, cm, cb, B, S, N, L, st);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * scan_smem_floats(L, P, N);
  // the widest job (up to 64 columns) that tiles round_up(P, 8) exactly
  const int tiles = (P + 7) / 8;
  const auto kern = tiles % 8 == 0   ? ssd_scan_kernel<8>
                    : tiles % 4 == 0 ? ssd_scan_kernel<4>
                    : tiles % 2 == 0 ? ssd_scan_kernel<2>
                                     : ssd_scan_kernel<1>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int xvec = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nvec = N % 2 == 0 && aligned8(bm) && aligned8(cm);
  kern<<<B * H, THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(cb),
      static_cast<const float*>(d_skip), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<float*>(states), S, H, P, N, L,
      xvec, nvec);
  return cudaGetLastError();
}

// Floats of the workspace ssd_scan_bwd takes (the wrapper allocates it).
size_t ssd_scan_bwd_work_floats(int B, int S, int H, int P, int N,
                                int chunk) {
  return bwd_work(nullptr, B, S, H, P, N, chunk < S ? chunk : S).floats;
}

// Bytes of dynamic shared memory the backward's largest block needs.
size_t ssd_scan_bwd_smem_bytes(int chunk, int P, int N) {
  const size_t a = local_smem_bytes(chunk, P, N);
  const size_t b = chunk_smem_bytes(chunk, P, N);
  const size_t c = dbdc_smem_bytes();
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// The backward's six launches, each checked: dx (B, S, H, P), ddt
// (B, S, H), da_log (H,), db and dc (B, S, N), dd (H,) of y = SSD(x, dt,
// a_log, b, c, d_skip) for dy (B, S, H, P), from the forward's chunk states
// (B, n_chunks, H, N, P) and dh_final (B, H, N, P), the final state's
// gradient, or null. work holds ssd_scan_bwd_work_floats floats. Chunks of
// at most 128 steps. Returns a cudaError_t (0 = success).
int ssd_scan_bwd(const void* x, const void* dt, const void* a_log,
                 const void* bm, const void* cm, const void* d_skip,
                 const void* dy, const void* states, const void* dh_final,
                 void* work, void* dx, void* ddt, void* da_log, void* db,
                 void* dc, void* dd, int B, int S, int H, int P, int N,
                 int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S, n_chunks = (S + L - 1) / L;
  // the chunk kernel's warps hold at most two GE tiles each
  if (bwd_dims(L, P, N).Lp > 128) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdWork w = bwd_work(static_cast<float*>(work), B, S, H, P, N, L);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err = launch_cb(bm, cm, w.cb, B, S, N, L, st);
  if (err != cudaSuccess) return err;
  // 16-byte loads and copies of x, dy and the states where rows of P keep
  // them aligned
  const int vec = P % 4 == 0 && aligned16(x) && aligned16(dy) &&
                  aligned16(states) && aligned16(w.dstates);

  if (n_chunks > 1) {
    const size_t smem = local_smem_bytes(L, P, N);
    err = cudaFuncSetAttribute(ssd_bwd_local_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ssd_bwd_local_kernel<<<dim3(n_chunks - 1, H, B), THREADS, smem, st>>>(
        f(dt), f(a_log), f(cm), f(dy), w.dstates, w.decay, S, H, P, N, L,
        vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const int64_t NP = static_cast<int64_t>(N) * P;
  const int64_t elems = static_cast<int64_t>(B) * H * NP;
  const unsigned pass_blocks =
      static_cast<unsigned>((elems + THREADS - 1) / THREADS);
  ssd_bwd_pass_kernel<<<pass_blocks, THREADS, 0, st>>>(
      f(dh_final), w.decay, w.dstates, n_chunks, H, NP, elems);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  size_t smem = chunk_smem_bytes(L, P, N);
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int items = B * n_chunks * ((H + BWD_GROUP - 1) / BWD_GROUP);
  const int programs = items < sms ? items : sms;  // persistent
  ssd_bwd_chunk_kernel<<<programs, CHUNK_THREADS, smem, st>>>(
      f(x), f(dt), f(a_log), f(bm), f(cm), f(d_skip), f(dy), w.cb, f(states),
      w.dstates, out(dx), out(ddt), w.ws, w.es, w.gesum, w.part, B, S, H, P,
      N, L, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = dbdc_smem_bytes();
  err = cudaFuncSetAttribute(ssd_bwd_dbdc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles =
      ((L + DBDC_BM - 1) / DBDC_BM) * ((N + DBDC_BN - 1) / DBDC_BN);
  ssd_bwd_dbdc_kernel<<<B * n_chunks * 2 * tiles, DBDC_THREADS, smem, st>>>(
      f(x), f(dy), f(bm), f(cm), f(states), w.dstates, w.ws, w.es, w.gesum,
      out(db), out(dc), S, H, P, N, L, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_reduce_kernel<<<(H + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      w.part, f(a_log), out(da_log), out(dd), H, B * n_chunks);
  return cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
