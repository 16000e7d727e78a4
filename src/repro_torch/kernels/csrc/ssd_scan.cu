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
// and d(seg) from every term: its in-chunk reverse cumsum times A gives
// ddt beside the direct terms, and sum_t dt_t revcumsum_t times A gives
// da_log (A = -exp(a_log), dA/da_log = A).
//
// What bounds it on the H100: at mamba2-1.3b's train shape (B 2, S 4096,
// H 64, P 64, N 128, chunk 128) it needs ~60 GFLOP of products (per (b, h,
// chunk) G and M^T . dy, L(L+1)/2 x P MACs each; GE . B and GE^T . C,
// L(L+1)/2 x N each; B . dh, x . dh^T, dy . h_in^T and the reverse pass, L N P
// each) and moves ~0.54 GB (x, dy, the chunk states in; dx out, ~134 MB
// each). In 3xTF32 (f32 accuracy, as the forward) that is 0.36 ms at 165
// TFLOP/s against 0.16 ms for the bytes: bound by the products.
//
// This first kernel is simple and right rather than fast: four launches,
// every product a warp job of 16 rows x 64 columns of m16n8k8 3xTF32
// mma.sync with operands gathered element by element (from shared memory
// for x, dy and GE, from L2 for B, C, C.B^T and the states):
// (a) ssd_cb_kernel, as the forward: C.B^T per (b, chunk);
// (b) ssd_bwd_dstate_kernel, one block per (b, h) walking the chunks in
//     reverse: the gradient of the state leaving each chunk, into a
//     (B, n_chunks, H, N, P) scratch;
// (c) ssd_bwd_chunk_kernel, one block per (chunk, h, b): every gradient
//     local to the chunk. dx and ddt are written in place (each element
//     belongs to one block); dB and dC per head into (B, S, H, N) scratch,
//     dD's and dA's per-chunk sums into (B, n_chunks, H, 2);
// (d) ssd_bwd_reduce_kernel: dB and dC summed over the heads, dD and
//     da_log over (b, chunk), each in a fixed order. No float atomics, so
//     two calls give the same bits.
// The forward's guards hold: exp(seg_t - seg_s) is evaluated only under
// the causal mask and masked entries are selected to 0; a ragged last
// chunk runs its true length; B and C are read by batch index.

constexpr int BJ = 8;  // n-tiles of 8 columns in a backward warp job

// acc[nt] += sum_k a(r, k) b(k, col) for the warp's rows r0 + [0, 16) and
// columns c0 + [0, 64), k over [k_lo, k_hi) in steps of 8 (a and b return 0
// outside their operands), in 3xTF32, in the fragment layout of mma.cuh
template <class FA, class FB>
__device__ __forceinline__ void warp_gemm(float (&acc)[BJ][4], int r0, int c0,
                                          int k_lo, int k_hi, const FA& a,
                                          const FB& b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    const int ka = k0 + q, kb = ka + 4;
    const mma::Split af[4] = {mma::split(a(r0 + g, ka)),
                              mma::split(a(r0 + g + 8, ka)),
                              mma::split(a(r0 + g, kb)),
                              mma::split(a(r0 + g + 8, kb))};
    mma::Split b0[BJ], b1[BJ];
#pragma unroll
    for (int nt = 0; nt < BJ; ++nt) {
      b0[nt] = mma::split(b(ka, c0 + nt * 8 + g));
      b1[nt] = mma::split(b(kb, c0 + nt * 8 + g));
    }
    mma::mma_3xtf32(acc, af, b0, b1);
  }
}

// f(row, col, i, nt) for each accumulator element of the warp's job
template <class F>
__device__ __forceinline__ void for_acc(int r0, int c0, const F& f) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < BJ; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f(r0 + g + 8 * (i >> 1), c0 + nt * 8 + 2 * q + (i & 1), nt, i);
}

// the sums of a lane's two rows (g, g + 8) over the 4 lanes that share
// them, in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__host__ __device__ inline int bwd_pitch(int P) { return round_up(P, 8) + 4; }

__host__ __device__ inline size_t dstate_smem_floats(int L, int P, int N) {
  const size_t Lp = round_up(L, 16);
  return (Lp + N) * bwd_pitch(P) + 3 * Lp;
}

__host__ __device__ inline size_t chunk_smem_floats(int L, int P, int N) {
  const size_t Lp = round_up(L, 16);
  return 2 * Lp * bwd_pitch(P) + Lp * (Lp + 4) + 10 * Lp +
         Lp * ((P + 63) / 64 + (N + 63) / 64) + THREADS;
}

// (b) dstates[b, c, h] = the gradient of the state leaving chunk c (the
// state entering chunk c + 1): dh_final for the last chunk, then
// dh <- exp(seg_L) dh + (C (x) exp(seg))^T . dy over chunk c + 1
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dstate_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const float* __restrict__ cm,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh_final,
                      float* __restrict__ dstates, int S, int H, int P, int N,
                      int L) {
  const int Lp = round_up(L, 16), pitch = bwd_pitch(P);
  extern __shared__ __align__(16) float smem[];
  float* dy_s = smem;                  // Lp x pitch
  float* dh_s = dy_s + Lp * pitch;     // N x pitch
  float* dt_s = dh_s + N * pitch;      // Lp
  float* seg_s = dt_s + Lp;            // Lp
  float* e_s = seg_s + Lp;             // Lp: exp(seg)
  const int tid = threadIdx.x, warp = tid / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float A = -expf(a_log[h]);
  const int64_t x_step = static_cast<int64_t>(H) * P;
  const float* dyb = dy + static_cast<int64_t>(b) * S * x_step +
                     static_cast<int64_t>(h) * P;
  const float* dtb = dt + static_cast<int64_t>(b) * S * H + h;
  const float* cb_ = cm + static_cast<int64_t>(b) * S * N;
  const int n_chunks = (S + L - 1) / L;
  const int64_t NP = static_cast<int64_t>(N) * P;

  for (int e = tid; e < N * P; e += THREADS)
    dh_s[(e / P) * pitch + e % P] =
        dh_final != nullptr ? dh_final[bh * NP + e] : 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    __syncthreads();  // dh_s is complete; chunk c + 1's readers are done
    float* out = dstates + ((static_cast<int64_t>(b) * n_chunks + c) * H + h) *
                               NP;
    for (int e = tid; e < N * P; e += THREADS)
      out[e] = dh_s[(e / P) * pitch + e % P];
    if (c == 0) break;
    const int t0 = c * L, Lc = min(L, S - t0);
    for (int e = tid; e < Lp * P; e += THREADS) {
      const int r = e / P, p = e % P;
      dy_s[r * pitch + p] =
          r < Lc ? dyb[static_cast<int64_t>(t0 + r) * x_step + p] : 0.f;
    }
    for (int t = tid; t < Lp; t += THREADS)
      dt_s[t] = t < Lc ? dtb[static_cast<int64_t>(t0 + t) * H] : 0.f;
    __syncthreads();
    if (warp == 0) chunk_seg(dt_s, A, Lc, seg_s);
    __syncthreads();
    for (int t = tid; t < Lp; t += THREADS)
      e_s[t] = t < Lc ? expf(seg_s[t]) : 0.f;
    __syncthreads();  // also: every read of dh_s into `out` is done
    const float decay = expf(seg_s[Lc - 1]);
    const float* cc = cb_ + static_cast<int64_t>(t0) * N;
    const int nrt = (N + 15) / 16, ncb = (P + 63) / 64;
    for (int job = warp; job < nrt * ncb; job += NWARPS) {
      const int n0 = (job % nrt) * 16, p0 = (job / nrt) * 64;
      float acc[BJ][4] = {};
      warp_gemm(
          acc, n0, p0, 0, Lc,
          [&](int n, int t) {
            return n < N && t < Lc ? cc[static_cast<int64_t>(t) * N + n] * e_s[t]
                                   : 0.f;
          },
          [&](int t, int p) { return p < P ? dy_s[t * pitch + p] : 0.f; });
      for_acc(n0, p0, [&](int n, int p, int nt, int i) {
        if (n < N && p < P)
          dh_s[n * pitch + p] = decay * dh_s[n * pitch + p] + acc[nt][i];
      });
    }
  }
}

// (c) every gradient local to chunk blockIdx.x of head blockIdx.y of batch
// row blockIdx.z (see above)
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const float* __restrict__ bm, const float* __restrict__ cm,
                     const float* __restrict__ d_skip,
                     const float* __restrict__ dy, const float* __restrict__ cb,
                     const float* __restrict__ states,
                     const float* __restrict__ dstates, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dbh,
                     float* __restrict__ dch, float* __restrict__ part, int S,
                     int H, int P, int N, int L) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int Lp = round_up(L, 16), pitch = bwd_pitch(P), lp = Lp + 4;
  const int Lq = cb_pitch(L);
  const int ncp = (P + 63) / 64, ncn = (N + 63) / 64;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                   // Lp x pitch
  float* dy_s = x_s + Lp * pitch;      // Lp x pitch
  float* ge_s = dy_s + Lp * pitch;     // Lp x lp: GE[t, s], zero off the mask
  float* dt_s = ge_s + Lp * lp;        // the 10 per-step vectors, Lp each
  float* seg_s = dt_s + Lp;
  float* w_s = seg_s + Lp;             // exp(seg_L - seg) dt
  float* el_s = w_s + Lp;              // exp(seg_L - seg)
  float* es_s = el_s + Lp;             // exp(seg)
  float* rows_s = es_s + Lp;           // sum_s GE[t, s] CB[t, s] dt_s
  float* cols_s = rows_s + Lp;         // sum_t GE[t, s] CB[t, s]
  float* u_s = cols_s + Lp;            // x_s . (B_s . dh)
  float* r_s = u_s + Lp;               // C_t . exp(seg_t) dy_t . h_in^T
  float* dseg_s = r_s + Lp;
  float* up_s = dseg_s + Lp;           // Lp x ncp partial sums of u
  float* rp_s = up_s + Lp * ncp;       // Lp x ncn partial sums of r
  float* red_s = rp_s + Lp * ncn;      // THREADS

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const float A = -expf(a_log[h]);
  const float D = d_skip[h];
  const int64_t x_step = static_cast<int64_t>(H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;  // (b, t0) in (B, S)
  const float* xb = x + row0 * x_step + static_cast<int64_t>(h) * P;
  const float* dyb = dy + row0 * x_step + static_cast<int64_t>(h) * P;
  float* dxb = dx + row0 * x_step + static_cast<int64_t>(h) * P;
  const float* bc = bm + row0 * N;
  const float* cc = cm + row0 * N;
  const float* cbc = cb + (static_cast<int64_t>(b) * n_chunks + c) * L * Lq;
  const int64_t NP = static_cast<int64_t>(N) * P;
  const int64_t bch = (static_cast<int64_t>(b) * n_chunks + c) * H + h;
  const float* hin = states + bch * NP;
  const float* dho = dstates + bch * NP;

  for (int e = tid; e < Lp * pitch; e += THREADS) {
    const int r = e / pitch, p = e % pitch;
    const bool ok = r < Lc && p < P;
    x_s[e] = ok ? xb[r * x_step + p] : 0.f;
    dy_s[e] = ok ? dyb[r * x_step + p] : 0.f;
  }
  for (int e = tid; e < Lp * lp; e += THREADS) ge_s[e] = 0.f;
  for (int t = tid; t < Lp; t += THREADS)
    dt_s[t] = t < Lc ? dt[(row0 + t) * H + h] : 0.f;
  __syncthreads();
  if (warp == 0) chunk_seg(dt_s, A, Lc, seg_s);
  __syncthreads();
  const float total = seg_s[Lc - 1];
  for (int t = tid; t < Lp; t += THREADS) {
    const bool ok = t < Lc;
    es_s[t] = ok ? expf(seg_s[t]) : 0.f;
    el_s[t] = ok ? expf(total - seg_s[t]) : 0.f;
    w_s[t] = el_s[t] * dt_s[t];
  }
  __syncthreads();
  const int nrt = Lp / 16;

  // GE = (dy . x^T) exp(seg_t - seg_s) on and below the diagonal; the
  // exponential only under the mask (it overflows above)
  const int ncl = (Lc + 63) / 64;
  for (int job = warp; job < nrt * ncl; job += NWARPS) {
    const int r0 = (job % nrt) * 16, s0 = (job / nrt) * 64;
    if (r0 >= Lc || s0 > r0 + 15) continue;
    float acc[BJ][4] = {};
    warp_gemm(
        acc, r0, s0, 0, P,
        [&](int t, int p) { return p < P ? dy_s[t * pitch + p] : 0.f; },
        [&](int p, int s) { return p < P && s < Lp ? x_s[s * pitch + p] : 0.f; });
    for_acc(r0, s0, [&](int t, int s, int nt, int i) {
      if (t < Lc && s <= t)
        ge_s[t * lp + s] = acc[nt][i] * expf(seg_s[t] - seg_s[s]);
    });
  }
  __syncthreads();

  // the score gradient against C.B^T: its row sums (times dt_s) and
  // column sums, for d(seg) and ddt
  for (int i = tid; i < Lc; i += THREADS) {
    float rs = 0.f, cs = 0.f;
    for (int s = 0; s <= i; ++s) rs += ge_s[i * lp + s] * cbc[i * Lq + s] * dt_s[s];
    for (int t = i; t < Lc; ++t) cs += ge_s[t * lp + i] * cbc[t * Lq + i];
    rows_s[i] = rs;
    cols_s[i] = cs;
  }

  // dx = M^T . dy + w (B . dh) + D dy; u = x . (B . dh) row by row
  for (int job = warp; job < nrt * ncp; job += NWARPS) {
    const int r0 = (job % nrt) * 16, p0 = (job / nrt) * 64;
    if (r0 >= Lc) continue;
    float am[BJ][4] = {}, ab[BJ][4] = {};
    warp_gemm(
        am, r0, p0, r0, Lc,
        [&](int s, int t) {
          return s <= t && t < Lc
                     ? cbc[t * Lq + s] * expf(seg_s[t] - seg_s[s]) * dt_s[s]
                     : 0.f;
        },
        [&](int t, int p) { return p < P ? dy_s[t * pitch + p] : 0.f; });
    warp_gemm(
        ab, r0, p0, 0, N,
        [&](int s, int n) {
          return s < Lc && n < N ? bc[static_cast<int64_t>(s) * N + n] : 0.f;
        },
        [&](int n, int p) {
          return n < N && p < P ? dho[static_cast<int64_t>(n) * P + p] : 0.f;
        });
    float u[2] = {0.f, 0.f};
    for_acc(r0, p0, [&](int s, int p, int nt, int i) {
      if (s < Lc && p < P) {
        dxb[s * x_step + p] = am[nt][i] + w_s[s] * ab[nt][i] +
                              D * dy_s[s * pitch + p];
        u[i >> 1] += ab[nt][i] * x_s[s * pitch + p];
      }
    });
    u[0] = quad_sum(u[0]);
    u[1] = quad_sum(u[1]);
    if (q == 0) {
      up_s[(r0 + g) * ncp + job / nrt] = u[0];
      up_s[(r0 + g + 8) * ncp + job / nrt] = u[1];
    }
  }

  // dB for this head: GE^T dt . C + (w x) . dh^T
  const int jobs_n = nrt * ncn;
  for (int job = warp; job < jobs_n; job += NWARPS) {
    const int r0 = (job % nrt) * 16, n0 = (job / nrt) * 64;
    if (r0 >= Lc) continue;
    float acc[BJ][4] = {};
    warp_gemm(
        acc, r0, n0, r0, Lc,
        [&](int s, int t) { return t < Lc ? ge_s[t * lp + s] * dt_s[s] : 0.f; },
        [&](int t, int n) {
          return t < Lc && n < N ? cc[static_cast<int64_t>(t) * N + n] : 0.f;
        });
    warp_gemm(
        acc, r0, n0, 0, P,
        [&](int s, int p) { return p < P ? x_s[s * pitch + p] * w_s[s] : 0.f; },
        [&](int p, int n) {
          return p < P && n < N ? dho[static_cast<int64_t>(n) * P + p] : 0.f;
        });
    for_acc(r0, n0, [&](int s, int n, int nt, int i) {
      if (s < Lc && n < N)
        dbh[((row0 + s) * H + h) * N + n] = acc[nt][i];
    });
  }

  // dC for this head: GE dt . B + exp(seg) dy . h_in^T (the state entering
  // the first chunk is zero), and r = C . the second term row by row
  for (int job = warp; job < jobs_n; job += NWARPS) {
    const int r0 = (job % nrt) * 16, n0 = (job / nrt) * 64;
    if (r0 >= Lc) continue;
    float ai[BJ][4] = {}, ax[BJ][4] = {};
    warp_gemm(
        ai, r0, n0, 0, min(r0 + 16, Lc),
        [&](int t, int s) { return s < Lc ? ge_s[t * lp + s] * dt_s[s] : 0.f; },
        [&](int s, int n) {
          return s < Lc && n < N ? bc[static_cast<int64_t>(s) * N + n] : 0.f;
        });
    if (c > 0)
      warp_gemm(
          ax, r0, n0, 0, P,
          [&](int t, int p) {
            return p < P ? dy_s[t * pitch + p] * es_s[t] : 0.f;
          },
          [&](int p, int n) {
            return p < P && n < N ? hin[static_cast<int64_t>(n) * P + p] : 0.f;
          });
    float r[2] = {0.f, 0.f};
    for_acc(r0, n0, [&](int t, int n, int nt, int i) {
      if (t < Lc && n < N) {
        dch[((row0 + t) * H + h) * N + n] = ai[nt][i] + ax[nt][i];
        r[i >> 1] += ax[nt][i] * cc[static_cast<int64_t>(t) * N + n];
      }
    });
    r[0] = quad_sum(r[0]);
    r[1] = quad_sum(r[1]);
    if (q == 0) {
      rp_s[(r0 + g) * ncn + job / nrt] = r[0];
      rp_s[(r0 + g + 8) * ncn + job / nrt] = r[1];
    }
  }

  // x . dy over the chunk (for dD) and <dh, h_in>, each summed in a fixed
  // order
  float pd = 0.f, ph = 0.f;
  for (int e = tid; e < Lc * P; e += THREADS)
    pd += x_s[(e / P) * pitch + e % P] * dy_s[(e / P) * pitch + e % P];
  for (int e = tid; e < N * P; e += THREADS) ph += dho[e] * hin[e];
  red_s[tid] = pd;
  __syncthreads();  // also: rows_s, cols_s, up_s and rp_s are complete
  float sum_d = 0.f;
  if (tid == 0)
    for (int i = 0; i < THREADS; ++i) sum_d += red_s[i];
  __syncthreads();
  red_s[tid] = ph;
  __syncthreads();
  if (tid != 0) return;
  float hdot = 0.f;
  for (int i = 0; i < THREADS; ++i) hdot += red_s[i];

  // d(seg) per step, its reverse cumsum, ddt and the chunk's dA
  float uw = 0.f;
  for (int t = 0; t < Lc; ++t) {
    float u = 0.f, r = 0.f;
    for (int j = 0; j < ncp; ++j) u += up_s[t * ncp + j];
    for (int j = 0; j < ncn; ++j) r += rp_s[t * ncn + j];
    u_s[t] = u;
    dseg_s[t] = rows_s[t] - dt_s[t] * cols_s[t] + r - u * w_s[t];
    uw += u * w_s[t];
  }
  dseg_s[Lc - 1] += es_s[Lc - 1] * hdot + uw;
  float rc = 0.f, da = 0.f;
  for (int t = Lc - 1; t >= 0; --t) {
    rc += dseg_s[t];
    ddt[(row0 + t) * H + h] = cols_s[t] + u_s[t] * el_s[t] + A * rc;
    da += dt_s[t] * rc;
  }
  part[bch * 2] = sum_d;
  part[bch * 2 + 1] = da;
}

// (d) dB, dC: the per-head scratch summed over the heads; dD, da_log: the
// per-chunk sums summed over (b, chunk); each output by one thread, in
// order
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dbh,
                      const float* __restrict__ dch,
                      const float* __restrict__ part,
                      const float* __restrict__ a_log, float* __restrict__ db,
                      float* __restrict__ dc, float* __restrict__ da_log,
                      float* __restrict__ dd, int64_t BS, int H, int N,
                      int n_parts) {
  const int64_t BSN = BS * N, total = 2 * BSN + H;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * THREADS) {
    if (e < 2 * BSN) {
      const bool is_b = e < BSN;
      const int64_t o = is_b ? e : e - BSN;
      const float* src = (is_b ? dbh : dch) + (o / N) * H * N + o % N;
      float v = 0.f;
      for (int hh = 0; hh < H; ++hh) v += src[static_cast<int64_t>(hh) * N];
      (is_b ? db : dc)[o] = v;
    } else {
      const int hh = static_cast<int>(e - 2 * BSN);
      float sd = 0.f, sa = 0.f;
      for (int i = 0; i < n_parts; ++i) {
        sd += part[(static_cast<int64_t>(i) * H + hh) * 2];
        sa += part[(static_cast<int64_t>(i) * H + hh) * 2 + 1];
      }
      dd[hh] = sd;
      da_log[hh] = -expf(a_log[hh]) * sa;
    }
  }
}

// the backward's scratch, carved from one workspace of
// ssd_scan_bwd_work_floats floats: the C.B^T scratch, the state gradients,
// dB and dC per head, the per-chunk sums (each region a multiple of 4
// floats)
struct BwdWork {
  float *cb, *dstates, *dbh, *dch, *part;
  size_t floats;
};

BwdWork bwd_work(float* base, int B, int S, int H, int P, int N, int L) {
  const size_t nc = (S + L - 1) / L;
  const size_t sizes[5] = {
      static_cast<size_t>(B) * nc * L * cb_pitch(L),
      static_cast<size_t>(B) * nc * H * N * P,
      static_cast<size_t>(B) * S * H * N, static_cast<size_t>(B) * S * H * N,
      static_cast<size_t>(B) * nc * H * 2};
  float* p[5];
  size_t off = 0;
  for (int i = 0; i < 5; ++i) {
    p[i] = base == nullptr ? nullptr : base + off;
    off += (sizes[i] + 3) / 4 * 4;
  }
  return {p[0], p[1], p[2], p[3], p[4], off};
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
  const size_t a = dstate_smem_floats(chunk, P, N);
  const size_t b = chunk_smem_floats(chunk, P, N);
  return sizeof(float) * (a > b ? a : b);
}

// The backward's four launches, each checked: dx (B, S, H, P), ddt
// (B, S, H), da_log (H,), db and dc (B, S, N), dd (H,) of y = SSD(x, dt,
// a_log, b, c, d_skip) for dy (B, S, H, P), from the forward's chunk states
// (B, n_chunks, H, N, P) and dh_final (B, H, N, P), the final state's
// gradient, or null. work holds ssd_scan_bwd_work_floats floats. Returns a
// cudaError_t (0 = success).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdWork w = bwd_work(static_cast<float*>(work), B, S, H, P, N, L);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = launch_cb(bm, cm, w.cb, B, S, N, L, st);
  if (err != cudaSuccess) return err;

  size_t smem = sizeof(float) * dstate_smem_floats(L, P, N);
  err = cudaFuncSetAttribute(ssd_bwd_dstate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_bwd_dstate_kernel<<<B * H, THREADS, smem, st>>>(
      f(dt), f(a_log), f(cm), f(dy), f(dh_final), w.dstates, S, H, P, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  smem = sizeof(float) * chunk_smem_floats(L, P, N);
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<<<dim3(n_chunks, H, B), THREADS, smem, st>>>(
      f(x), f(dt), f(a_log), f(bm), f(cm), f(d_skip), f(dy), w.cb,
      f(states), w.dstates, static_cast<float*>(dx), static_cast<float*>(ddt),
      w.dbh, w.dch, w.part, S, H, P, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t BS = static_cast<int64_t>(B) * S;
  const int64_t outs = 2 * BS * N + H;
  const int blocks = static_cast<int>(
      outs / THREADS + 1 < 132 * 16 ? outs / THREADS + 1 : 132 * 16);
  ssd_bwd_reduce_kernel<<<blocks, THREADS, 0, st>>>(
      w.dbh, w.dch, w.part, f(a_log), static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(da_log),
      static_cast<float*>(dd), BS, H, N, B * n_chunks);
  return cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
