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
// Two kinds of launches compute it (kernels.ssd_scan.ssd_fwd_kind picks
// one before the launch): the wgmma kind, entry ssd_scan_fwd_sm90, for the
// Mamba2 / Zamba2 widths (P 64, N 64 or 128, chunks of at most 128 steps;
// four launches, "forward, wgmma (sm90)" below) where B x H leaves the
// mma.sync kind's grid short of filling the card, and the mma.sync kind
// here, entry ssd_scan_fwd, which takes every shape and is the faster
// where its grid fills the card (mamba2's serve prefill of 4 rows).
//
// The mma.sync kind, two launches:
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
// (H,); cb scratch (B, n_chunks, L, ssd_cb_pitch(L)) (the wgmma kind: a
// workspace, fwd_work_sm90); h_out (B, H, N, P) or null; states (B,
// n_chunks, H, N, P), the state entering each chunk, or null. All f32 and
// contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
              float* __restrict__ cb, int S, int N, int L, int Lq, int vec) {
  __shared__ float part[CB_WARPS][16 * 32];
  const int c = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int t0 = c * L, Lc = min(L, S - t0);
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

// (a) into cb (B, n_chunks, L, Lq), Lq even and at least L
cudaError_t launch_cb(const void* bm, const void* cm, void* cb, int B, int S,
                      int N, int L, int Lq, cudaStream_t stream) {
  const dim3 grid((S + L - 1) / L, B, ((L + 15) / 16) * ((L + 31) / 32));
  ssd_cb_kernel<<<grid, CB_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(cb), S, N, L, Lq,
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
// which dy . h_in^T could give. Two kinds of launches compute it
// (kernels.ssd_scan.ssd_bwd_kind picks one before the launch): the
// mma.sync kind here, entry ssd_scan_bwd, which takes every shape (at
// about 9x the bound, PERF.md §6), and the wgmma kind further down, entry
// ssd_scan_bwd_sm90, for the Mamba2 / Zamba2 widths (P 64, N 64 or 128,
// chunks of at most 128 steps).
//
// The mma.sync kind, six launches, each grid wide enough to fill the card:
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


// ------------------------------------------------- backward, wgmma (sm90) --
//
// The three launches that carry the backward's products (local, chunk,
// dB/dC), redesigned for Hopper: the wrapper's kind "wgmma"
// (kernels.ssd_scan.ssd_bwd_kind: P 64, N 64 or 128, chunks of at most 128
// steps; other shapes keep the mma.sync launches above). C.B^T, the
// passing and the sums are the launches above; the chunk step's per-head
// d(seg) scan is a launch of its own (ssd_bwd_finish_kernel): seven
// launches. What held the mma.sync forms back (about 9x the bound, ~17 %
// of the 3xTF32 rate): m16n8k8 products whose operand fragments each warp
// loads itself, operands staged by the threads (209 KB of pre-split x, dy
// and states in the chunk block, leaving no room to stage the next head).
// What bounds the new launches (PERF.md §6): dB/dC and local mostly the
// bytes they stream (x, dy, the states and their gradients: ~0.5 GB at
// mamba2's train shape for dB/dC alone), the chunk block its conversions
// and the L2 traffic of re-reading B, C and C.B^T for every head.
// What this design does:
// 1. Every product is a TF32 wgmma in 3xTF32 (hopper.cuh: a_lo.b_hi +
//    a_hi.b_lo + a_hi.b_hi into one accumulator), a warpgroup's 64 rows at
//    a time. TF32 reads both operands K-major; several operands lie the
//    other way in memory (dy as the B of M^T.dy and of the local state
//    gradient, the state gradient and the chunk state as the B of B.dh and
//    C.h_in, C and B as the B of dB's and dC's step sums). Since every
//    operand has to be split into hi and lo by the threads anyway, that
//    pass also transposes: A is built in registers from the raw tile in
//    whatever layout it lies (with its scale, its causal mask and the
//    decay applied), B is written K-major as a hi and a lo tile of 128-byte
//    swizzled rows, which the product reads by descriptor.
// 2. Raw tiles arrive by TMA (boxes of 32 f32 columns, 128-byte swizzle,
//    zeros past the tensors' edges) into a ring of 3 or 4 stages with a
//    full and an empty mbarrier each, fed by one producer thread; the
//    chunk block's ring runs over the heads, so the next head's tiles are
//    in flight while this one computes.
// 3. Two consumer warpgroups, each on its own: each converts its own B
//    (the two never wait for each other inside a product). In the local
//    and dB/dC blocks each pipelines its products (pipelined_product):
//    tile i's operands are split into one of two B buffers and register
//    sets while tile i - 1's products run; the chunk block's products
//    wait for each tile (pipelined there, ptxas runs out of registers
//    and serializes every wgmma: its C7512 note, which the build phase
//    refuses), so its two warpgroups overlap each other instead. A third
//    warpgroup holds the producer thread and gives its registers to the
//    consumers (setmaxnreg 72 / 216; a block of 288 threads would leave
//    each 168, as 384 do).
// 4. The per-head vectors (dt, seg, exp(seg), w) are computed once, in the
//    local launch, for every chunk, and brought to the chunk and dB/dC
//    blocks by bulk copies. The chunk block keeps its group's GE_sum in
//    shared memory and writes each head's per-step parts (row and column
//    sums, u, r, the dD and <dh, h_in> parts) to the workspace, where the
//    finish launch, a warp a head, turns them into d(seg), ddt and the
//    chunk's dD and dA sums.
// The guards of the mma.sync forms hold: no float atomics (every sum in a
// fixed order, two calls give the same bits); exp(seg_t - seg_s) is
// evaluated only under the causal mask and masked entries are selected to
// 0; a ragged last chunk runs its true length Lc (rows past it are masked
// wherever they are read, zeros past S from TMA); dh_final may be null.

constexpr int S9_CONSUMERS = 256;               // two consumer warpgroups
constexpr int S9_THREADS = S9_CONSUMERS + 128;  // and the producer's
// registers a thread after setmaxnreg: the producer warpgroup's copies need
// few, the consumers' conversions and products many
constexpr int S9_PRODUCER_REGS = 72, S9_CONSUMER_REGS = 216;
// setmaxnreg moves registers only within what the block was given at
// launch: 168 a thread (__launch_bounds__(384, 1)), not the SM's 65,536 (a
// split summing to 65,536 faults)
static_assert(128 * S9_PRODUCER_REGS + S9_CONSUMERS * S9_CONSUMER_REGS <=
                  S9_THREADS * 168,
              "setmaxnreg.inc asks for registers the block does not have");
constexpr int S9_LP = 128;                     // a chunk's steps, padded
constexpr uint32_t S9_STAGE = 32768;           // bytes of a ring stage
constexpr uint32_t S9_BOX32 = 32 * 128;        // a box of 32 x 32 f32
constexpr uint32_t S9_BOX128 = 128 * 128;      // a box of 128 x 32 f32
constexpr int S9_LOCAL_GROUP = 8;              // heads a local block takes
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

template <typename T>
constexpr size_t sm90_smem_bytes() {
  return sizeof(T) + 1024;  // room to align the base to 1024
}

// this thread's place in its consumer warpgroup (tid 0..127 in it)
struct Wg {
  int wg, tid, warp, lane, g, q;
};

__device__ __forceinline__ Wg wg_of() {
  const int t = threadIdx.x;
  return {t / 128, t % 128, t % 128 / 32, t % 32, t % 32 / 4, t % 4};
}

__device__ __forceinline__ float lds(const unsigned char* base, uint32_t off) {
  return *reinterpret_cast<const float*>(base + off);
}

// A fragments of one k-tile of 32 (4 k-steps) for the warpgroup's 64 rows,
// split into hi and lo: elem(r, k) is the f32 value at row r (0..63) and
// column k (0..31)
template <class F>
__device__ __forceinline__ void make_a(uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4], const Wg& w,
                                       const F& elem) {
  const int r0 = 16 * w.warp + w.g, q = w.q;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = 8 * kk + q;
    const float v[4] = {elem(r0, k), elem(r0 + 8, k), elem(r0, k + 4),
                        elem(r0 + 8, k + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const mma::Split s = mma::split(v[i]);
      ah[kk][i] = s.hi;
      al[kk][i] = s.lo;
    }
  }
}

// rows [0, rows) of a raw tile (128-byte swizzled rows, starting at a row
// that is a multiple of 8) as B's hi and lo tiles of the same layout, by
// the warpgroup's 128 threads, 16 bytes a thread a step
__device__ __forceinline__ void split_tile(unsigned char* bhi,
                                           unsigned char* blo,
                                           const unsigned char* raw, int rows,
                                           int tid) {
#pragma unroll 2
  for (int c = tid; c < rows * 8; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(raw + 16 * c);
    const mma::Split s0 = mma::split(v.x), s1 = mma::split(v.y),
                     s2 = mma::split(v.z), s3 = mma::split(v.w);
    *reinterpret_cast<uint4*>(bhi + 16 * c) =
        make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
    *reinterpret_cast<uint4*>(blo + 16 * c) =
        make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
  }
}

// B (ROWS rows x 32 k) of a raw tile that lies the other way: B(r, k) is
// the element at row k and column col0 + r of a tile held as boxes of 32
// columns, box_bytes apart. Split into hi and lo tiles (K-major,
// swizzled), four k of one row a thread a step (the reads of a warp fall
// along one raw row, its 16-byte stores on distinct banks). With DOT, also
// returns the thread's sum of the elements of B's rows [d0, d0 + 32)
// times the elements at the same places of `dot`, a tile of the raw one's
// layout. With SCALE, each element of raw row k is multiplied by scale[k]
// before it is split.
template <int ROWS, bool DOT, bool SCALE = false>
__device__ __forceinline__ float split_tile_t(
    unsigned char* bhi, unsigned char* blo, const unsigned char* raw,
    uint32_t box_bytes, int col0, int tid,
    const unsigned char* dot = nullptr, int d0 = 0,
    const float* scale = nullptr) {
  float sum = 0.f;
#pragma unroll 2
  for (int it = 0; it < ROWS / 16; ++it) {
    const int pr = it * 128 + tid, r = pr % ROWS, kc = pr / ROWS;
    const int col = col0 + r;
    const uint32_t box = (col >> 5) * box_bytes;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t off = box + hopper::swz32(4 * kc + j, col & 31);
      const float v = SCALE ? scale[4 * kc + j] * lds(raw, off) : lds(raw, off);
      if (DOT && r >= d0 && r < d0 + 32) sum += v * lds(dot, off);
      const mma::Split s = mma::split(v);
      hi[j] = s.hi;
      lo[j] = s.lo;
    }
    const uint32_t o = hopper::swz32(r, 4 * kc);
    *reinterpret_cast<uint4*>(bhi + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(blo + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  return sum;
}

// the consumer side of a ring of ST stages: wait until a stage is full;
// release it (one arrival a warp) once the warpgroup is done with it
template <int ST>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int i;  // tiles consumed so far
  __device__ __forceinline__ int wait() {
    const int s = i % ST;
    hopper::mbar_wait(&full[s], (i / ST) & 1);
    return s;
  }
  __device__ __forceinline__ void release(int s) {
    hopper::mbar_arrive_warp(&empty[s]);
    ++i;
  }
};

// the producer side: stage of tile i, once the consumers released it
template <int ST>
__device__ __forceinline__ int producer_stage(uint64_t* empty, int i) {
  const int s = i % ST;
  if (i >= ST) hopper::mbar_wait(&empty[s], (i / ST - 1) & 1);
  return s;
}

template <int ST>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(&empty[s], S9_CONSUMERS / 32);
  }
}

// a warpgroup's named barrier (ids 1, 2; 3 is both warpgroups')
__device__ __forceinline__ void wg_sync(const Wg& w) {
  hopper::named_bar_sync(1 + w.wg, 128);
}

// the 3xTF32 products of one k-tile of 32 (4 k-steps): acc (64 x NN) +=
// A . B^T, A in registers, B's hi and lo tiles (NN rows, K-major) at
// shared addresses bhi and blo; issued and committed as one group
template <int NN>
__device__ __forceinline__ void issue_tile(float (&acc)[NN / 2],
                                           uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4], uint32_t bhi,
                                           uint32_t blo) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_tf32x3<NN>(acc, ah[kk], al[kk], hopper::desc_tf32(bhi, kk),
                             hopper::desc_tf32(blo, kk));
  hopper::wgmma_commit();
}

// The k-tiles [0, n) of one product of a warpgroup, pipelined: tile i's
// operands are converted while tile i - 1's products run. convert(i,
// stage, bhi, blo, ah, al) splits B into the buffer pair i % 2 of `bhl`
// (hi, then lo, buf_bytes each) and A into register set i % 2; the
// warpgroup's named barrier before it makes sure every warp's products of
// tile i - 2 are done (their wait after tile i - 1), the one after it that
// B is written before any warp issues. A tile for which takes(i) is false
// is skipped, its stage still released. With PIPE false each tile's
// products are waited for before the next is converted (one buffer pair,
// one register set: for a warpgroup short of registers). Returns with
// every product done.
template <int NN, int ST, bool PIPE = true, class Takes, class Conv>
__device__ __forceinline__ void pipelined_product(float (&acc)[NN / 2],
                                                  Ring<ST>& ring, int n,
                                                  const Wg& w,
                                                  unsigned char* bhl,
                                                  uint32_t buf_bytes,
                                                  const Takes& takes,
                                                  const Conv& convert) {
  constexpr int NB = PIPE ? 2 : 1;  // register sets and B buffer pairs
  uint32_t ah[NB][4][4], al[NB][4][4];
  hopper::fence_operand(acc);
  const auto step = [&](auto buf, int i) {
    constexpr int b = decltype(buf)::value % NB;
    const int s = ring.wait();
    if (!takes(i)) {
      ring.release(s);
      hopper::wgmma_wait<0>();  // the buffers are free again
      return;
    }
    unsigned char* bhi = bhl + b * 2 * buf_bytes;
    unsigned char* blo = bhi + buf_bytes;
    wg_sync(w);
    convert(i, s, bhi, blo, ah[b], al[b]);
    hopper::fence_proxy_async();
    wg_sync(w);
    ring.release(s);
    issue_tile<NN>(acc, ah[b], al[b], hopper::smem_u32(bhi),
                   hopper::smem_u32(blo));
    if constexpr (PIPE) {
      hopper::wgmma_wait<1>();  // tile i - 1's products are done
      hopper::fence_operand(ah[(b + 1) % NB]);
      hopper::fence_operand(al[(b + 1) % NB]);
    } else {
      hopper::wgmma_wait<0>();
      hopper::fence_operand(ah[b]);
      hopper::fence_operand(al[b]);
    }
  };
  for (int i = 0; i < n; i += 2) {
    step(std::integral_constant<int, 0>{}, i);
    if (i + 1 < n) step(std::integral_constant<int, 1>{}, i + 1);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operand(acc);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    hopper::fence_operand(ah[b]);
    hopper::fence_operand(al[b]);
  }
}

__device__ __forceinline__ bool every_tile(int) { return true; }

// One chunk's per-head vectors by one warp, lane l taking steps 4l .. 4l +
// 3, from the head's dt column (dtc[t H], t < Lc): dt, seg (the in-chunk
// cumsum of dt A, in units of `unit`), exp(seg) and, where wsv is not
// null, w = exp(seg_L - seg) dt into the workspace rows dtv, segv, esv,
// wsv, zero past the chunk's length (seg there: its last value); the
// chunk's decay exp(seg_L) into *decay; the lane's exp(seg) and w in e and
// wv.
__device__ __forceinline__ void chunk_vectors(
    const float* __restrict__ dtc, int H, float A, int Lc, int lane,
    float unit, float* dtv, float* segv, float* esv, float* wsv,
    float* decay, float (&e)[4], float (&wv)[4]) {
  float d[4], sg[4];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    d[j] = t < Lc ? dtc[static_cast<int64_t>(t) * H] : 0.f;
    run += d[j] * A;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  float acc = inc - run;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc += d[j] * A;
    sg[j] = acc;
  }
  // seg of the chunk's last step, from the lane that holds it
  const int last = Lc - 1;
  const float mine = (last & 3) == 0   ? sg[0]
                     : (last & 3) == 1 ? sg[1]
                     : (last & 3) == 2 ? sg[2]
                                       : sg[3];
  const float total = __shfl_sync(0xffffffffu, mine, last >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = 4 * lane + j < Lc;
    if (!ok) sg[j] = total;
    e[j] = ok ? expf(sg[j]) : 0.f;
    wv[j] = ok ? expf(total - sg[j]) * d[j] : 0.f;
  }
  const int o = 4 * lane;
  *reinterpret_cast<float4*>(dtv + o) = make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<float4*>(segv + o) =
      make_float4(unit * sg[0], unit * sg[1], unit * sg[2], unit * sg[3]);
  *reinterpret_cast<float4*>(esv + o) = make_float4(e[0], e[1], e[2], e[3]);
  if (wsv != nullptr)
    *reinterpret_cast<float4*>(wsv + o) =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
  if (lane == 0) *decay = expf(total);
}

// (b') The per-head vectors of chunk c of heads [h0, h0 + 8) of batch row b
// (item blockIdx.x = ((b n_chunks + c) groups + group)): dt, seg (the
// in-chunk cumsum of dt A), exp(seg) and w = exp(seg_L - seg) dt, each
// (B, n_chunks, H, S9_LP), zero past the chunk's length (seg there: its
// last value), one consumer warp a head; the chunk's decay exp(seg_L);
// and, for c >= 1, the chunk's own part of the state gradient,
// local_c[n, p] = sum_t exp(seg_t) C_t[n] dy_t[p], into dstates' slot
// c - 1. That product is (C^T) (exp(seg) o dy): M = n, N = p (64), K = the
// chunk's steps in k-tiles of 32; A from the chunk's C, brought once by
// TMA as 128-step boxes and read transposed with exp(seg) applied; B, dy's
// 32 x 64 tile of each head and k-tile, through the ring, transposed as it
// is split. At N 128 warpgroup j takes rows n of [64 j, 64 j + 64) of
// every head; at N 64 each takes every other head.
constexpr int S9_LOCAL_STAGES = 4;

template <int NS>
struct LocalSm90Smem {
  unsigned char cbuf[NS / 32][S9_BOX128];  // C: 128 steps x 32 n
  unsigned char stage[S9_LOCAL_STAGES][2 * S9_BOX32];  // dy: 32 x 64 p
  unsigned char bhl[2][2 * 2 * 64 * 128];  // per warpgroup: 2 x (hi, lo)
  float es[S9_LOCAL_GROUP][S9_LP];
  uint64_t c_full, full[S9_LOCAL_STAGES], empty[S9_LOCAL_STAGES];
};

template <int NS>
__global__ void __launch_bounds__(S9_THREADS, 1)
ssd_bwd_local_sm90_kernel(const __grid_constant__ CUtensorMap tm_c128,
                          const __grid_constant__ CUtensorMap tm_dy32,
                          const float* __restrict__ dt,
                          const float* __restrict__ a_log,
                          float* __restrict__ dstates,
                          float* __restrict__ decay, float* __restrict__ dtv,
                          float* __restrict__ segv, float* __restrict__ esv,
                          float* __restrict__ wsv, int S, int H, int L) {
  using Smem = LocalSm90Smem<NS>;
  constexpr int ST = S9_LOCAL_STAGES;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tid = threadIdx.x;
  const int n_chunks = (S + L - 1) / L;
  const int ngl = (H + S9_LOCAL_GROUP - 1) / S9_LOCAL_GROUP;
  const int grp = blockIdx.x % ngl, bc = blockIdx.x / ngl;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int h0 = grp * S9_LOCAL_GROUP, nh = min(S9_LOCAL_GROUP, H - h0);
  const int n_kt = (Lc + 31) / 32;
  if (tid == 0) {
    hopper::mbar_init(&sm.c_full, 1);
    init_ring<ST>(sm.full, sm.empty);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= S9_CONSUMERS) {  // the producer warpgroup
    hopper::reg_dealloc<S9_PRODUCER_REGS>();
    if (tid == S9_CONSUMERS && c > 0) {
      hopper::mbar_arrive_expect_tx(&sm.c_full, NS / 32 * S9_BOX128);
#pragma unroll
      for (int nb = 0; nb < NS / 32; ++nb)
        hopper::tma_load_3d(sm.cbuf[nb], &tm_c128, &sm.c_full, 32 * nb, t0, b);
      for (int i = 0; i < nh * n_kt; ++i) {
        const int s = producer_stage<ST>(sm.empty, i);
        const int h = h0 + i / n_kt, k = i % n_kt;
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * S9_BOX32);
        hopper::tma_load_4d(sm.stage[s], &tm_dy32, &sm.full[s], 0, h,
                            t0 + 32 * k, b);
        hopper::tma_load_4d(sm.stage[s] + S9_BOX32, &tm_dy32, &sm.full[s], 32,
                            h, t0 + 32 * k, b);
      }
    }
    return;
  }
  hopper::reg_alloc<S9_CONSUMER_REGS>();

  // the vectors, one warp a head
  const int warp = tid / 32, lane = tid % 32;
  if (warp < nh) {
    const int h = h0 + warp;
    const int64_t o = (static_cast<int64_t>(bc) * H + h) * S9_LP;
    float e[4], wv[4];
    chunk_vectors(dt + (static_cast<int64_t>(b) * S + t0) * H + h, H,
                  -expf(a_log[h]), Lc, lane, 1.f, dtv + o, segv + o, esv + o,
                  wsv + o, decay + static_cast<int64_t>(bc) * H + h, e, wv);
    *reinterpret_cast<float4*>(&sm.es[warp][4 * lane]) =
        make_float4(e[0], e[1], e[2], e[3]);
  }
  if (c == 0) return;  // the first chunk's state gradient has no local part
  hopper::named_bar_sync(3, S9_CONSUMERS);  // es of every head is in

  const Wg w = wg_of();
  const int n0 = NS == 128 ? 64 * w.wg : 0;  // this warpgroup's rows n
  hopper::mbar_wait(&sm.c_full, 0);
  Ring<ST> ring{sm.full, sm.empty, 0};
  float acc[32];
  for (int hl = 0; hl < nh; ++hl) {
    const bool mine = NS == 128 || hl % 2 == w.wg;
    const float* es_h = sm.es[hl];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    pipelined_product<64, ST>(
        acc, ring, n_kt, w, sm.bhl[w.wg], 64 * 128,
        [&](int) { return mine; },
        [&](int k, int s, unsigned char* bhi, unsigned char* blo,
            uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
          split_tile_t<64, false>(bhi, blo, sm.stage[s], S9_BOX32, 0, w.tid);
          make_a(ah, al, w, [&](int r, int kk) {
            const int t = 32 * k + kk, n = n0 + r;
            return t < Lc ? es_h[t] *
                                lds(sm.cbuf[n >> 5], hopper::swz32(t, n & 31))
                          : 0.f;
          });
        });
    if (!mine) continue;
    float* out = dstates + ((static_cast<int64_t>(bc) - 1) * H + h0 + hl) *
                               static_cast<int64_t>(NS) * 64;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + 16 * w.warp + w.g + 8 * hf, p = 8 * jb + 2 * w.q;
        *reinterpret_cast<float2*>(out + n * 64 + p) =
            make_float2(acc[4 * jb + 2 * hf], acc[4 * jb + 2 * hf + 1]);
      }
  }
}

// (d') The per-head gradients of chunk c for a group of BWD_GROUP heads,
// as (d) computes them, with each product a wgmma over a warpgroup's 64
// steps (warpgroup j owns steps [64 j, 64 j + 64) of every per-step
// output). Per head, through the ring:
//   G = dy . x^T (K = p, 2 k-tiles; warpgroup 0 takes columns s < 64 and
//     warpgroup 1 all 128, the causal half), then GE = G exp(seg_t - seg_s)
//     under the mask, its sums against C.B^T (rows in the warp, columns a
//     part a warp) and dt_s GE into the group's GE_sum, in shared memory;
//   B . dh (K = n), then u = x . (B . dh) and the scale by w, then
//     M^T . dy into the same accumulator (K = t; warpgroup 1 starts at
//     t = 64), dx = that + D dy;
//   C . h_in (K = n; not for the first chunk, whose state is zero), r =
//     exp(seg) dy . (C . h_in), and <dh, h_in> from the tiles on the way.
// A head's per-step parts go to the workspace for the finish launch (d'');
// each consumer warp then releases the head's vectors, and the producer
// loads the vectors of the head two later into their slot. Persistent:
// block blockIdx.x takes items blockIdx.x, + gridDim.x, ... of (b, chunk,
// group).
constexpr int S9_CHUNK_STAGES = 3;
constexpr int S9_GS_PITCH = 128 + 8, S9_GS0_PITCH = 64 + 8;
// floats of one head's per-step parts in the workspace: the row sums, u,
// r, eight warps' column-sum parts, eight warps' x . dy and <dh, h_in>
constexpr int S9_PARTS = 3 * S9_LP + 8 * S9_LP + 16;
constexpr int S9_P_U = S9_LP, S9_P_R = 2 * S9_LP, S9_P_CS = 3 * S9_LP,
              S9_P_RED = 11 * S9_LP;

template <int NS>
struct ChunkSm90Smem {
  unsigned char stage[S9_CHUNK_STAGES][S9_STAGE];
  // B's hi and lo tiles: two of 64 rows for each warpgroup, which
  // warpgroup 1's G (not pipelined) takes as one of 128 rows
  unsigned char bhl0[2 * 2 * 64 * 128];
  unsigned char bhl1[2 * 2 * 64 * 128];
  // the warpgroups' GE_sum tiles, 64 x 64 and 64 x 128 (rows padded to 72
  // and 136 floats: the float2 accesses of a half-warp on distinct banks),
  // in shared memory: in registers they leave ptxas too few
  float gs0[64 * S9_GS0_PITCH];
  float gs1[64 * S9_GS_PITCH];
  float vec[2][4][S9_LP];            // a head's dt, seg, exp(seg), w
  uint64_t full[S9_CHUNK_STAGES], empty[S9_CHUNK_STAGES], vfull[2],
      vempty[2];
};

struct ChunkArgs {
  const float *d_skip, *x, *dy, *cb, *dtv, *segv, *esv, *wsv;
  float *dx, *gesum, *parts;
  int B, S, H, L;
};

// the tiles of one head, in the order both sides walk them: (a) 2, (b)
// NS / 32, (c) one per 32 of the chunk's steps, (d) NS / 32 where c > 0
template <int NS>
__device__ __forceinline__ void chunk_produce_head(
    ChunkSm90Smem<NS>& sm, int& i, const CUtensorMap* tm_x128,
    const CUtensorMap* tm_dy128, const CUtensorMap* tm_dy32,
    const CUtensorMap* tm_b128, const CUtensorMap* tm_c128,
    const CUtensorMap* tm_states, const CUtensorMap* tm_dstates,
    const CUtensorMap* tm_cb, int b, int bc, int c, int h, int H, int t0,
    int n_kc) {
  const int row = (bc * H + h) * NS;  // the head's state rows
  for (int k = 0; k < 2; ++k, ++i) {
    const int s = producer_stage<S9_CHUNK_STAGES>(sm.empty, i);
    unsigned char* st = sm.stage[s];
    hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * S9_BOX128);
    hopper::tma_load_4d(st, tm_dy128, &sm.full[s], 32 * k, h, t0, b);
    hopper::tma_load_4d(st + S9_BOX128, tm_x128, &sm.full[s], 32 * k, h, t0,
                        b);
  }
  for (int k = 0; k < NS / 32; ++k, ++i) {
    const int s = producer_stage<S9_CHUNK_STAGES>(sm.empty, i);
    unsigned char* st = sm.stage[s];
    hopper::mbar_arrive_expect_tx(&sm.full[s], S9_BOX128 + 2 * S9_BOX32);
    hopper::tma_load_3d(st, tm_b128, &sm.full[s], 32 * k, t0, b);
    hopper::tma_load_2d(st + S9_BOX128, tm_dstates, &sm.full[s], 0,
                        row + 32 * k);
    hopper::tma_load_2d(st + S9_BOX128 + S9_BOX32, tm_dstates, &sm.full[s],
                        32, row + 32 * k);
  }
  for (int k = 0; k < n_kc; ++k, ++i) {
    const int s = producer_stage<S9_CHUNK_STAGES>(sm.empty, i);
    unsigned char* st = sm.stage[s];
    // C.B^T's boxes of columns s <= the tile's last step only (the causal
    // half: the consumers read no other)
    hopper::mbar_arrive_expect_tx(&sm.full[s],
                                  (k + 1) * S9_BOX32 + 2 * S9_BOX32);
    for (int sb = 0; sb <= k; ++sb)
      hopper::tma_load_3d(st + sb * S9_BOX32, tm_cb, &sm.full[s], 32 * sb,
                          32 * k, bc);
    hopper::tma_load_4d(st + S9_BOX128, tm_dy32, &sm.full[s], 0, h,
                        t0 + 32 * k, b);
    hopper::tma_load_4d(st + S9_BOX128 + S9_BOX32, tm_dy32, &sm.full[s], 32,
                        h, t0 + 32 * k, b);
  }
  if (c == 0) return;
  for (int k = 0; k < NS / 32; ++k, ++i) {
    const int s = producer_stage<S9_CHUNK_STAGES>(sm.empty, i);
    unsigned char* st = sm.stage[s];
    hopper::mbar_arrive_expect_tx(&sm.full[s], S9_BOX128 + 4 * S9_BOX32);
    hopper::tma_load_3d(st, tm_c128, &sm.full[s], 32 * k, t0, b);
#pragma unroll
    for (int pb = 0; pb < 2; ++pb) {
      hopper::tma_load_2d(st + S9_BOX128 + pb * S9_BOX32, tm_states,
                          &sm.full[s], 32 * pb, row + 32 * k);
      hopper::tma_load_2d(st + S9_BOX128 + (2 + pb) * S9_BOX32, tm_dstates,
                          &sm.full[s], 32 * pb, row + 32 * k);
    }
  }
}

// the pair of warpgroup wg's GE_sum tile (in shared memory) at places 2 hf,
// 2 hf + 1 of n-block jb of the thread's accumulator layout
template <int NS, int NG>
__device__ __forceinline__ float2& gs_at(ChunkSm90Smem<NS>& sm, const Wg& w,
                                         int jb, int hf) {
  const int row = 16 * w.warp + w.g + 8 * hf, col = 8 * jb + 2 * w.q;
  return *reinterpret_cast<float2*>(
      NG == 64 ? &sm.gs0[row * S9_GS0_PITCH + col]
               : &sm.gs1[row * S9_GS_PITCH + col]);
}

// zeroes warpgroup wg's GE_sum tile (each thread its own places)
template <int NS, int NG>
__device__ __forceinline__ void gs_clear(ChunkSm90Smem<NS>& sm, const Wg& w) {
#pragma unroll
  for (int jb = 0; jb < NG / 8; ++jb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      gs_at<NS, NG>(sm, w, jb, hf) = make_float2(0.f, 0.f);
}

// stores warpgroup wg's GE_sum tile as rows [NG - 64, NG) of the group's
// partial gsum (S9_LP x S9_LP)
template <int NS, int NG>
__device__ __forceinline__ void gs_store(ChunkSm90Smem<NS>& sm, const Wg& w,
                                         float* gsum) {
  const int rA = NG - 64 + 16 * w.warp + w.g;
#pragma unroll
  for (int jb = 0; jb < NG / 8; ++jb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(gsum + (rA + 8 * hf) * S9_LP + 8 * jb +
                                 2 * w.q) = gs_at<NS, NG>(sm, w, jb, hf);
}

// (a) of one head for warpgroup wg (NG = 64 (wg + 1), the columns s of its
// G tile): G = dy . x^T, A dy's rows, B x's rows s < NG as they lie; then
// GE under the mask (the exponential only there: it overflows above the
// diagonal), its row sums and column-sum parts against C.B^T, and dt_s GE
// into the group's GE_sum. With gs_clear and gs_store, the only part of
// the chunk block templated on
// the warpgroup (two copies of the whole head leave ptxas short of
// registers: it spills). Not pipelined, as the block's other products:
// pipelined, they leave ptxas too few registers and it serializes every
// wgmma (C7512).
template <int NS, int NG>
__device__ __forceinline__ void chunk_head_ge(ChunkSm90Smem<NS>& sm,
                                              const Wg& w,
                                              Ring<S9_CHUNK_STAGES>& ring,
                                              int vs, int Lc,
                                              const float* cbc,
                                              float* parts) {
  const int m0 = NG - 64;                        // this warpgroup's first step
  const int rA = m0 + 16 * w.warp + w.g, rB = rA + 8;  // this thread's rows
  const float* dtv = sm.vec[vs][0];
  const float* segv = sm.vec[vs][1];
  float G[NG / 2];
#pragma unroll
  for (int i = 0; i < NG / 2; ++i) G[i] = 0.f;
  pipelined_product<NG, S9_CHUNK_STAGES, false>(
      G, ring, 2, w, NG == 64 ? sm.bhl0 : sm.bhl1, NG * 128, every_tile,
      [&](int, int s, unsigned char* bhi, unsigned char* blo,
          uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
        const unsigned char* st = sm.stage[s];
        split_tile(bhi, blo, st + S9_BOX128, NG, w.tid);
        make_a(ah, al, w, [&](int r, int kk) {
          return lds(st, hopper::swz32(m0 + r, kk));
        });
      });
  const float sgA = segv[rA] * kLog2e, sgB = segv[rB] * kLog2e;
  float rsA = 0.f, rsB = 0.f;
#pragma unroll
  for (int jb = 0; jb < NG / 8; ++jb) {
    const int s0 = 8 * jb + 2 * w.q;
    // C.B^T's entries under the mask only (rows past Lc and the columns of
    // a pair past its row read nothing)
    const float2 cA = rA < Lc && s0 <= rA
                          ? *reinterpret_cast<const float2*>(cbc + rA * S9_LP +
                                                             s0)
                          : make_float2(0.f, 0.f);
    const float2 cB = rB < Lc && s0 <= rB
                          ? *reinterpret_cast<const float2*>(cbc + rB * S9_LP +
                                                             s0)
                          : make_float2(0.f, 0.f);
    const float cbv[4] = {cA.x, cA.y, cB.x, cB.y};
    float csum[2] = {0.f, 0.f}, gsv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = i < 2 ? rA : rB, sc = s0 + (i & 1);
      const bool ok = sc <= t && t < Lc;
      const float ge = ok ? G[4 * jb + i] *
                                hopper::exp2_ftz((i < 2 ? sgA : sgB) -
                                                 segv[sc] * kLog2e)
                          : 0.f;
      const float gc = ok ? ge * cbv[i] : 0.f;
      if (i < 2)
        rsA += gc * dtv[sc];
      else
        rsB += gc * dtv[sc];
      csum[i & 1] += gc;
      gsv[i] = ge * dtv[sc];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2& g = gs_at<NS, NG>(sm, w, jb, hf);
      g = make_float2(g.x + gsv[2 * hf], g.y + gsv[2 * hf + 1]);
    }
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const float v = column_sum(csum[k2]);
      if (w.g == 0)
        parts[S9_P_CS + (4 * w.wg + w.warp) * S9_LP + s0 + k2] = v;
    }
  }
  rsA = quad_sum(rsA);
  rsB = quad_sum(rsB);
  if (w.q == 0) {
    parts[rA] = rsA;
    parts[rB] = rsB;
  }
}

// warpgroup wg's side of one item: rows (steps) [64 wg, 64 wg + 64) of
// each head's per-step outputs
template <int NS>
__device__ __forceinline__ void chunk_consume_item(
    ChunkSm90Smem<NS>& sm, const ChunkArgs& a, const Wg& w,
    Ring<S9_CHUNK_STAGES>& ring, int& hv, int b, int bc, int c, int grp) {
  const int H = a.H, S = a.S;
  const int n_groups = (H + BWD_GROUP - 1) / BWD_GROUP;
  const int t0 = c * a.L, Lc = min(a.L, S - t0);
  const int n_kc = (Lc + 31) / 32;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;
  const int64_t x_step = static_cast<int64_t>(H) * 64;
  unsigned char* bhl = w.wg == 0 ? sm.bhl0 : sm.bhl1;
  const int m0 = 64 * w.wg;                      // this warpgroup's first step
  const int rA = m0 + 16 * w.warp + w.g, rB = rA + 8;  // this thread's rows
  const int wglob = 4 * w.wg + w.warp;           // the warp in the block
  const float* cbc = a.cb + static_cast<int64_t>(bc) * a.L * S9_LP;
  if (w.wg == 0)
    gs_clear<NS, 64>(sm, w);
  else
    gs_clear<NS, 128>(sm, w);
  const int h_end = min(H, (grp + 1) * BWD_GROUP);
  // A from the rows of this warpgroup's steps of a raw tile as it lies
  const auto rows_a = [&](const unsigned char* st, uint32_t(&ah)[4][4],
                          uint32_t(&al)[4][4]) {
    make_a(ah, al, w,
           [&](int r, int kk) { return lds(st, hopper::swz32(m0 + r, kk)); });
  };

  for (int h = grp * BWD_GROUP; h < h_end; ++h, ++hv) {
    const int vs = hv % 2;
    hopper::mbar_wait(&sm.vfull[vs], (hv / 2) & 1);
    const float* dtv = sm.vec[vs][0];
    const float* segv = sm.vec[vs][1];
    const float* esv = sm.vec[vs][2];
    const float* wv = sm.vec[vs][3];
    const float Dh = a.d_skip[h];
    const int64_t hoff = row0 * x_step + static_cast<int64_t>(h) * 64;
    float* parts = a.parts + (static_cast<int64_t>(bc) * H + h) * S9_PARTS;

    if (w.wg == 0)
      chunk_head_ge<NS, 64>(sm, w, ring, vs, Lc, cbc, parts);
    else
      chunk_head_ge<NS, 128>(sm, w, ring, vs, Lc, cbc, parts);

    // (b) B . dh: A B's rows, B the state gradient's (n, p) tile transposed
    float D[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) D[i] = 0.f;
    pipelined_product<64, S9_CHUNK_STAGES, false>(
        D, ring, NS / 32, w, bhl, 64 * 128, every_tile,
        [&](int, int s, unsigned char* bhi, unsigned char* blo,
            uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
          split_tile_t<64, false>(bhi, blo, sm.stage[s] + S9_BOX128,
                                  S9_BOX32, 0, w.tid);
          rows_a(sm.stage[s], ah, al);
        });
    float pd = 0.f;
    {
      // u = x . (B . dh) row by row, x . dy for dD, then the scale by w
      // and D dy, dx's last term, added before M^T . dy accumulates
      float uA = 0.f, uB = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int sr = hf ? rB : rA;
        if (sr >= Lc) continue;
        const float ws_r = wv[sr];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int p = 8 * jb + 2 * w.q;
          const float2 xv =
              *reinterpret_cast<const float2*>(a.x + hoff + sr * x_step + p);
          const float2 dv =
              *reinterpret_cast<const float2*>(a.dy + hoff + sr * x_step + p);
          float& d0 = D[4 * jb + 2 * hf];
          float& d1 = D[4 * jb + 2 * hf + 1];
          (hf ? uB : uA) += d0 * xv.x + d1 * xv.y;
          pd += xv.x * dv.x + xv.y * dv.y;
          d0 = d0 * ws_r + Dh * dv.x;
          d1 = d1 * ws_r + Dh * dv.y;
        }
      }
      uA = quad_sum(uA);
      uB = quad_sum(uB);
      if (w.q == 0) {
        parts[S9_P_U + rA] = uA;
        parts[S9_P_U + rB] = uB;
      }
    }

    // (c) M^T . dy into the same accumulator: A[s, t] = C.B^T[t, s]
    // exp(seg_t - seg_s) dt_s under the mask (from C.B^T's 32 x 128 tile,
    // read transposed), B dy's (t, p) tile transposed; the k-tiles with a
    // step t >= m0 only
    pipelined_product<64, S9_CHUNK_STAGES, false>(
        D, ring, n_kc, w, bhl, 64 * 128,
        [&](int k) { return 32 * k + 31 >= m0; },
        [&](int k, int s, unsigned char* bhi, unsigned char* blo,
            uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
          const unsigned char* st = sm.stage[s];
          split_tile_t<64, false>(bhi, blo, st + S9_BOX128, S9_BOX32, 0,
                                  w.tid);
          make_a(ah, al, w, [&](int r, int kk) {
            const int sr = m0 + r, t = 32 * k + kk;
            // (boxes sr / 32 <= k came: sr <= t holds only there)
            const bool ok = sr <= t && t < Lc;
            return ok ? lds(st, (sr >> 5) * S9_BOX32 +
                                    hopper::swz32(kk, sr & 31)) *
                            hopper::exp2_ftz((segv[t] - segv[sr]) * kLog2e) *
                            dtv[sr]
                      : 0.f;
          });
        });
    // dx = w (B . dh) + D dy + M^T . dy
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int sr = hf ? rB : rA;
      if (sr >= Lc) continue;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
        *reinterpret_cast<float2*>(a.dx + hoff + sr * x_step + 8 * jb +
                                   2 * w.q) =
            make_float2(D[4 * jb + 2 * hf], D[4 * jb + 2 * hf + 1]);
    }

    // (d) C . h_in: A C's rows, B the chunk state's (n, p) tile
    // transposed, <dh, h_in> over p of [32 wg, 32 wg + 32) on the way
    float ph = 0.f, rA_ = 0.f, rB_ = 0.f;
    if (c > 0) {
      float R[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) R[i] = 0.f;
      pipelined_product<64, S9_CHUNK_STAGES, false>(
          R, ring, NS / 32, w, bhl, 64 * 128, every_tile,
          [&](int, int s, unsigned char* bhi, unsigned char* blo,
              uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
            const unsigned char* st = sm.stage[s];
            ph += split_tile_t<64, true>(bhi, blo, st + S9_BOX128, S9_BOX32,
                                         0, w.tid, st + S9_BOX128 +
                                                       2 * S9_BOX32,
                                         32 * w.wg);
            rows_a(st, ah, al);
          });
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tr = hf ? rB : rA;
        if (tr >= Lc) continue;
        float v = 0.f;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const float2 dv = *reinterpret_cast<const float2*>(
              a.dy + hoff + tr * x_step + 8 * jb + 2 * w.q);
          v += R[4 * jb + 2 * hf] * dv.x + R[4 * jb + 2 * hf + 1] * dv.y;
        }
        (hf ? rB_ : rA_) = v;
      }
    }
    rA_ = quad_sum(rA_);
    rB_ = quad_sum(rB_);
    if (w.q == 0) {
      parts[S9_P_R + rA] = esv[rA] * rA_;
      parts[S9_P_R + rB] = esv[rB] * rB_;
    }
    pd = warp_sum(pd);
    ph = warp_sum(ph);
    if (w.lane == 0) {
      parts[S9_P_RED + wglob] = pd;
      parts[S9_P_RED + 8 + wglob] = ph;
    }
    hopper::mbar_arrive_warp(&sm.vempty[vs]);  // done with the head's vectors
  }
  // the group's GE_sum partial
  float* gsum = a.gesum +
                (static_cast<int64_t>(bc) * n_groups + grp) * S9_LP * S9_LP;
  if (w.wg == 0)
    gs_store<NS, 64>(sm, w, gsum);
  else
    gs_store<NS, 128>(sm, w, gsum);
}

// (d'') A head's d(seg) from the chunk launch's parts, its reverse cumsum,
// ddt and the chunk's dD and dA sums, one warp a (b, chunk, head), as (d)
// ends each head (a launch of its own: inside the chunk block, even on a
// warp of the producer's warpgroup, it left ptxas short of registers)
__global__ void __launch_bounds__(THREADS)
ssd_bwd_finish_kernel(const float* __restrict__ parts,
                      const float* __restrict__ dtv,
                      const float* __restrict__ segv,
                      const float* __restrict__ esv,
                      const float* __restrict__ wsv,
                      const float* __restrict__ a_log,
                      float* __restrict__ ddt, float* __restrict__ part,
                      int S, int H, int L, int64_t n_heads) {
  const int64_t bch = static_cast<int64_t>(blockIdx.x) * NWARPS +
                      threadIdx.x / 32;
  if (bch >= n_heads) return;
  const int lane = threadIdx.x % 32;
  const int n_chunks = (S + L - 1) / L;
  const int h = static_cast<int>(bch % H);
  const int64_t bc = bch / H;
  const int c = static_cast<int>(bc % n_chunks);
  const int64_t row0 = bc / n_chunks * S + static_cast<int64_t>(c) * L;
  const int Lc = min(L, S - c * L);
  const float* pt = parts + bch * S9_PARTS;
  const float* dt = dtv + bch * S9_LP;
  const float* seg = segv + bch * S9_LP;
  const float* wv = wsv + bch * S9_LP;
  const float A = -expf(a_log[h]);
  // d(seg) and the column sums, four steps a lane (lane l: 4l .. 4l + 3)
  float dseg[4], cs[4], uv[4];
  float uw = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    float v = 0.f;
    if (t < 64)
      for (int k = 0; k < 4; ++k) v += pt[S9_P_CS + k * S9_LP + t];
    for (int k = 4; k < 8; ++k) v += pt[S9_P_CS + k * S9_LP + t];
    cs[j] = v;
    uv[j] = pt[S9_P_U + t];
    const bool ok = t < Lc;
    dseg[j] = ok ? pt[t] - dt[t] * v + pt[S9_P_R + t] - uv[j] * wv[t] : 0.f;
    if (ok) uw += uv[j] * wv[t];
  }
  uw = warp_sum(uw);
  float sum_d = 0.f, hdot = 0.f;
  for (int k = 0; k < 8; ++k) {
    sum_d += pt[S9_P_RED + k];
    hdot += pt[S9_P_RED + 8 + k];
  }
  const int last = Lc - 1;
  if (lane == last >> 2) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j == (last & 3)) dseg[j] += esv[bch * S9_LP + last] * hdot + uw;
  }
  // the reverse cumsum over the chunk: each lane's run, then a warp scan
  // of the runs from the chunk's end
  const float run = dseg[0] + dseg[1] + dseg[2] + dseg[3];
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, inc, off);
    if (lane + off < 32) inc += v;
  }
  float rc = inc - run, da = 0.f;  // the sum over the lanes after this one
  const float total = seg[last];
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    const int t = 4 * lane + j;
    rc += dseg[j];
    if (t < Lc) {
      ddt[(row0 + t) * H + h] = cs[j] + uv[j] * expf(total - seg[t]) + A * rc;
      da += dt[t] * rc;
    }
  }
  da = warp_sum(da);
  if (lane == 0) {
    part[bch * 2] = sum_d;
    part[bch * 2 + 1] = da;
  }
}

template <int NS>
__global__ void __launch_bounds__(S9_THREADS, 1)
ssd_bwd_chunk_sm90_kernel(const __grid_constant__ CUtensorMap tm_x128,
                          const __grid_constant__ CUtensorMap tm_dy128,
                          const __grid_constant__ CUtensorMap tm_dy32,
                          const __grid_constant__ CUtensorMap tm_b128,
                          const __grid_constant__ CUtensorMap tm_c128,
                          const __grid_constant__ CUtensorMap tm_states,
                          const __grid_constant__ CUtensorMap tm_dstates,
                          const __grid_constant__ CUtensorMap tm_cb,
                          const __grid_constant__ ChunkArgs a) {
  using Smem = ChunkSm90Smem<NS>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    init_ring<S9_CHUNK_STAGES>(sm.full, sm.empty);
    for (int v = 0; v < 2; ++v) {
      hopper::mbar_init(&sm.vfull[v], 1);
      hopper::mbar_init(&sm.vempty[v], S9_CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int n_chunks = (a.S + a.L - 1) / a.L;
  const int n_groups = (a.H + BWD_GROUP - 1) / BWD_GROUP;
  const int n_items = a.B * n_chunks * n_groups;

  if (tid >= S9_CONSUMERS) {  // the producer warpgroup
    hopper::reg_dealloc<S9_PRODUCER_REGS>();
    if (tid != S9_CONSUMERS) return;
    int i = 0, hv = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int grp = item % n_groups, bc = item / n_groups;
      const int c = bc % n_chunks, b = bc / n_chunks;
      const int t0 = c * a.L, Lc = min(a.L, a.S - t0);
      const int h_end = min(a.H, (grp + 1) * BWD_GROUP);
      for (int h = grp * BWD_GROUP; h < h_end; ++h, ++hv) {
        const int vs = hv % 2;
        const int64_t bch = static_cast<int64_t>(bc) * a.H + h;
        if (hv >= 2) hopper::mbar_wait(&sm.vempty[vs], (hv / 2 - 1) & 1);
        const int64_t o = bch * S9_LP;
        hopper::mbar_arrive_expect_tx(&sm.vfull[vs], 4 * S9_LP * 4);
        hopper::bulk_load(sm.vec[vs][0], a.dtv + o, S9_LP * 4, &sm.vfull[vs]);
        hopper::bulk_load(sm.vec[vs][1], a.segv + o, S9_LP * 4, &sm.vfull[vs]);
        hopper::bulk_load(sm.vec[vs][2], a.esv + o, S9_LP * 4, &sm.vfull[vs]);
        hopper::bulk_load(sm.vec[vs][3], a.wsv + o, S9_LP * 4, &sm.vfull[vs]);
        chunk_produce_head<NS>(sm, i, &tm_x128, &tm_dy128, &tm_dy32, &tm_b128,
                               &tm_c128, &tm_states, &tm_dstates, &tm_cb, b,
                               bc, c, h, a.H, t0, (Lc + 31) / 32);
      }
    }
    return;
  }
  hopper::reg_alloc<S9_CONSUMER_REGS>();

  const Wg w = wg_of();
  Ring<S9_CHUNK_STAGES> ring{sm.full, sm.empty, 0};
  int hv = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int grp = item % n_groups, bc = item / n_groups;
    const int c = bc % n_chunks, b = bc / n_chunks;
    chunk_consume_item<NS>(sm, a, w, ring, hv, b, bc, c, grp);
  }
}

// (e') dB or dC of one (b, chunk), all heads summed, as (e): first over the
// chunk's steps (A = GE_sum^T for dB, GE_sum for dC, its head groups' parts
// summed in order as A is built; B = C or B, 32 steps of all N by TMA,
// transposed as they are split), then over the (h, p) columns (A = w_h x_h
// or exp(seg_h) dy_h, 128 steps x 32 p by TMA with the head's scale row;
// B = the state gradients or the chunk states, N x 32 p, as they lie).
// Warpgroup j takes rows [64 j, 64 j + 64) and all N columns (m64nNk8).
// Block blockIdx.x = 2 (b n_chunks + c) + (0 for dB, 1 for dC).
constexpr int S9_DBDC_STAGES = 3;

template <int NS>
struct DbdcSm90Smem {
  unsigned char stage[S9_DBDC_STAGES][S9_STAGE];  // A 128 x 32 | B N x 32
  unsigned char bhl[2][2 * 2 * NS * 128];  // per warpgroup: 2 x (hi, lo)
  float scale[S9_DBDC_STAGES][S9_LP];
  uint64_t full[S9_DBDC_STAGES], empty[S9_DBDC_STAGES];
};

template <int NS>
__global__ void __launch_bounds__(S9_THREADS, 1)
ssd_bwd_dbdc_sm90_kernel(const __grid_constant__ CUtensorMap tm_x128,
                         const __grid_constant__ CUtensorMap tm_dy128,
                         const __grid_constant__ CUtensorMap tm_states,
                         const __grid_constant__ CUtensorMap tm_dstates,
                         const __grid_constant__ CUtensorMap tm_b32,
                         const __grid_constant__ CUtensorMap tm_c32,
                         const float* __restrict__ wsv,
                         const float* __restrict__ esv,
                         const float* __restrict__ gesum,
                         float* __restrict__ db, float* __restrict__ dc,
                         int S, int H, int L) {
  constexpr int ST = S9_DBDC_STAGES;
  using Smem = DbdcSm90Smem<NS>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tid = threadIdx.x;
  const int n_chunks = (S + L - 1) / L;
  const int n_groups = (H + BWD_GROUP - 1) / BWD_GROUP;
  const bool is_db = blockIdx.x % 2 == 0;
  const int bc = blockIdx.x / 2, c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int n_t1 = (Lc + 31) / 32, n_tiles = n_t1 + 2 * H;
  if (tid == 0) {
    init_ring<ST>(sm.full, sm.empty);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= S9_CONSUMERS) {  // the producer warpgroup
    hopper::reg_dealloc<S9_PRODUCER_REGS>();
    if (tid != S9_CONSUMERS) return;
    const CUtensorMap* am = is_db ? &tm_x128 : &tm_dy128;
    const CUtensorMap* bm = is_db ? &tm_dstates : &tm_states;
    const CUtensorMap* mm = is_db ? &tm_c32 : &tm_b32;
    const float* scale = (is_db ? wsv : esv) +
                         static_cast<int64_t>(bc) * H * S9_LP;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = producer_stage<ST>(sm.empty, i);
      unsigned char* st = sm.stage[s];
      if (i < n_t1) {
        hopper::mbar_arrive_expect_tx(&sm.full[s], NS / 32 * S9_BOX32);
#pragma unroll
        for (int nb = 0; nb < NS / 32; ++nb)
          hopper::tma_load_3d(st + S9_BOX128 + nb * S9_BOX32, mm, &sm.full[s],
                              32 * nb, t0 + 32 * i, b);
      } else {
        const int k = i - n_t1, h = k / 2, p0 = 32 * (k % 2);
        hopper::mbar_arrive_expect_tx(&sm.full[s],
                                      S9_BOX128 + NS * 128 + S9_LP * 4);
        hopper::tma_load_4d(st, am, &sm.full[s], p0, h, t0, b);
        hopper::tma_load_2d(st + S9_BOX128, bm, &sm.full[s], p0,
                            (bc * H + h) * NS);
        hopper::bulk_load(sm.scale[s], scale + h * S9_LP, S9_LP * 4,
                          &sm.full[s]);
      }
    }
    return;
  }
  hopper::reg_alloc<S9_CONSUMER_REGS>();

  const Wg w = wg_of();
  const int m0 = 64 * w.wg;  // this warpgroup's first row
  const float* gsum =
      gesum + static_cast<int64_t>(bc) * n_groups * S9_LP * S9_LP;
  float acc[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
  Ring<ST> ring{sm.full, sm.empty, 0};
  pipelined_product<NS, ST>(
      acc, ring, n_tiles, w, sm.bhl[w.wg], NS * 128, every_tile,
      [&](int i, int s, unsigned char* bhi, unsigned char* blo,
          uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
        const unsigned char* st = sm.stage[s];
        if (i < n_t1) {  // over the steps 32 i + [0, 32)
          split_tile_t<NS, false>(bhi, blo, st + S9_BOX128, S9_BOX32, 0,
                                  w.tid);
          make_a(ah, al, w, [&](int r, int kk) {
            const int m = m0 + r, k = 32 * i + kk;
            const int t = is_db ? k : m, sr = is_db ? m : k;
            float v = 0.f;
            if (sr <= t && t < Lc)
              for (int gr = 0; gr < n_groups; ++gr)
                v += gsum[(static_cast<int64_t>(gr) * S9_LP + t) * S9_LP + sr];
            return v;
          });
        } else {  // over one head's 32 columns of p
          split_tile(bhi, blo, st + S9_BOX128, NS, w.tid);
          const float* sc = sm.scale[s];
          make_a(ah, al, w, [&](int r, int kk) {
            const int m = m0 + r;
            return m < Lc ? lds(st, hopper::swz32(m, kk)) * sc[m] : 0.f;
          });
        }
      });
  float* out = (is_db ? db : dc) + (static_cast<int64_t>(b) * S + t0) * NS;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + 16 * w.warp + w.g + 8 * hf;
    if (m >= Lc) continue;
#pragma unroll
    for (int jb = 0; jb < NS / 8; ++jb)
      *reinterpret_cast<float2*>(out + m * NS + 8 * jb + 2 * w.q) =
          make_float2(acc[4 * jb + 2 * hf], acc[4 * jb + 2 * hf + 1]);
  }
}

// ------------------------------------------------- forward, wgmma (sm90) --
//
// The forward of the Mamba2 / Zamba2 widths (P 64, N 64 or 128, chunks of
// at most 128 steps; kernels.ssd_scan.ssd_fwd_kind picks it before the
// launch, and every other shape keeps (a) and (b) above), redesigned for
// Hopper. It computes what the TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py) computes, plus the final state and the
// chunk states, f32 in and out, every product 3xTF32 (2e-4).
// What held (b) back (7.6x its bound at mamba2-1.3b's train shape, B 2, S
// 4096, H 64: PERF.md §6): one block of 8 warps per (b, h) walking its 32
// chunks in order, 128 blocks for 132 SMs (zamba2's 160: two blocks on 28
// SMs, one on the rest); A operands built element by element from L2 with
// an exp and a hi / lo split each, repeated by every warp job; B operands
// split again at every k-step; B, C and C.B^T re-read for every head.
// What bounds the work: at mamba2's train shape 21.4 GFLOP of products,
// 0.13 ms at 165 TFLOP/s (3xTF32), and the bytes this design moves: x read
// twice, y written, the chunk states written by the local launch, read
// and written by the passing and read by the output launch, ~0.94 GB,
// 0.28 ms at 3.35 TB/s.
// What this design does: state passing (Dao & Gu 2024, §7), four launches,
// each a grid of (b, chunk, group of 8 heads) or elementwise, so the chunks
// run in parallel (512 blocks at that shape instead of 128):
// (F1) ssd_cb_kernel, as (a), into rows of S9_LP floats.
// (F2) ssd_fwd_state_sm90_kernel, a block per (b, chunk, group of 8
//      heads): every chunk's vectors dt, seg (in log2 units) and exp(seg)
//      (into the workspace) and decay exp(seg_L), as the backward's local
//      block (b'), and the chunk's own state local_c = (B o w)^T . x (M =
//      n, N = p, K = the steps) into the chunk states' slot c + 1 (the last
//      chunk's into h_out, where the call returns the final state). w goes
//      on x's side, so A = B^T is the same for all the block's heads: B
//      comes once by TMA and is split into hi / lo A tiles once; x comes
//      through a TMA ring and is scaled by w, transposed and split into B
//      tiles (at N 128 once for both warpgroups); both operands of every
//      product from shared memory.
// (F3) ssd_fwd_pass_kernel, elementwise, a thread per (b, h, n, p): the
//      chunks in order and in place, states[c] = decay[c - 1] states[c - 1]
//      + local[c - 1] from states[0] = 0; then the final state.
// (F4) ssd_fwd_out_sm90_kernel, a block per (b, chunk, group of 8 heads):
//      a TMA producer warpgroup and two consumer warpgroups of the chunk's
//      64-row halves. C.B^T (its boxes on and below the diagonal) and C
//      come once a block for all its heads; x and h_in of every head
//      through a TMA ring (2 stages at N 128, 6 at N 64: what shared
//      memory leaves; the next head's tiles in flight while this one
//      computes). Per head
//      y = M . x + (exp(seg) o C) . h_in in one accumulator, M[t, s] =
//      C.B^T[t, s] exp(seg_t - seg_s) dt_s for s <= t with the mask before
//      the exponential and D folded into its diagonal (y's D x term at no
//      cost). Every product reads both operands from
//      shared memory (ss_product): each k-tile of x or h_in split and
//      transposed into one B tile for both warpgroups, each splitting
//      half; each warpgroup's A tile (M's or exp(seg) o C's rows, 16
//      consecutive values a thread from 16-byte loads) computed and stored
//      split while the last tile's products run. k-tiles above the
//      diagonal are skipped, and the first chunk has no C . h_in.
// On the H100 (PERF.md §6) these four take 0.60-0.63 of the mma.sync kind's
// time at mamba2's and zamba2's train shapes, and 1.0-1.2x of it at their
// serve prefills of 4 rows, which the dispatch sends to mma.sync. What
// bounds them there: the output launch runs at about twice the time of
// its own bytes, its products and conversions both drawing on the SM's
// shared-memory bandwidth (an m64n64k8 TF32 product with both operands in
// shared memory reads 4 KB in its 32 cycles); the state launch and the
// passing near the time of their bytes.
// Every element is split once where it is an operand; no float atomics,
// so two calls give the same bits; a ragged last chunk runs its true
// length (rows past it masked wherever they are read, zeros past S from
// TMA).

// (F2) Block blockIdx.x = (b n_chunks + c) groups + group, heads [h0, h0 +
// 8). The product local_c = (B o w)^T . x takes w on x's side: A = B^T,
// the same for every head of the block, is split into hi and lo tiles
// (K-major, one a k-tile of 32 steps) once, from B's raw 128-step boxes,
// which lie where the ring and the B tiles go afterwards (the producer
// starts the ring once A is built); each k-tile of x is scaled by w,
// split and transposed into a B tile, and both operands of every product
// come from shared memory. At N 128 warpgroup j takes rows n of [64 j, +
// 64) of every head, the two splitting one x tile a half each; at N 64
// each takes every other head, with its own B tiles. Each head's 64 x 64
// result goes out through shared memory by TMA stores, which run on while
// the next head computes (written by the threads, the same 130 MB of
// states cost the launch ~0.08 ms at mamba2's train shape: PERF.md §6).
template <int NS>
struct StateSm90Smem {
  // the ring's stages: what shared memory leaves (3 at N 128)
  static constexpr int ST = NS == 128 ? 3 : S9_LOCAL_STAGES;
  unsigned char a[2][S9_LP / 32][NS * 128];  // B^T: hi, lo; NS x 32 a k-tile
  unsigned char stage[ST][2 * S9_BOX32];     // x: 32 x 64 p
  // x's split: 2 x (hi, lo), both warpgroups' (N 128) or each one's (N 64)
  unsigned char bhl[(NS == 128 ? 1 : 2) * 2 * 2 * 64 * 128];
  // each warpgroup's 64 x 64 result as two 64 x 32 boxes, stored by TMA
  unsigned char out[2][2][S9_BOX32 * 2];
  float w[S9_LOCAL_GROUP][S9_LP];
  uint64_t b_full, raw_free, full[ST], empty[ST];
};

template <int NS>
__global__ void __launch_bounds__(S9_THREADS, 1)
ssd_fwd_state_sm90_kernel(const __grid_constant__ CUtensorMap tm_b128,
                          const __grid_constant__ CUtensorMap tm_x32,
                          const __grid_constant__ CUtensorMap tm_st_out,
                          const __grid_constant__ CUtensorMap tm_h_out,
                          const float* __restrict__ dt,
                          const float* __restrict__ a_log,
                          const float* __restrict__ h_out,
                          float* __restrict__ decay, float* __restrict__ dtv,
                          float* __restrict__ segv, float* __restrict__ esv,
                          int S, int H, int L) {
  using Smem = StateSm90Smem<NS>;
  constexpr int ST = Smem::ST;
  constexpr bool SHARED = NS == 128;  // one x split for both warpgroups
  constexpr uint32_t BUF = 64 * 128;  // a 64 x 32 tf32 tile
  static_assert(sizeof(Smem::stage) + sizeof(Smem::bhl) + sizeof(Smem::out) >=
                    NS / 32 * S9_BOX128,
                "B's raw boxes fit where the ring and the B and out tiles go");
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  unsigned char* raw = &sm.stage[0][0];  // B's raw boxes, until A is built
  const int tid = threadIdx.x;
  const int n_chunks = (S + L - 1) / L;
  const int ngl = (H + S9_LOCAL_GROUP - 1) / S9_LOCAL_GROUP;
  const int grp = blockIdx.x % ngl, bc = blockIdx.x / ngl;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int h0 = grp * S9_LOCAL_GROUP, nh = min(S9_LOCAL_GROUP, H - h0);
  const int n_kt = (Lc + 31) / 32;
  // where head h0's local term goes, by TMA (the map and its first row):
  // the state entering chunk c + 1, or for the last chunk the final
  // state's (the passing completes it) where the call returns it, else
  // nowhere
  const bool last = c + 1 == n_chunks;
  const bool wanted = !last || h_out != nullptr;
  const CUtensorMap* tm_dst = last ? &tm_h_out : &tm_st_out;
  const int dst_row = (last ? b * H : (bc + 1) * H) * NS;
  if (tid == 0) {
    hopper::mbar_init(&sm.b_full, 1);
    hopper::mbar_init(&sm.raw_free, S9_CONSUMERS / 32);
    init_ring<ST>(sm.full, sm.empty);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= S9_CONSUMERS) {  // the producer warpgroup
    hopper::reg_dealloc<S9_PRODUCER_REGS>();
    if (tid == S9_CONSUMERS && wanted) {
      hopper::mbar_arrive_expect_tx(&sm.b_full, NS / 32 * S9_BOX128);
#pragma unroll
      for (int nb = 0; nb < NS / 32; ++nb)
        hopper::tma_load_3d(raw + nb * S9_BOX128, &tm_b128, &sm.b_full,
                            32 * nb, t0, b);
      hopper::mbar_wait(&sm.raw_free, 0);  // A is built: the room is free
      for (int i = 0; i < nh * n_kt; ++i) {
        const int s = producer_stage<ST>(sm.empty, i);
        const int h = h0 + i / n_kt, k = i % n_kt;
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * S9_BOX32);
        hopper::tma_load_4d(sm.stage[s], &tm_x32, &sm.full[s], 0, h,
                            t0 + 32 * k, b);
        hopper::tma_load_4d(sm.stage[s] + S9_BOX32, &tm_x32, &sm.full[s], 32,
                            h, t0 + 32 * k, b);
      }
    }
    return;
  }
  hopper::reg_alloc<S9_CONSUMER_REGS>();

  // the vectors, one warp a head (seg in log2 units, for the output
  // launch's exp2); w kept for the product
  const int warp = tid / 32, lane = tid % 32;
  if (warp < nh) {
    const int h = h0 + warp;
    const int64_t o = (static_cast<int64_t>(bc) * H + h) * S9_LP;
    float e[4], wv[4];
    chunk_vectors(dt + (static_cast<int64_t>(b) * S + t0) * H + h, H,
                  -expf(a_log[h]), Lc, lane, kLog2e, dtv + o, segv + o,
                  esv + o, nullptr, decay + static_cast<int64_t>(bc) * H + h,
                  e, wv);
    *reinterpret_cast<float4*>(&sm.w[warp][4 * lane]) =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
  }
  if (!wanted) return;  // no local term is wanted of this chunk

  // A = B^T, split: warpgroup j the k-tiles 2 j, 2 j + 1
  const Wg w = wg_of();
  hopper::mbar_wait(&sm.b_full, 0);
#pragma unroll
  for (int kt = 2 * w.wg; kt < 2 * w.wg + 2; ++kt)
    split_tile_t<NS, false>(sm.a[0][kt], sm.a[1][kt], raw + kt * 32 * 128,
                            S9_BOX128, 0, w.tid);
  hopper::fence_proxy_async();
  hopper::named_bar_sync(3, S9_CONSUMERS);  // A, and every head's w, are in
  hopper::mbar_arrive_warp(&sm.raw_free);

  const int n0 = SHARED ? 64 * w.wg : 0;  // this warpgroup's rows n
  unsigned char* bbase = &sm.bhl[0] + (SHARED ? 0 : w.wg * 4 * BUF);
  Ring<ST> ring{sm.full, sm.empty, 0};
  float acc[32];
  for (int hl = 0; hl < nh; ++hl) {
    const bool mine = SHARED || hl % 2 == w.wg;
    const float* w_h = sm.w[hl];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    hopper::fence_operand(acc);
    for (int i = 0; i < n_kt; ++i) {
      const int s = ring.wait();
      unsigned char* bhi = bbase + (i & 1) * 2 * BUF;
      unsigned char* blo = bhi + BUF;
      // the B buffer pair i % 2 is free: the products of tile i - 2 are
      // done (each warpgroup waited for them after issuing tile i - 1)
      if (SHARED)
        hopper::named_bar_sync(3, S9_CONSUMERS);
      else if (mine)
        wg_sync(w);
      if (SHARED)
        split_tile_t<32, false, true>(bhi + 32 * 128 * w.wg,
                                      blo + 32 * 128 * w.wg, sm.stage[s],
                                      S9_BOX32, 32 * w.wg, w.tid, nullptr, 0,
                                      w_h + 32 * i);
      else if (mine)
        split_tile_t<64, false, true>(bhi, blo, sm.stage[s], S9_BOX32, 0,
                                      w.tid, nullptr, 0, w_h + 32 * i);
      hopper::fence_proxy_async();
      if (SHARED)
        hopper::named_bar_sync(3, S9_CONSUMERS);
      else if (mine)
        wg_sync(w);
      ring.release(s);
      if (!mine) continue;
      const uint32_t a_hi = hopper::smem_u32(sm.a[0][i]) + n0 * 128;
      const uint32_t a_lo = hopper::smem_u32(sm.a[1][i]) + n0 * 128;
      const uint32_t b_hi = hopper::smem_u32(bhi), b_lo = b_hi + BUF;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_tf32x3_ss(acc, hopper::desc_tf32(a_hi, kk),
                                hopper::desc_tf32(a_lo, kk),
                                hopper::desc_tf32(b_hi, kk),
                                hopper::desc_tf32(b_lo, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // tile i - 1's products are done
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc);
    if (!mine) continue;
    // the head's rows n0 .. n0 + 63 into this warpgroup's two boxes, once
    // the last TMA store has read them, then out by TMA
    unsigned char* ob = &sm.out[w.wg][0][0];
    if (w.tid == 0) hopper::bulk_wait_read<0>();
    wg_sync(w);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * w.warp + w.g + 8 * hf, p = 8 * jb + 2 * w.q;
        *reinterpret_cast<float2*>(ob + (p >> 5) * 2 * S9_BOX32 +
                                   hopper::swz32(n, p & 31)) =
            make_float2(acc[4 * jb + 2 * hf], acc[4 * jb + 2 * hf + 1]);
      }
    hopper::fence_proxy_async();
    wg_sync(w);
    if (w.tid == 0) {
      const int row = dst_row + (h0 + hl) * NS + n0;
      hopper::tma_store_2d(tm_dst, ob, 0, row);
      hopper::tma_store_2d(tm_dst, ob + 2 * S9_BOX32, 32, row);
      hopper::bulk_commit();
    }
  }
  if (w.tid == 0) hopper::bulk_wait_read<0>();  // before the block ends
}

// (F3) states[b, c, h] = the state entering chunk c: 0 for the first, then
// decay[b, c - 1, h] states[c - 1] + local_{c - 1} (which slot c holds), in
// place; h_out (holding the last chunk's local term) becomes the final
// state where it is not null. A thread per element of (b, h, N x P), its
// locals read eight chunks ahead of the chain.
__global__ void __launch_bounds__(THREADS)
ssd_fwd_pass_kernel(const float* __restrict__ decay,
                    float* __restrict__ states, float* __restrict__ h_out,
                    int n_chunks, int H, int64_t NP, int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= total) return;
  const int64_t bh = e / NP, i = e % NP;
  const int64_t b = bh / H, h = bh % H;
  const int64_t cs = H * NP;  // one chunk of the states
  float* p = states + (b * n_chunks * H + h) * NP + i;
  const float* dec = decay + b * n_chunks * H + h;
  float st = 0.f;
  p[0] = 0.f;
  for (int c0 = 1; c0 < n_chunks; c0 += 8) {
    float loc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < n_chunks) loc[j] = p[(c0 + j) * cs];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < n_chunks) {
        st = dec[(c0 + j - 1) * H] * st + loc[j];
        p[(c0 + j) * cs] = st;
      }
  }
  if (h_out != nullptr) h_out[e] = dec[(n_chunks - 1) * H] * st + h_out[e];
}

// (F4) Block blockIdx.x = (b n_chunks + c) groups + group; warpgroup j
// takes the chunk's steps [64 j, 64 j + 64).
constexpr int S9_OUT_GROUP = 8;  // heads an output block takes
// the ring's stages: what shared memory leaves beside two A tiles a
// warpgroup (a deeper ring, 6 stages at N 128 with one A tile, ran no
// faster: PERF.md §6)
template <int NS>
constexpr int out_stages() {
  return NS == 128 ? 2 : 6;
}

// C.B^T's 32 x 32 boxes on and below the diagonal: box (tb, sb), sb <= tb,
// holds rows [32 tb, + 32) and columns [32 sb, + 32)
constexpr int S9_CB_BOXES = 10;
__device__ __forceinline__ int cb_box(int tb, int sb) {
  return tb * (tb + 1) / 2 + sb;
}

template <int NS>
struct OutSm90Smem {
  static constexpr int ST = out_stages<NS>();
  unsigned char cb[S9_CB_BOXES][S9_BOX32];  // C.B^T, cb_box(tb, sb)
  unsigned char cbuf[NS / 32][S9_BOX128];   // C: 128 t x 32 n a box
  unsigned char stage[ST][2 * S9_BOX32];    // x or h_in: 32 x 64 p
  unsigned char bhl[2][2 * 64 * 128];       // B: 2 x (hi, lo), both's
  unsigned char ahl[2][2][2 * 64 * 128];    // A: each one's 2 x (hi, lo)
  float vec[2][3][S9_LP];  // a head's dt, seg (log2 units), exp(seg)
  uint64_t tiles_full, full[ST], empty[ST], vfull[2], vempty[2];
};

// The k-tiles [0, n) of one head's product in an output block, both
// operands from shared memory: a warpgroup that issues its products goes
// on at once (with A in registers the issuing warps were held until the
// tensor core had read it, and the next tile's conversion waited: PERF.md
// §6). The two warpgroups in step: while tile i - 1's products run, each
// splits its half of B's rows (p of [32 wg, 32 wg + 32)) of tile i into
// the shared buffer pair i % 2, computes its A tile (make(i, hi, lo): the
// thread's 16 values of row tid / 2, columns [16 (tid % 2), + 16), split)
// and stores it into its own buffer pair i % 2; then issues tile i's
// products and waits for tile i - 1's. The block's named barrier before
// the conversion makes sure both warpgroups' products of tile i - 2 are
// done, the one after it that A and B are whole. A tile for which
// takes(i) is false gets no products from this warpgroup (it still
// splits its half of B). Returns with every product done.
template <int ST, class Takes, class Make>
__device__ __forceinline__ void ss_product(float (&acc)[32], Ring<ST>& ring,
                                           int n, const Wg& w,
                                           unsigned char* bhl,
                                           unsigned char* ahl,
                                           unsigned char (*stage)[2 * S9_BOX32],
                                           const Takes& takes,
                                           const Make& make) {
  constexpr uint32_t BUF = 64 * 128;  // a 64 x 32 tf32 tile
  const int r = w.tid >> 1, k0 = 16 * (w.tid & 1);
  hopper::fence_operand(acc);
  for (int i = 0; i < n; ++i) {
    const int s = ring.wait();
    unsigned char* bhi = bhl + (i & 1) * 2 * BUF;
    unsigned char* blo = bhi + BUF;
    unsigned char* ahi = ahl + (i & 1) * 2 * BUF;
    unsigned char* alo = ahi + BUF;
    const bool mine = takes(i);
    hopper::named_bar_sync(3, S9_CONSUMERS);
    split_tile_t<32, false>(bhi + 32 * 128 * w.wg, blo + 32 * 128 * w.wg,
                            stage[s], S9_BOX32, 32 * w.wg, w.tid);
    if (mine) {
      uint32_t hi[16], lo[16];
      make(i, hi, lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t o = hopper::swz32(r, k0 + 4 * j);
        *reinterpret_cast<uint4*>(ahi + o) =
            make_uint4(hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3]);
        *reinterpret_cast<uint4*>(alo + o) =
            make_uint4(lo[4 * j], lo[4 * j + 1], lo[4 * j + 2], lo[4 * j + 3]);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_bar_sync(3, S9_CONSUMERS);
    ring.release(s);
    if (mine) {
      const uint32_t a_hi = hopper::smem_u32(ahi), a_lo = a_hi + BUF;
      const uint32_t b_hi = hopper::smem_u32(bhi), b_lo = b_hi + BUF;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_tf32x3_ss(acc, hopper::desc_tf32(a_hi, kk),
                                hopper::desc_tf32(a_lo, kk),
                                hopper::desc_tf32(b_hi, kk),
                                hopper::desc_tf32(b_lo, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // tile i - 1's products are done
    } else {
      hopper::wgmma_wait<0>();
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operand(acc);
}

// four f32 values at a 16-byte aligned shared-memory offset
__device__ __forceinline__ float4 lds4(const unsigned char* base,
                                       uint32_t off) {
  return *reinterpret_cast<const float4*>(base + off);
}

template <int NS>
__global__ void __launch_bounds__(S9_THREADS, 1)
ssd_fwd_out_sm90_kernel(const __grid_constant__ CUtensorMap tm_cb,
                        const __grid_constant__ CUtensorMap tm_c128,
                        const __grid_constant__ CUtensorMap tm_x32,
                        const __grid_constant__ CUtensorMap tm_states,
                        const float* __restrict__ dtv,
                        const float* __restrict__ segv,
                        const float* __restrict__ esv,
                        const float* __restrict__ d_skip,
                        float* __restrict__ y, int S, int H, int L) {
  using Smem = OutSm90Smem<NS>;
  constexpr int ST = Smem::ST;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tid = threadIdx.x;
  const int n_chunks = (S + L - 1) / L;
  const int ngo = (H + S9_OUT_GROUP - 1) / S9_OUT_GROUP;
  const int grp = blockIdx.x % ngo, bc = blockIdx.x / ngo;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int h0 = grp * S9_OUT_GROUP, nh = min(S9_OUT_GROUP, H - h0);
  const int n_kc = (Lc + 31) / 32;       // k-tiles of M . x (steps s)
  const int n_kh = c > 0 ? NS / 32 : 0;  // k-tiles of C . h_in (n)
  if (tid == 0) {
    hopper::mbar_init(&sm.tiles_full, 1);
    init_ring<ST>(sm.full, sm.empty);
    for (int v = 0; v < 2; ++v) {
      hopper::mbar_init(&sm.vfull[v], 1);
      hopper::mbar_init(&sm.vempty[v], S9_CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= S9_CONSUMERS) {  // the producer warpgroup
    hopper::reg_dealloc<S9_PRODUCER_REGS>();
    if (tid != S9_CONSUMERS) return;
    // the block's C.B^T (the chunk's boxes on and below the diagonal) and
    // C (past the first chunk)
    hopper::mbar_arrive_expect_tx(
        &sm.tiles_full,
        n_kc * (n_kc + 1) / 2 * S9_BOX32 + n_kh * S9_BOX128);
    for (int tb = 0; tb < n_kc; ++tb)
      for (int sb = 0; sb <= tb; ++sb)
        hopper::tma_load_3d(sm.cb[cb_box(tb, sb)], &tm_cb, &sm.tiles_full,
                            32 * sb, 32 * tb, bc);
    for (int nb = 0; nb < n_kh; ++nb)
      hopper::tma_load_3d(sm.cbuf[nb], &tm_c128, &sm.tiles_full, 32 * nb, t0,
                          b);
    int i = 0;
    for (int hl = 0; hl < nh; ++hl) {
      const int h = h0 + hl, vs = hl % 2;
      if (hl >= 2) hopper::mbar_wait(&sm.vempty[vs], (hl / 2 - 1) & 1);
      const int64_t o = (static_cast<int64_t>(bc) * H + h) * S9_LP;
      hopper::mbar_arrive_expect_tx(&sm.vfull[vs], 3 * S9_LP * 4);
      hopper::bulk_load(sm.vec[vs][0], dtv + o, S9_LP * 4, &sm.vfull[vs]);
      hopper::bulk_load(sm.vec[vs][1], segv + o, S9_LP * 4, &sm.vfull[vs]);
      hopper::bulk_load(sm.vec[vs][2], esv + o, S9_LP * 4, &sm.vfull[vs]);
      for (int k = 0; k < n_kc; ++k, ++i) {  // x's 32 steps of k-tile k
        const int s = producer_stage<ST>(sm.empty, i);
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * S9_BOX32);
        hopper::tma_load_4d(sm.stage[s], &tm_x32, &sm.full[s], 0, h,
                            t0 + 32 * k, b);
        hopper::tma_load_4d(sm.stage[s] + S9_BOX32, &tm_x32, &sm.full[s], 32,
                            h, t0 + 32 * k, b);
      }
      const int row = (bc * H + h) * NS;  // the head's state rows
      for (int k = 0; k < n_kh; ++k, ++i) {  // h_in's rows n of k-tile k
        const int s = producer_stage<ST>(sm.empty, i);
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * S9_BOX32);
        hopper::tma_load_2d(sm.stage[s], &tm_states, &sm.full[s], 0,
                            row + 32 * k);
        hopper::tma_load_2d(sm.stage[s] + S9_BOX32, &tm_states, &sm.full[s],
                            32, row + 32 * k);
      }
    }
    return;
  }
  hopper::reg_alloc<S9_CONSUMER_REGS>();

  const Wg w = wg_of();
  const int m0 = 64 * w.wg;  // this warpgroup's first step
  const int64_t x_step = static_cast<int64_t>(H) * 64;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;
  hopper::mbar_wait(&sm.tiles_full, 0);
  Ring<ST> ring{sm.full, sm.empty, 0};
  float acc[32];
  for (int hl = 0; hl < nh; ++hl) {
    const int h = h0 + hl, vs = hl % 2;
    hopper::mbar_wait(&sm.vfull[vs], (hl / 2) & 1);
    const float* dtv_s = sm.vec[vs][0];
    const float* seg_s = sm.vec[vs][1];
    const float* es_s = sm.vec[vs][2];
    const float Dh = d_skip[h];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // B: x's (s, p) or h_in's (n, p) tile, transposed as it is split; A:
    // the thread's 16 values of row t at columns [k0, k0 + 16) of tile i
    const int t = m0 + (w.tid >> 1), k0 = 16 * (w.tid & 1);
    ss_product<ST>(
        acc, ring, n_kc + n_kh, w, &sm.bhl[0][0], &sm.ahl[w.wg][0][0],
        sm.stage,
        // a k-tile of steps s with some s <= t of this warpgroup's rows
        [&](int i) { return m0 < Lc && (i >= n_kc || 32 * i < m0 + 64); },
        [&](int i, uint32_t(&hi)[16], uint32_t(&lo)[16]) {
          float v[16];
          if (i < n_kc) {
            // M[t, s] under the mask (the exponential only there: it
            // overflows above the diagonal), D on the diagonal
            const int s0 = 32 * i + k0;
            const bool live = t < Lc && s0 <= t;
            const unsigned char* box = sm.cb[cb_box(t >> 5, i)];
            const float st = seg_s[t];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 c4 = live ? lds4(box, hopper::swz32(t & 31,
                                                               k0 + 4 * j))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
              const float4 sg =
                  *reinterpret_cast<const float4*>(seg_s + s0 + 4 * j);
              const float4 dv =
                  *reinterpret_cast<const float4*>(dtv_s + s0 + 4 * j);
              const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
              const float ss[4] = {sg.x, sg.y, sg.z, sg.w};
              const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int sc = s0 + 4 * j + e;
                const float m =
                    live && sc <= t
                        ? cs[e] * hopper::exp2_ftz(st - ss[e]) * ds[e]
                        : 0.f;
                v[4 * j + e] = live && sc == t ? m + Dh : m;
              }
            }
          } else {
            const int k = i - n_kc;
            const bool live = t < Lc;
            const float e = es_s[t];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 c4 = live ? lds4(sm.cbuf[k],
                                            hopper::swz32(t, k0 + 4 * j))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
              v[4 * j] = e * c4.x;
              v[4 * j + 1] = e * c4.y;
              v[4 * j + 2] = e * c4.z;
              v[4 * j + 3] = e * c4.w;
            }
          }
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const mma::Split sp = mma::split(v[q]);
            hi[q] = sp.hi;
            lo[q] = sp.lo;
          }
        });
    hopper::mbar_arrive_warp(&sm.vempty[vs]);  // done with the vectors
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = m0 + 16 * w.warp + w.g + 8 * hf;
      if (t >= Lc) continue;
      float* yr = y + (row0 + t) * x_step + static_cast<int64_t>(h) * 64;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
        *reinterpret_cast<float2*>(yr + 8 * jb + 2 * w.q) =
            make_float2(acc[4 * jb + 2 * hf], acc[4 * jb + 2 * hf + 1]);
    }
  }
}

// One k-tile of 3xTF32 through the blocks above, for the card tests: d (64
// x 64) = a (64 x 32) . b (64 x 32)^T, a and b row-major f32, A built in
// registers and b split into hi and lo tiles in shared memory; with raw !=
// 0, one TF32 product of the unsplit operands instead (a's f32 bits as its
// registers, b's tile as it is), which shows whether the tensor core
// rounds or truncates an f32 operand.
struct UnitSmem {
  unsigned char b[3][64 * 128];  // b as it is, hi, lo
};

__global__ void __launch_bounds__(128)
ssd_tf32_unit_sm90_kernel(const float* __restrict__ a,
                          const float* __restrict__ b, float* __restrict__ d,
                          int raw) {
  extern __shared__ unsigned char smem_raw[];
  UnitSmem& sm = aligned_smem<UnitSmem>(smem_raw);
  const Wg w = wg_of();
  for (int e = w.tid; e < 64 * 32; e += 128)
    *reinterpret_cast<float*>(sm.b[0] + hopper::swz32(e / 32, e % 32)) = b[e];
  __syncthreads();
  split_tile(sm.b[1], sm.b[2], sm.b[0], 64, w.tid);
  hopper::fence_proxy_async();
  __syncthreads();
  float acc[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;
  uint32_t ah[1][4][4], al[1][4][4];
  make_a(ah[0], al[0], w, [&](int r, int k) { return a[r * 32 + k]; });
  if (raw) {
    const int r0 = 16 * w.warp + w.g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 8 * kk + w.q;
      ah[0][kk][0] = __float_as_uint(a[r0 * 32 + k]);
      ah[0][kk][1] = __float_as_uint(a[(r0 + 8) * 32 + k]);
      ah[0][kk][2] = __float_as_uint(a[r0 * 32 + k + 4]);
      ah[0][kk][3] = __float_as_uint(a[(r0 + 8) * 32 + k + 4]);
    }
    const uint32_t bt = hopper::smem_u32(sm.b[0]);
    hopper::fence_operand(acc[0]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k8_tf32_rs(acc[0], ah[0][kk],
                                     hopper::desc_tf32(bt, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc[0]);
    hopper::fence_operand(ah[0]);
  } else {
    hopper::fence_operand(acc[0]);
    issue_tile<64>(acc[0], ah[0], al[0], hopper::smem_u32(sm.b[1]),
                   hopper::smem_u32(sm.b[2]));
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc[0]);
    hopper::fence_operand(ah[0]);
    hopper::fence_operand(al[0]);
  }
#pragma unroll
  for (int jb = 0; jb < 8; ++jb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * w.warp + w.g + 8 * hf;
      *reinterpret_cast<float2*>(d + r * 64 + 8 * jb + 2 * w.q) =
          make_float2(acc[0][4 * jb + 2 * hf], acc[0][4 * jb + 2 * hf + 1]);
    }
}

// the wgmma kind's scratch, carved from one workspace of
// ssd_scan_bwd_sm90_work_floats floats (each region a multiple of 32
// floats): C.B^T (B, n_chunks, L, S9_LP), the state gradients (B,
// n_chunks, H, N, P), the chunks' decays (B, n_chunks, H), dt, seg,
// exp(seg) and w (B, n_chunks, H, S9_LP) each, the groups' GE_sum (B,
// n_chunks, H / BWD_GROUP, S9_LP, S9_LP), the heads' per-step parts (B,
// n_chunks, H, S9_PARTS), the per-chunk dD and dA sums
struct BwdWorkSm90 {
  float *cb, *dstates, *decay, *dtv, *segv, *esv, *wsv, *gesum, *parts,
      *part;
  size_t floats;
};

BwdWorkSm90 bwd_work_sm90(float* base, int B, int S, int H, int P, int N,
                          int L) {
  const size_t nc = (S + L - 1) / L, bnc = static_cast<size_t>(B) * nc;
  const size_t ng = (H + BWD_GROUP - 1) / BWD_GROUP;
  const size_t vec = bnc * H * S9_LP;
  const size_t sizes[10] = {bnc * L * S9_LP, bnc * H * N * P, bnc * H,
                            vec, vec, vec, vec,
                            bnc * ng * S9_LP * S9_LP, bnc * H * S9_PARTS,
                            bnc * H * 2};
  float* p[10];
  size_t off = 0;
  for (int i = 0; i < 10; ++i) {
    p[i] = base == nullptr ? nullptr : base + off;
    off += (sizes[i] + 31) / 32 * 32;
  }
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], off};
}

// the shapes the wgmma kind takes (kernels.ssd_scan.ssd_bwd_kind)
bool sm90_shape(int L, int P, int N) {
  return P == 64 && (N == 64 || N == 128) && L >= 1 && L <= S9_LP;
}

// at most the 227 KB a block may have (the wrapper checks it too)
template <int NS>
constexpr size_t sm90_bwd_smem_bytes() {
  const size_t a = sm90_smem_bytes<LocalSm90Smem<NS>>();
  const size_t b = sm90_smem_bytes<ChunkSm90Smem<NS>>();
  const size_t c = sm90_smem_bytes<DbdcSm90Smem<NS>>();
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
static_assert(sm90_bwd_smem_bytes<64>() <= 232448 &&
                  sm90_bwd_smem_bytes<128>() <= 232448,
              "a block's shared memory");

template <int NS>
cudaError_t launch_bwd_sm90(const float* x, const float* dt,
                            const float* a_log, const float* bm,
                            const float* cm, const float* d_skip,
                            const float* dy, const float* states,
                            const float* dh_final, float* work, float* dx,
                            float* ddt, float* da_log, float* db, float* dc,
                            float* dd, int B, int S, int H, int L,
                            cudaStream_t st) {
  constexpr int P = 64;
  const int n_chunks = (S + L - 1) / L;
  const BwdWorkSm90 w = bwd_work_sm90(work, B, S, H, P, NS, L);
  cudaError_t err = launch_cb(bm, cm, w.cb, B, S, NS, L, S9_LP, st);
  if (err != cudaSuccess) return err;

  // TMA descriptors (dims innermost first, strides in bytes)
  const cuuint64_t xs[3] = {P * 4ull, static_cast<cuuint64_t>(H) * P * 4,
                            static_cast<cuuint64_t>(S) * H * P * 4};
  const cuuint64_t xd[4] = {P, static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(B)};
  const cuuint32_t box_x128[4] = {32, 1, 128, 1}, box_x32[4] = {32, 1, 32, 1};
  const cuuint64_t nd[3] = {static_cast<cuuint64_t>(NS),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t ns[2] = {NS * 4ull, static_cast<cuuint64_t>(S) * NS * 4};
  const cuuint32_t box_n128[3] = {32, 128, 1}, box_n32[3] = {32, 32, 1};
  const cuuint64_t sd[2] = {P, static_cast<cuuint64_t>(B) * n_chunks * H * NS};
  const cuuint64_t ss[1] = {P * 4ull};
  const cuuint32_t box_s32[2] = {32, 32}, box_sn[2] = {32, NS};
  const cuuint64_t cd[3] = {S9_LP, static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B) * n_chunks};
  const cuuint64_t cs[2] = {S9_LP * 4ull,
                            static_cast<cuuint64_t>(L) * S9_LP * 4};
  const cuuint32_t box_cb[3] = {32, 32, 1};
  CUtensorMap x128, dy128, dy32, b128, c128, b32, c32, st32, dst32, stn, dstn,
      cbm;
  const struct {
    CUtensorMap* map;
    const void* base;
    int rank;
    const cuuint64_t* dims;
    const cuuint64_t* strides;
    const cuuint32_t* box;
  } maps[12] = {{&x128, x, 4, xd, xs, box_x128},
                {&dy128, dy, 4, xd, xs, box_x128},
                {&dy32, dy, 4, xd, xs, box_x32},
                {&b128, bm, 3, nd, ns, box_n128},
                {&c128, cm, 3, nd, ns, box_n128},
                {&b32, bm, 3, nd, ns, box_n32},
                {&c32, cm, 3, nd, ns, box_n32},
                {&st32, states, 2, sd, ss, box_s32},
                {&dst32, w.dstates, 2, sd, ss, box_s32},
                {&stn, states, 2, sd, ss, box_sn},
                {&dstn, w.dstates, 2, sd, ss, box_sn},
                {&cbm, w.cb, 3, cd, cs, box_cb}};
  for (const auto& m : maps)
    if ((err = hopper::f32_tile_map(m.map, m.base, m.rank, m.dims, m.strides,
                                    m.box)) != cudaSuccess)
      return err;

  const auto local = ssd_bwd_local_sm90_kernel<NS>;
  const auto chunk = ssd_bwd_chunk_sm90_kernel<NS>;
  const auto dbdc = ssd_bwd_dbdc_sm90_kernel<NS>;
  const size_t smem_l = sm90_smem_bytes<LocalSm90Smem<NS>>();
  const size_t smem_c = sm90_smem_bytes<ChunkSm90Smem<NS>>();
  const size_t smem_d = sm90_smem_bytes<DbdcSm90Smem<NS>>();
  if ((err = cudaFuncSetAttribute(local,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_l))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(chunk,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_c))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dbdc,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_d))) != cudaSuccess)
    return err;

  const int ngl = (H + S9_LOCAL_GROUP - 1) / S9_LOCAL_GROUP;
  local<<<B * n_chunks * ngl, S9_THREADS, smem_l, st>>>(
      c128, dy32, dt, a_log, w.dstates, w.decay, w.dtv, w.segv, w.esv, w.wsv,
      S, H, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int64_t NP = static_cast<int64_t>(NS) * P;
  const int64_t elems = static_cast<int64_t>(B) * H * NP;
  ssd_bwd_pass_kernel<<<static_cast<unsigned>((elems + THREADS - 1) / THREADS),
                        THREADS, 0, st>>>(dh_final, w.decay, w.dstates,
                                          n_chunks, H, NP, elems);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int items = B * n_chunks * ((H + BWD_GROUP - 1) / BWD_GROUP);
  const ChunkArgs ca{d_skip, x,       dy,      w.cb, w.dtv, w.segv, w.esv,
                     w.wsv,  dx,      w.gesum, w.parts, B,   S,     H,
                     L};
  chunk<<<items < sms ? items : sms, S9_THREADS, smem_c, st>>>(
      x128, dy128, dy32, b128, c128, st32, dst32, cbm, ca);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t heads = static_cast<int64_t>(B) * n_chunks * H;
  ssd_bwd_finish_kernel<<<static_cast<unsigned>((heads + NWARPS - 1) / NWARPS),
                          THREADS, 0, st>>>(w.parts, w.dtv, w.segv, w.esv,
                                            w.wsv, a_log, ddt, w.part, S, H,
                                            L, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dbdc<<<B * n_chunks * 2, S9_THREADS, smem_d, st>>>(
      x128, dy128, stn, dstn, b32, c32, w.wsv, w.esv, w.gesum, db, dc, S, H,
      L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_reduce_kernel<<<(H + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      w.part, a_log, da_log, dd, H, B * n_chunks);
  return cudaGetLastError();
}

// the wgmma forward's scratch, carved from one workspace of
// ssd_scan_fwd_sm90_work_floats floats (each region a multiple of 32
// floats): C.B^T (B, n_chunks, L, S9_LP), the chunks' decays (B, n_chunks,
// H), dt, seg and exp(seg) (B, n_chunks, H, S9_LP) each, and, where the
// caller keeps no chunk states (own_states), the states (B, n_chunks, H, N,
// 64) that the passing needs all the same
struct FwdWorkSm90 {
  float *cb, *decay, *dtv, *segv, *esv, *states;
  size_t floats;
};

FwdWorkSm90 fwd_work_sm90(float* base, int B, int S, int H, int N, int L,
                          bool own_states) {
  const size_t nc = (S + L - 1) / L, bnc = static_cast<size_t>(B) * nc;
  const size_t vec = bnc * H * S9_LP;
  const size_t sizes[6] = {bnc * L * S9_LP, bnc * H, vec, vec, vec,
                           own_states ? bnc * H * N * 64 : 0};
  float* p[6];
  size_t off = 0;
  for (int i = 0; i < 6; ++i) {
    p[i] = base == nullptr ? nullptr : base + off;
    off += (sizes[i] + 31) / 32 * 32;
  }
  return {p[0], p[1], p[2], p[3], p[4], own_states ? p[5] : nullptr, off};
}

template <int NS>
constexpr size_t sm90_fwd_smem_bytes() {
  const size_t a = sm90_smem_bytes<StateSm90Smem<NS>>();
  const size_t b = sm90_smem_bytes<OutSm90Smem<NS>>();
  return a > b ? a : b;
}
static_assert(sm90_fwd_smem_bytes<64>() <= 232448 &&
                  sm90_fwd_smem_bytes<128>() <= 232448,
              "a block's shared memory");

// (F1) to (F4), each launch checked; states (B, n_chunks, H, NS, 64) or
// null (the workspace holds them then), h_out (B, H, NS, 64) or null
template <int NS>
cudaError_t launch_fwd_sm90(const float* x, const float* dt,
                            const float* a_log, const float* bm,
                            const float* cm, const float* d_skip, float* work,
                            float* y, float* h_out, float* states, int B,
                            int S, int H, int L, cudaStream_t st) {
  constexpr int P = 64;
  const int n_chunks = (S + L - 1) / L;
  const FwdWorkSm90 w = fwd_work_sm90(work, B, S, H, NS, L, states == nullptr);
  float* sts = states != nullptr ? states : w.states;
  cudaError_t err = launch_cb(bm, cm, w.cb, B, S, NS, L, S9_LP, st);
  if (err != cudaSuccess) return err;

  // TMA descriptors (dims innermost first, strides in bytes)
  const cuuint64_t xs[3] = {P * 4ull, static_cast<cuuint64_t>(H) * P * 4,
                            static_cast<cuuint64_t>(S) * H * P * 4};
  const cuuint64_t xd[4] = {P, static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(B)};
  const cuuint32_t box_x32[4] = {32, 1, 32, 1};
  const cuuint64_t nd[3] = {static_cast<cuuint64_t>(NS),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t ns[2] = {NS * 4ull, static_cast<cuuint64_t>(S) * NS * 4};
  const cuuint32_t box_n128[3] = {32, 128, 1};
  const cuuint64_t sd[2] = {P, static_cast<cuuint64_t>(B) * n_chunks * H * NS};
  const cuuint64_t ss[1] = {P * 4ull};
  const cuuint32_t box_s32[2] = {32, 32};
  const cuuint64_t cd[3] = {S9_LP, static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B) * n_chunks};
  const cuuint64_t cs[2] = {S9_LP * 4ull,
                            static_cast<cuuint64_t>(L) * S9_LP * 4};
  const cuuint32_t box_cb[3] = {32, 32, 1};
  // the state launch's stores: boxes of 64 rows x 32 f32 of the states
  // and of the final state
  const cuuint32_t box_out[2] = {32, 64};
  const cuuint64_t hd[2] = {P, static_cast<cuuint64_t>(B) * H * NS};
  CUtensorMap x32, b128, c128, st32, cbm, st_out, h_out_map;
  const struct {
    CUtensorMap* map;
    const void* base;
    int rank;
    const cuuint64_t* dims;
    const cuuint64_t* strides;
    const cuuint32_t* box;
  } maps[7] = {{&x32, x, 4, xd, xs, box_x32},
               {&b128, bm, 3, nd, ns, box_n128},
               {&c128, cm, 3, nd, ns, box_n128},
               {&st32, sts, 2, sd, ss, box_s32},
               {&cbm, w.cb, 3, cd, cs, box_cb},
               {&st_out, sts, 2, sd, ss, box_out},
               // (no final state wanted: a map no block stores through)
               {&h_out_map, h_out != nullptr ? h_out : sts, 2,
                h_out != nullptr ? hd : sd, ss, box_out}};
  for (const auto& m : maps)
    if ((err = hopper::f32_tile_map(m.map, m.base, m.rank, m.dims, m.strides,
                                    m.box)) != cudaSuccess)
      return err;

  const auto state = ssd_fwd_state_sm90_kernel<NS>;
  const auto out = ssd_fwd_out_sm90_kernel<NS>;
  const size_t smem_s = sm90_smem_bytes<StateSm90Smem<NS>>();
  const size_t smem_o = sm90_smem_bytes<OutSm90Smem<NS>>();
  if ((err = cudaFuncSetAttribute(state,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_s))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(out,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_o))) != cudaSuccess)
    return err;

  const int ngl = (H + S9_LOCAL_GROUP - 1) / S9_LOCAL_GROUP;
  state<<<B * n_chunks * ngl, S9_THREADS, smem_s, st>>>(
      b128, x32, st_out, h_out_map, dt, a_log, h_out, w.decay, w.dtv, w.segv,
      w.esv, S, H, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int64_t NP = static_cast<int64_t>(NS) * P;
  const int64_t elems = static_cast<int64_t>(B) * H * NP;
  ssd_fwd_pass_kernel<<<static_cast<unsigned>((elems + THREADS - 1) / THREADS),
                        THREADS, 0, st>>>(w.decay, sts, h_out, n_chunks, H,
                                          NP, elems);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int ngo = (H + S9_OUT_GROUP - 1) / S9_OUT_GROUP;
  out<<<B * n_chunks * ngo, S9_THREADS, smem_o, st>>>(
      cbm, c128, x32, st32, w.dtv, w.segv, w.esv, d_skip, y, S, H, L);
  return cudaGetLastError();
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
  const int L = chunk < S ? chunk : S;
  return launch_cb(bm, cm, cb, B, S, N, L, cb_pitch(L),
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
  cudaError_t err = launch_cb(bm, cm, cb, B, S, N, L, cb_pitch(L), st);
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

// The forward's wgmma kind (kernels.ssd_scan.ssd_fwd_kind): floats of its
// workspace (with_states: the caller passes the chunk states, else the
// workspace holds them), bytes of its largest block's shared memory (0 at
// a shape it does not take), and its four launches: y (B, S, H, P), h_out
// (B, H, N, P) or null, states (B, n_chunks, H, N, P) or null, as
// ssd_scan_fwd. P 64, N 64 or 128, chunks of at most 128 steps, x, b, c,
// y, work, states and h_out 16-byte aligned; anything else returns
// cudaErrorInvalidValue before a launch.
size_t ssd_scan_fwd_sm90_work_floats(int B, int S, int H, int P, int N,
                                     int chunk, int with_states) {
  return fwd_work_sm90(nullptr, B, S, H, N, chunk < S ? chunk : S,
                       with_states == 0)
      .floats;
}

size_t ssd_scan_fwd_sm90_smem_bytes(int chunk, int P, int N) {
  if (!sm90_shape(chunk, P, N)) return 0;
  return N == 128 ? sm90_fwd_smem_bytes<128>() : sm90_fwd_smem_bytes<64>();
}

int ssd_scan_fwd_sm90(const void* x, const void* dt, const void* a_log,
                      const void* bm, const void* cm, const void* d_skip,
                      void* work, void* y, void* h_out, void* states, int B,
                      int S, int H, int P, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S;
  const void* ptrs[7] = {x, bm, cm, y, work, states, h_out};
  for (const void* q : ptrs)
    if (q != nullptr && !aligned16(q)) return cudaErrorInvalidValue;
  if (x == nullptr || y == nullptr || work == nullptr ||
      !sm90_shape(L, P, N))
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto o = [](void* q) { return static_cast<float*>(q); };
  auto* launch = N == 128 ? launch_fwd_sm90<128> : launch_fwd_sm90<64>;
  return launch(f(x), f(dt), f(a_log), f(bm), f(cm), f(d_skip), o(work),
                o(y), o(h_out), o(states), B, S, H, L,
                static_cast<cudaStream_t>(stream));
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
  cudaError_t err = launch_cb(bm, cm, w.cb, B, S, N, L, cb_pitch(L), st);
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

// The wgmma kind (kernels.ssd_scan.ssd_bwd_kind): floats of its workspace,
// bytes of its largest block's shared memory (0 at a shape it does not
// take), and its six launches with the arguments of ssd_scan_bwd (P 64, N
// 64 or 128, chunks of at most 128 steps, every pointer 16-byte aligned;
// anything else returns cudaErrorInvalidValue before a launch).
size_t ssd_scan_bwd_sm90_work_floats(int B, int S, int H, int P, int N,
                                     int chunk) {
  return bwd_work_sm90(nullptr, B, S, H, P, N, chunk < S ? chunk : S).floats;
}

size_t ssd_scan_bwd_sm90_smem_bytes(int chunk, int P, int N) {
  if (!sm90_shape(chunk, P, N)) return 0;
  return N == 128 ? sm90_bwd_smem_bytes<128>() : sm90_bwd_smem_bytes<64>();
}

int ssd_scan_bwd_sm90(const void* x, const void* dt, const void* a_log,
                      const void* bm, const void* cm, const void* d_skip,
                      const void* dy, const void* states,
                      const void* dh_final, void* work, void* dx, void* ddt,
                      void* da_log, void* db, void* dc, void* dd, int B,
                      int S, int H, int P, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S;
  const void* ptrs[7] = {x, bm, cm, dy, states, work, dx};
  for (const void* q : ptrs)
    if (!aligned16(q)) return cudaErrorInvalidValue;
  if (!sm90_shape(L, P, N)) return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto o = [](void* q) { return static_cast<float*>(q); };
  auto* launch = N == 128 ? launch_bwd_sm90<128> : launch_bwd_sm90<64>;
  return launch(f(x), f(dt), f(a_log), f(bm), f(cm), f(d_skip), f(dy),
                f(states), f(dh_final), o(work), o(dx), o(ddt), o(da_log),
                o(db), o(dc), o(dd), B, S, H, L,
                static_cast<cudaStream_t>(stream));
}

// One 3xTF32 k-tile through the wgmma kind's building blocks (raw = 0), or
// one TF32 product of the unsplit operands (raw = 1): d (64 x 64) = a (64 x
// 32) . b (64 x 32)^T, all row-major f32. Returns a cudaError_t.
int ssd_tf32_unit_sm90(const void* a, const void* b, void* d, int raw,
                       void* stream) {
  const size_t smem = sm90_smem_bytes<UnitSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tf32_unit_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_tf32_unit_sm90_kernel<<<1, 128, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(d), raw);
  return cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
