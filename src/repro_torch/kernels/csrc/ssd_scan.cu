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
                float* __restrict__ h_out, int S, int H, int P, int N, int L,
                int xvec, int nvec) {
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

    // seg = inclusive cumsum of dt A: each lane sums a run of steps, a
    // warp scan of the run totals gives each run its offset
    if (warp == 0) {
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
        seg_s[t] = acc;
      }
    }
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
// ssd_cb_pitch(L)) f32 scratch; h_out may be null (no final state). Returns a cudaError_t
// (0 = success).
int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                 const void* bm, const void* cm, const void* d_skip, void* cb,
                 void* y, void* h_out, int B, int S, int H, int P, int N,
                 int chunk, void* stream) {
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
      static_cast<float*>(h_out), S, H, P, N, L, xvec, nvec);
  return cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
