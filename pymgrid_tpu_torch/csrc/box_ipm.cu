// Whole batched box-IPM solves for Hopper (sm_90a): one thread block runs
// every iteration of one problem's Mehrotra predictor-corrector, so a solve
// of B problems is one launch of B blocks.
//
// Replaces no TPU kernel: the JAX package leaves the box IPM
// (pymgrid_tpu/core/lp.py:make_batched_box_ipm_solver) to XLA, whose fusions
// on the TPU are few and large.  The port's op-by-op version (the same
// function in pymgrid_tpu_torch/core/lp.py) runs ~290 small kernels an
// iteration, and the MPC planner's hour (130 iterations of up to 200
// problems) waits on their latency: a 48-row problem leaves the card idle
// inside every kernel.
//
// Bound: the dependency chain, not operations or bytes.  An iteration is
// ~1.1 MFLOP per problem (M = A diag(d) A' from a 48 x 192 A, a 48-row
// Cholesky, 2-6 pairs of triangular solves, ~10 matvecs with A): far below
// the card's float32 rate, and A (36.9 KB) is read from device memory once
// a solve.  What the design does about the chain:
//
// * The block keeps the problem in shared memory for the whole solve: the
//   scaled A, M (full, for the refinement's residual), its factor L and
//   every iterate and direction vector.  Nothing touches device memory
//   between the first load and the last store.
// * M's lower triangle is formed by 4 x 4 register tiles from a stored A'
//   (four rows of A a 16-byte read), the columns of A split among three
//   thread groups (48 rows: 78 tiles), so every warp works; their partial
//   sums are added in group order.
// * The Cholesky is right-looking and in place, in blocks of 32 columns:
//   warp 0 factors a diagonal block in registers (an entry is one shuffle),
//   the warps solve the rows below it, the block updates the rest; three
//   barriers a block, not one a column.
// * Both triangular solves run in warp 0, 32 rows at a time: each lane holds
//   its row's entries of the block in registers and a row costs one
//   shuffle, with no block barrier.  Refinement residuals stay in that warp.
// * Matvecs with A interleave two rows a warp (or two partial sums a
//   column), so two dependency chains overlap.
// * Block reductions (sums, maxima, the step-length minima) are warp
//   butterflies and one pass over the warps' partials in warp order; the
//   finite guard is __syncthreads_and.  No atomics: the same inputs give
//   the same bits, launched eagerly or replayed from a CUDA graph.
//
// The arithmetic is the op-by-op version's, step for step, in float32:
// every elementwise operation in the same order (built with --fmad=false,
// so each rounds as an eager op does); dot products and reductions are fused
// multiply-adds in another order than cuBLAS's, so the two agree to
// rounding, not bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct BoxIpmArgs {
  const float* A;        // (stack, me, n) row-scaled equality matrices
  const float* bb;       // (problems, me) scaled right-hand sides
  const float* cn;       // (problems, n) normalized costs
  const float* lo;       // (problems, n) lower bounds
  const float* free;     // (problems, n) 1, or 0 where the box is pinned
  const float* s;        // (problems, n) start: x - lo
  const float* t;        // (problems, n) start: hi - x
  const float* scalars;  // (problems, 3): scale (the dual start), reg, 2 * free count
  float* best;           // (problems, 4, n) out: s, t, z, w of the best iterate
  int* rejected;         // (problems,) out: iterations whose step was not finite
  long long problems;
  int stack, me, n, iters, refine, smem_bytes;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;
constexpr int kSmemLimit = 232448;            // bytes a block may use on sm_90
// vectors of length n and of length me in shared memory (see the kernel)
constexpr int kNVectors = 21;
constexpr int kMVectors = 8;
constexpr unsigned kFull = 0xffffffffu;

enum : int { kBadLayout = -1, kBadShape = -2 };

struct Layout {
  int lda, ldt, ldm, nv, mv;             // row strides and vector strides
  int A, AT, M, L, vn, vm, red, floats;  // offsets, in floats
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// Odd row strides keep a warp's column reads on distinct banks; A' (for
// 16-byte reads of four rows of A) takes an odd number of 16-byte words a
// row.  Mirrored by smem_bytes in pymgrid_tpu_torch/ops/box_ipm.py.
__host__ __device__ inline Layout make_layout(int me, int n) {
  Layout l;
  l.lda = n | 1;
  l.ldt = 4 * ((up4(me) / 4) | 1);
  l.ldm = me | 1;
  l.nv = up4(n);
  l.mv = up4(me);
  l.A = 0;
  l.AT = up4(me * l.lda);
  l.M = l.AT + n * l.ldt;
  l.L = l.M + up4(me * l.ldm);
  l.vn = l.L + up4(me * l.ldm);
  l.vm = l.vn + kNVectors * l.nv;
  l.red = l.vm + kMVectors * l.mv;
  l.floats = l.red + 2 * kWarps * 4;
  return l;
}

constexpr float kInf = INFINITY;

// torch.minimum / amax semantics: a NaN wins
__device__ __forceinline__ float nanmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }
// torch.clamp semantics: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// _max_step: min(1, 0.995 * min ratio)
__device__ __forceinline__ float max_step(float ratio) {
  const float v = 0.995f * ratio;
  return v > 1.0f ? 1.0f : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// Reduce NV values over the block; every thread gets the same result.
// `combine(j, a, b)` folds slot j.  Two alternating scratch buffers make one
// barrier enough: a buffer is written again only after the next reduction's
// barrier, which every thread reaches after reading this one.
template <int NV, class F>
__device__ __forceinline__ void block_reduce(float (&v)[NV], F combine, float* red,
                                             int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v[j] = combine(j, v[j], __shfl_xor_sync(kFull, v[j], m));
  }
  float* buf = red + parity * kWarps * 4;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) buf[warp * 4 + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float r = buf[j];
    for (int w = 1; w < kWarps; ++w) r = combine(j, r, buf[w * 4 + j]);
    v[j] = r;
  }
  parity ^= 1;
}

// The steps of one block of a substitution, one shuffle a row: row j's
// solution (acc * inv on lane j) goes to every lane, which takes it off its
// own row with its factor entry f[j].  NB, the block's rows rounded up to
// a multiple of 8, is a template argument so the loop has no branch (a
// branch around the shuffles keeps them from overlapping); rows from the
// block's end to NB hold zeros.  Returns the lane's solution.
template <int NB, bool kForward>
__device__ __forceinline__ float block_steps(float acc, float inv, const float (&f)[32],
                                             int lane) {
  float mine = 0.0f;
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const int j = kForward ? s : NB - 1 - s;
    const float xj = __shfl_sync(kFull, acc * inv, j);
    if (lane == j) mine = xj;
    acc = fmaf(-f[j], xj, acc);
  }
  return mine;
}

template <bool kForward>
__device__ __forceinline__ float block_solve(float acc, float inv, const float (&f)[32],
                                             int nb, int lane) {
  if (nb > 24) return block_steps<32, kForward>(acc, inv, f, lane);
  if (nb > 16) return block_steps<24, kForward>(acc, inv, f, lane);
  if (nb > 8) return block_steps<16, kForward>(acc, inv, f, lane);
  return block_steps<8, kForward>(acc, inv, f, lane);
}

// (L L')^-1 `in` into `out` by one warp, 32 rows at a time: lane j owns
// row r0 + j of a block, takes the rows above (forward) or below (backward)
// the block as one dot product, then walks the block's columns with the
// factor's entries already in registers.  `wbuf` holds the forward
// solution; `out` may be `in`.  The factor's strictly lower entries are in
// L, the reciprocals of its diagonal in inv_diag.
__device__ void chol_solve(const float* L, int ldm, const float* inv_diag, int me,
                           const float* in, float* wbuf, float* out, int lane) {
  for (int r0 = 0; r0 < me; r0 += 32) {           // L w = in
    const int i = r0 + lane, nb = min(32, me - r0);
    const bool valid = i < me;
    float acc = 0.0f, inv = 0.0f;
    float lrow[32];
    if (valid) {
      acc = in[i];
      for (int p = 0; p < r0; ++p) acc = fmaf(-L[i * ldm + p], wbuf[p], acc);
      inv = inv_diag[i];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) lrow[j] = (valid && r0 + j < i) ? L[i * ldm + r0 + j] : 0.0f;
    const float mine = block_solve<true>(acc, inv, lrow, nb, lane);
    if (valid) wbuf[i] = mine;
    __syncwarp();
  }
  for (int r0 = (me - 1) & ~31; r0 >= 0; r0 -= 32) {   // L' x = w
    const int i = r0 + lane, nb = min(32, me - r0);
    const bool valid = i < me;
    float acc = 0.0f, inv = 0.0f;
    float lcol[32];
    if (valid) {
      acc = wbuf[i];
      for (int p = me - 1; p >= r0 + 32; --p) acc = fmaf(-L[p * ldm + i], out[p], acc);
      inv = inv_diag[i];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      lcol[j] = (valid && r0 + j > i && r0 + j < me) ? L[(r0 + j) * ldm + i] : 0.0f;
    const float mine = block_solve<false>(acc, inv, lcol, nb, lane);
    __syncwarp();
    if (valid) out[i] = mine;
    __syncwarp();
  }
}

// dy = solve(rhs) + failed, then `refine` times dy += solve(rhs - M dy) +
// failed, by warp 0 (op path: newton's _tri_solve calls).  `failed` is 0, or
// NaN where the factorization failed.
__device__ void newton_solve(const float* L, const float* M, int ldm, const float* inv_diag,
                             int me, const float* rhs, float* dy, float* res, float* wbuf,
                             int refine, float failed, int lane) {
  chol_solve(L, ldm, inv_diag, me, rhs, wbuf, dy, lane);
  for (int i = lane; i < me; i += 32) dy[i] = dy[i] + failed;
  for (int r = 0; r < refine; ++r) {
    __syncwarp();
    for (int i = lane; i < me; i += 32) {
      const float* row = M + i * ldm;
      float acc = 0.0f;
      for (int j = 0; j < me; ++j) acc = fmaf(row[j], dy[j], acc);
      res[i] = rhs[i] - acc;
    }
    __syncwarp();
    chol_solve(L, ldm, inv_diag, me, res, wbuf, res, lane);
    for (int i = lane; i < me; i += 32) dy[i] = dy[i] + (res[i] + failed);
  }
}

// Factor one diagonal block of at most NB rows in registers, lane i holding
// the block's row i in a (NB a template argument, as in block_steps; rows
// from nb on hold zeros and neither store nor count).  Column k's entry of
// row j is one shuffle.  Every lane computes the next pivot from row k+1's
// two entries, fetched before column k's update, as lane k+1's update
// gives it.  Returns whether a pivot was not positive.
template <int NB>
__device__ __forceinline__ bool diag_block(float (&a)[32], float* inv_diag, int nb, int lane) {
  bool failed = false;
  float piv = __shfl_sync(kFull, a[0], 0);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float u = __shfl_sync(kFull, a[k], (k + 1) & 31);
    const float w = __shfl_sync(kFull, a[(k + 1) & 31], (k + 1) & 31);
    const float inv = 1.0f / sqrtf(piv);
    if (k < nb) {
      failed = failed || !(piv > 0.0f);
      if (lane == k) inv_diag[k] = inv;
    }
    const float lik = a[k] * inv;
    if (lane > k) a[k] = lik;
#pragma unroll
    for (int j = k + 1; j < NB; ++j) a[j] = fmaf(-lik, __shfl_sync(kFull, lik, j), a[j]);
    const float l = u * inv;
    piv = fmaf(-l, l, w);
  }
  return failed;
}

// Cholesky of M in place (its lower triangle in L, the reciprocals of the
// factor's diagonal into inv_diag), right-looking in blocks of 32 columns:
// warp 0 factors the diagonal block in registers (lane i holds the block's
// row i; an entry of a column is one shuffle), the warps solve the rows
// below against it, then the block updates the trailing rows.  Every entry
// takes its updates in column order, as the unblocked algorithm gives them.
// Returns, in warp 0, whether a pivot was not positive (NaN included).
__device__ bool cholesky(float* L, int ldm, float* inv_diag, int me, int tid, int lane,
                         int warp) {
  bool failed = false;
  for (int kb = 0; kb < me; kb += 32) {
    const int nb = min(32, me - kb);
    if (warp == 0) {
      float a[32];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        a[j] = (lane < nb && j <= lane) ? L[(kb + lane) * ldm + kb + j] : 0.0f;
      if (nb > 24) failed = diag_block<32>(a, inv_diag + kb, nb, lane) || failed;
      else if (nb > 16) failed = diag_block<24>(a, inv_diag + kb, nb, lane) || failed;
      else if (nb > 8) failed = diag_block<16>(a, inv_diag + kb, nb, lane) || failed;
      else failed = diag_block<8>(a, inv_diag + kb, nb, lane) || failed;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < lane && lane < nb) L[(kb + lane) * ldm + kb + j] = a[j];
    }
    __syncthreads();
    if (kb + 32 >= me) break;
    {                                              // the rows below the block
      float lrow[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) lrow[k] = k < lane ? L[(kb + lane) * ldm + kb + k] : 0.0f;
      const float inv = inv_diag[kb + lane];
      for (int i = kb + 32 + warp; i < me; i += kWarps) {
        float x = L[i * ldm + kb + lane];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float xk = __shfl_sync(kFull, x * inv, k);
          if (lane == k) x = xk;
          else if (lane > k) x = fmaf(-xk, lrow[k], x);
        }
        L[i * ldm + kb + lane] = x;
      }
    }
    __syncthreads();
    const int r0 = kb + 32, m2 = me - r0;          // the trailing rows
    for (int e = tid; e < m2 * m2; e += kThreads) {
      const int i = r0 + e / m2, j = r0 + e % m2;
      if (j > i) continue;
      float v = L[i * ldm + j];
      for (int p = kb; p < kb + 32; ++p) v = fmaf(-L[i * ldm + p], L[j * ldm + p], v);
      L[i * ldm + j] = v;
    }
    __syncthreads();
  }
  return failed;
}

__global__ void __launch_bounds__(kThreads, 2) box_ipm_kernel(BoxIpmArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int me = a.me, n = a.n;
  const Layout l = make_layout(me, n);
  const int lda = l.lda, ldm = l.ldm;
  float* A = sm + l.A;
  float* AT = sm + l.AT;                // A', rows padded with zeros to ldt
  const int ldt = l.ldt;
  float* M = sm + l.M;
  float* L = sm + l.L;
  float* vn = sm + l.vn;
  float *cn = vn, *lo = vn + l.nv, *fr = vn + 2 * l.nv;
  float *s = vn + 3 * l.nv, *t = vn + 4 * l.nv, *z = vn + 5 * l.nv, *w = vn + 6 * l.nv;
  float *bs = vn + 7 * l.nv, *bt = vn + 8 * l.nv, *bz = vn + 9 * l.nv, *bw = vn + 10 * l.nv;
  float *rc = vn + 11 * l.nv, *d = vn + 12 * l.nv, *g = vn + 13 * l.nv, *dg = vn + 14 * l.nv;
  float *dxa = vn + 15 * l.nv, *dza = vn + 16 * l.nv, *dwa = vn + 17 * l.nv;
  float *dx = vn + 18 * l.nv, *dz = vn + 19 * l.nv, *dw = vn + 20 * l.nv;
  float* vm = sm + l.vm;
  float *bb = vm, *y = vm + l.mv, *rb = vm + 2 * l.mv, *rhs = vm + 3 * l.mv;
  float *dy = vm + 4 * l.mv, *res = vm + 5 * l.mv, *inv_diag = vm + 6 * l.mv;
  float* wbuf = vm + 7 * l.mv;
  float* red = sm + l.red;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t p = blockIdx.x;
  int parity = 0;

  // ---- load the problem
  const float* Ag = a.A + (p % a.stack) * static_cast<int64_t>(me) * n;
  for (int e = tid; e < me * n; e += kThreads) {
    const int i = e / n, k = e - i * n;
    A[i * lda + k] = Ag[e];
    AT[k * ldt + i] = Ag[e];
  }
  for (int e = tid; e < n * (ldt - me); e += kThreads) {
    const int k = e / (ldt - me);
    AT[k * ldt + me + (e - k * (ldt - me))] = 0.0f;
  }
  const float scale = a.scalars[p * 3], reg = a.scalars[p * 3 + 1];
  const float two_n = a.scalars[p * 3 + 2];
  for (int k = tid; k < n; k += kThreads) {
    const int64_t e = p * n + k;
    cn[k] = a.cn[e];
    lo[k] = a.lo[e];
    fr[k] = a.free[e];
    bs[k] = s[k] = a.s[e];
    bt[k] = t[k] = a.t[e];
    bz[k] = z[k] = scale;
    bw[k] = w[k] = scale;
  }
  for (int i = tid; i < me; i += kThreads) {
    bb[i] = a.bb[p * me + i];
    y[i] = 0.0f;
  }
  __syncthreads();

  auto sum2 = [](int, float x, float y2) { return x + y2; };
  auto min2 = [](int, float x, float y2) { return nanmin(x, y2); };
  // slots 0, 1 sums; 2, 3 maxima
  auto merit4 = [](int j, float x, float y2) { return j < 2 ? x + y2 : nanmax(x, y2); };

  // A' v at column k: two interleaved partial sums (even and odd rows),
  // four rows a 16-byte read
  auto col_dot = [&](int k, const float* vec) {
    const float* col = AT + k * ldt;
    float e = 0.0f, o = 0.0f;
    int i = 0;
    for (; i + 3 < me; i += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(col + i);
      const float4 v4 = *reinterpret_cast<const float4*>(vec + i);
      e = fmaf(a4.x, v4.x, e);
      o = fmaf(a4.y, v4.y, o);
      e = fmaf(a4.z, v4.z, e);
      o = fmaf(a4.w, v4.w, o);
    }
    for (; i < me; ++i) {
      if (i % 2 == 0) e = fmaf(col[i], vec[i], e);
      else o = fmaf(col[i], vec[i], o);
    }
    return e + o;
  };

  // A v at rows i and i2 by one warp: two butterflies that overlap; `vec(k)`
  // gives v's entries
  auto row_dots = [&](int i, int i2, const auto& vec, float& r1, float& r2) {
    const float* row = A + i * lda;
    const float* row2 = A + i2 * lda;
    float acc = 0.0f, acc2 = 0.0f;
    for (int k = lane; k < n; k += 32) {
      const float vk = vec(k);
      acc = fmaf(row[k], vk, acc);
      acc2 = fmaf(row2[k], vk, acc2);
    }
    r1 = warp_sum(acc);
    r2 = warp_sum(acc2);
  };

  // r_b = A x(s) - bb (a warp two rows), r_c = A' y + z - w - cn (a thread
  // a column), and the partials of mean_compl and of the merit's maxima:
  // returns (mu, merit) of the current iterate
  auto residuals = [&](float& mu, float& merit) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const auto x_of = [&](int k) { return lo[k] + (fr[k] == 0.0f ? 0.0f : s[k]); };
    for (int i = warp; i < me; i += 2 * kWarps) {
      const int i2 = i + kWarps;
      float r1, r2;
      row_dots(i, i2 < me ? i2 : i, x_of, r1, r2);
      if (lane == 0) {
        rb[i] = r1 - bb[i];
        v[2] = nanmax(v[2], fabsf(rb[i]));
        if (i2 < me) {
          rb[i2] = r2 - bb[i2];
          v[2] = nanmax(v[2], fabsf(rb[i2]));
        }
      }
    }
    for (int k = tid; k < n; k += kThreads) {
      const float r = ((col_dot(k, y) + z[k]) - w[k]) - cn[k];
      rc[k] = r;
      v[0] += (fr[k] * s[k]) * z[k];
      v[1] += (fr[k] * t[k]) * w[k];
      v[3] = nanmax(v[3], fabsf(fr[k] * r));
    }
    block_reduce(v, merit4, red, parity);
    mu = (v[0] + v[1]) / two_n;
    merit = (mu + v[2]) + v[3];
  };

  // rhs = -r_b - A v (a warp two rows)
  auto rhs_of = [&](const float* vec) {
    const auto at = [&](int k) { return vec[k]; };
    for (int i = warp; i < me; i += 2 * kWarps) {
      const int i2 = i + kWarps;
      float r1, r2;
      row_dots(i, i2 < me ? i2 : i, at, r1, r2);
      if (lane == 0) {
        rhs[i] = -rb[i] - r1;
        if (i2 < me) rhs[i2] = -rb[i2] - r2;
      }
    }
  };

  // dx = d (A' dy + g), dz, dw from the complementarity targets; returns
  // the primal and dual step lengths (op path: newton's tail and steps)
  auto directions = [&](float* dxo, float* dzo, float* dwo, bool corrector, float smu,
                        float& a_p, float& a_d) {
    float v[2] = {kInf, kInf};
    for (int k = tid; k < n; k += kThreads) {
      const float acc = col_dot(k, dy);
      const float sk = s[k], tk = t[k], zk = z[k], wk = w[k], fk = fr[k];
      float rs = -sk * zk, rt = -tk * wk;
      if (corrector) {
        rs = (smu - sk * zk) - dxa[k] * dza[k];
        rt = (smu - tk * wk) + dxa[k] * dwa[k];
      }
      const float dxk = d[k] * (acc + g[k]);
      const float dzk = (fk * (rs - zk * dxk)) / sk;
      const float dwk = (fk * (rt + wk * dxk)) / tk;
      dxo[k] = dxk;
      dzo[k] = dzk;
      dwo[k] = dwk;
      v[0] = nanmin(v[0], nanmin(dxk < 0.0f ? -sk / dxk : kInf, dxk > 0.0f ? tk / dxk : kInf));
      v[1] = nanmin(v[1], nanmin(dzk < 0.0f ? -zk / dzk : kInf, dwk < 0.0f ? -wk / dwk : kInf));
    }
    block_reduce(v, min2, red, parity);
    a_p = max_step(v[0]);
    a_d = max_step(v[1]);
  };

  const int tm = (me + kTile - 1) / kTile;
  const int ntiles = tm * (tm + 1) / 2;
  const int parts = max(1, min(4, kThreads / ntiles));

  // tile `tile` of M's lower triangle (rows i0.., columns j0..), its sum over
  // the columns of A in part `part` of `parts`
  auto tile_sums = [&](int tile, int part, float (&acc)[kTile][kTile], int& i0, int& j0) {
    int ti = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > tile) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    i0 = kTile * ti;
    j0 = kTile * (tile - ti * (ti + 1) / 2);
#pragma unroll
    for (int q = 0; q < kTile; ++q)
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[q][r] = 0.0f;
    const int k_end = (part + 1) * n / parts;
#pragma unroll 2
    for (int k = part * n / parts; k < k_end; ++k) {
      const float dk = d[k];
      // rows i0.. and j0.. of A at column k: one 16-byte read each
      const float4 ri = *reinterpret_cast<const float4*>(AT + k * ldt + i0);
      const float4 rj = *reinterpret_cast<const float4*>(AT + k * ldt + j0);
      const float ai[kTile] = {dk * ri.x, dk * ri.y, dk * ri.z, dk * ri.w};
      const float aj[kTile] = {rj.x, rj.y, rj.z, rj.w};
#pragma unroll
      for (int q = 0; q < kTile; ++q)
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[q][r] = fmaf(ai[q], aj[r], acc[q][r]);
    }
  };

  // store a tile's sums into M (the first part) or add them to it; the last
  // part adds reg on the diagonal and fills the upper triangle and L
  auto tile_store = [&](const float (&acc)[kTile][kTile], int i0, int j0, bool first,
                        bool last) {
#pragma unroll
    for (int q = 0; q < kTile; ++q)
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int i = i0 + q, j = j0 + r;
        if (i < me && j <= i) {
          float m = first ? acc[q][r] : M[i * ldm + j] + acc[q][r];
          if (last) {
            if (i == j) m = m + reg;
            M[j * ldm + i] = m;
            L[i * ldm + j] = m;
          }
          M[i * ldm + j] = m;
        }
      }
  };

  float mu, merit;
  residuals(mu, merit);
  float best_merit = kInf;
  int rejected = 0;

  for (int it = 0; it < a.iters; ++it) {
    // ---- d, and the predictor's g and d g
    for (int k = tid; k < n; k += kThreads) {
      const float sk = s[k], tk = t[k], zk = z[k], wk = w[k];
      const float dk = fr[k] / clampf(zk / sk + wk / tk, 1e-10f, 1e10f);
      const float rs = -sk * zk, rt = -tk * wk;
      const float gk = (rc[k] + rs / sk) - rt / tk;
      d[k] = dk;
      g[k] = gk;
      dg[k] = dk * gk;
    }
    __syncthreads();

    // ---- M = A diag(d) A' + reg I: 4 x 4 register tiles of its lower
    // triangle (M kept whole, L its lower triangle).  Where the tiles leave
    // threads over, the columns are split among `parts` thread groups, one
    // tile a thread, whose partial sums are added in group order; the
    // predictor's right-hand side in between
    if (parts == 1) {
      for (int tile = tid; tile < ntiles; tile += kThreads) {
        float acc[kTile][kTile];
        int i0, j0;
        tile_sums(tile, 0, acc, i0, j0);
        tile_store(acc, i0, j0, true, true);
      }
      rhs_of(dg);
      __syncthreads();
    } else {
      const int part = tid / ntiles;
      float acc[kTile][kTile];
      int i0 = 0, j0 = 0;
      if (part < parts) tile_sums(tid % ntiles, part, acc, i0, j0);
      rhs_of(dg);
      for (int pp = 0; pp < parts; ++pp) {
        if (part == pp) tile_store(acc, i0, j0, pp == 0, pp == parts - 1);
        __syncthreads();
      }
    }

    // ---- Cholesky (failed: a pivot was not positive, known in warp 0)
    const bool failed = cholesky(L, ldm, inv_diag, me, tid, lane, warp);
    const float failed_nan = failed ? __int_as_float(0x7fc00000) : 0.0f;

    // ---- predictor (affine)
    if (warp == 0)
      newton_solve(L, M, ldm, inv_diag, me, rhs, dy, res, wbuf, a.refine, failed_nan, lane);
    __syncthreads();
    float a_p, a_d;
    directions(dxa, dza, dwa, false, 0.0f, a_p, a_d);
    float sigma;
    {
      float v[2] = {0.0f, 0.0f};
      for (int k = tid; k < n; k += kThreads) {
        v[0] += (fr[k] * (s[k] + a_p * dxa[k])) * (z[k] + a_d * dza[k]);
        v[1] += (fr[k] * (t[k] - a_p * dxa[k])) * (w[k] + a_d * dwa[k]);
      }
      block_reduce(v, sum2, red, parity);
      const float mu_aff = (v[0] + v[1]) / two_n;
      const float q = mu_aff / mu;
      sigma = mu > 0.0f ? q * q * q : 0.0f;
    }

    // ---- corrector (same factorization)
    const float smu = sigma * mu;
    for (int k = tid; k < n; k += kThreads) {
      const float sk = s[k], tk = t[k], zk = z[k], wk = w[k];
      const float rs = (smu - sk * zk) - dxa[k] * dza[k];
      const float rt = (smu - tk * wk) + dxa[k] * dwa[k];
      const float gk = (rc[k] + rs / sk) - rt / tk;
      g[k] = gk;
      dg[k] = d[k] * gk;
    }
    __syncthreads();
    rhs_of(dg);
    __syncthreads();
    if (warp == 0)
      newton_solve(L, M, ldm, inv_diag, me, rhs, dy, res, wbuf, a.refine, failed_nan, lane);
    __syncthreads();
    directions(dx, dz, dw, true, smu, a_p, a_d);

    // ---- keep iterating unless non-finite
    bool ok = true;
    for (int k = tid; k < n; k += kThreads) {
      ok = ok && isfinite(s[k] + a_p * dx[k]) && isfinite(t[k] - a_p * dx[k])
           && isfinite(z[k] + a_d * dz[k]) && isfinite(w[k] + a_d * dw[k]);
    }
    for (int i = tid; i < me; i += kThreads) ok = ok && isfinite(y[i] + a_d * dy[i]);
    if (__syncthreads_and(ok)) {
      for (int k = tid; k < n; k += kThreads) {
        s[k] = s[k] + a_p * dx[k];
        t[k] = t[k] - a_p * dx[k];
        z[k] = z[k] + a_d * dz[k];
        w[k] = w[k] + a_d * dw[k];
      }
      for (int i = tid; i < me; i += kThreads) y[i] = y[i] + a_d * dy[i];
    } else {
      ++rejected;
    }
    __syncthreads();

    // ---- the best iterate by merit (first minimum wins); the residuals
    // and mu are the next iteration's
    residuals(mu, merit);
    if (merit < best_merit) {
      best_merit = merit;
      for (int k = tid; k < n; k += kThreads) {
        bs[k] = s[k];
        bt[k] = t[k];
        bz[k] = z[k];
        bw[k] = w[k];
      }
    }
  }

  float* out = a.best + p * 4 * n;
  for (int k = tid; k < n; k += kThreads) {
    out[k] = bs[k];
    out[n + k] = bt[k];
    out[2 * n + k] = bz[k];
    out[3 * n + k] = bw[k];
  }
  if (tid == 0) a.rejected[p] = rejected;
}

}  // namespace

// Bytes of the block's shared memory for (me, n): the binding checks its own
// count against this one.
extern "C" int box_ipm_smem_bytes(int me, int n) {
  return 4 * make_layout(me, n).floats;
}

// Let the kernel take up to the sm_90 limit of dynamic shared memory on the
// current device (outside any capture: the binding calls it once per solver,
// with the solver's device current).  Neither entry point changes the current
// device: the binding makes the solver's device current around both.
extern "C" int box_ipm_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      box_ipm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
}

extern "C" int box_ipm_launch(const BoxIpmArgs* args, void* stream) {
  const BoxIpmArgs& a = *args;
  if (a.me <= 0 || a.n <= 0 || a.stack <= 0 || a.iters < 0 || a.refine < 0)
    return kBadShape;
  if (a.smem_bytes != box_ipm_smem_bytes(a.me, a.n) || a.smem_bytes > kSmemLimit)
    return kBadLayout;
  if (a.problems <= 0) return 0;
  box_ipm_kernel<<<static_cast<unsigned int>(a.problems), kThreads, a.smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
