// Fused-horizon rule-based-control rollout for Hopper (sm_90a).
//
// Replaces pymgrid_tpu/ops/pallas_rollout.py:make_pallas_rbc_rollout (the
// Pallas TPU kernel).  Each thread owns R replicas for the whole horizon:
// battery charge, the four genset counters and the reward accumulator live
// in registers; per step the thread runs the marginal-cost RBC policy with
// the static deploy order, the genset status machine, battery / grid dispatch
// and the PV + balancing flex phase for each of its replicas, and adds the
// step's reward.
//
// Bound: operations on a serial per-replica chain (charge feeds the next
// step through two IEEE divisions), not bytes: the inputs are one 32-byte
// row per step shared by every replica, and nothing is written until the
// end.  What the design does about it:
//
// * The deploy order and the module set are template parameters (8
//   variants, picked on the host by a variant code), so the step has no
//   run-time order array, loop over deploy kinds or genset tests.
// * The series rows of a chunk of kChunk steps arrive in shared memory by a
//   1-D bulk copy (cp.async.bulk, completion on an mbarrier) one chunk ahead
//   of use, into a double-buffered ring.  Once a chunk has landed, the block
//   turns each row, in place, into the terms that do not depend on the
//   replica (-load, pv, load - pv, max_imp*status, max_exp*status,
//   price_imp + cost_co2*co2, price_exp), each computed once per block with
//   the plain version's float32 operations.  The per-step reads are then two
//   shared-memory broadcasts, off the dependency chain.
// * R independent replicas per thread interleave their steps, so each warp
//   carries R chains to hide the chain's latency with: RBC_REPLICAS (2) for
//   the variants without the genset, RBC_GENSET_REPLICAS (1) for those with
//   it, whose status machine is long enough to fill the issue slots alone;
//   RBC_THREADS (256) threads per block.  The launch bounds ask for two
//   resident blocks per SM: without that hint ptxas held most variants to 80
//   registers and spilled 44-68 bytes.
//
// Built with --fmad=false and IEEE division so that every operation rounds
// as the plain PyTorch version's eager ops do, in the same order
// (pymgrid_tpu_torch/ops/rbc_rollout.py:plain_rbc_rollout): the two agree
// bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RBC_THREADS
#define RBC_THREADS 256
#endif
#ifndef RBC_REPLICAS
#define RBC_REPLICAS 2
#endif
#ifndef RBC_GENSET_REPLICAS
#define RBC_GENSET_REPLICAS 1
#endif

namespace {

enum DeployKind : int { kNone = -1, kBattery = 0, kGrid = 1, kGenset = 2 };

// Steps per chunk: two stages of kChunk 32-byte rows are 16 KB of shared
// memory per block.
constexpr int kChunk = 256;
constexpr int kMinBlocksPerSM = 2;

// Return codes of rbc_rollout_launch besides CUDA's own (all positive).
constexpr int kUnknownVariant = -1;
constexpr int kMisaligned = -2;

}  // namespace

// Host-computed constants (pallas_rollout.py:80-121); layout mirrored by the
// ctypes Structure in pymgrid_tpu_torch/ops/rbc_rollout.py.
struct RbcParams {
  float min_cap, max_cap, max_charge, max_discharge, eff, cycle;
  float max_imp, max_exp, cost_co2;
  float loss_cost, over_cost;
  float g_min, g_max, g_cost, g_co2, g_cost_co2;
  int32_t g_start_up, g_wind_down, g_abort, g_init_status, g_goal;
  int32_t t0, n_steps;
};

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread: expect `bytes` on `bar`, then copy them from global to shared.
__device__ __forceinline__ void bulk_load(float4* dst, const float4* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float deploy(float r, float max_p, float max_c) {
  const bool near0 = fabsf(r) <= 1e-4f;
  const float produce = fminf(r, max_p);
  const float consume = fmaxf(r, -max_c);
  return near0 ? 0.0f : (r > 0.0f ? produce : consume);
}

// physics.genset_next_status
__device__ __forceinline__ int next_status(int cur, int up, int down, int goal) {
  const int if_on = cur == 1 ? 1 : (up == 0 ? 1 : 0);
  const int if_off = cur == 0 ? 0 : (down == 0 ? 0 : 1);
  return goal == 1 ? if_on : if_off;
}

// physics.genset_update_status, branch for branch
__device__ __forceinline__ void update_status(int& cur, int& goal_st, int& up,
                                              int& down, int goal, int sut,
                                              int wdt, bool abort) {
  const bool equilibrium = (goal == cur) && (cur == goal_st);
  const bool instant_up = (sut == 0) && (goal == 1);
  const bool instant_down = (wdt == 0) && (goal == 0);
  const bool accept = (goal != goal_st) && (abort || instant_up || instant_down);
  const int goal1 = accept ? goal : goal_st;

  const bool fin_up = (up == 0) && (goal1 == 1);
  const bool fin_down = (!fin_up) && (down == 0) && (goal1 == 0);
  const bool finished = fin_up || fin_down;
  const int cur1 = fin_up ? 1 : (fin_down ? 0 : cur);
  const int up1 = fin_up ? 0 : (fin_down ? sut : up);
  const int down1 = fin_up ? wdt : (fin_down ? 0 : down);

  const bool new_request = (cur1 == goal1) && (goal1 != goal);
  const int up2 = new_request ? (cur1 == 1 ? 0 : sut) : up1;
  const int down2 = new_request ? (cur1 == 1 ? wdt : 0) : down1;
  const int goal2 = new_request ? goal : goal1;

  const bool in_progress = goal2 != cur1;
  const int up3 = (in_progress && goal2 == 1) ? up2 - 1 : up2;
  const int down3 = (in_progress && goal2 == 0) ? down2 - 1 : down2;

  if (!equilibrium) {
    cur = cur1;
    goal_st = finished ? goal1 : goal2;
    up = finished ? up1 : up3;
    down = finished ? down1 : down3;
  }
}

// One replica's state.
struct Replica {
  float charge, acc;
  int gcur, ggoal, gup, gdown;
};

// Deploy `kind` on what remains of the load (policy phase).
template <int kind>
__device__ __forceinline__ void deploy_kind(float& remaining, float& a_b,
                                            float& a_g, float& a_gen,
                                            float max_prod_b, float max_cons_b,
                                            float max_prod_g, float max_cons_g,
                                            float nsf, const RbcParams& p) {
  if constexpr (kind == kBattery) {
    a_b = deploy(remaining, max_prod_b, max_cons_b);
    remaining = remaining - a_b;
  } else if constexpr (kind == kGrid) {
    a_g = deploy(remaining, max_prod_g, max_cons_g);
    remaining = remaining - a_g;
  } else if constexpr (kind == kGenset) {
    // produce only, within the predicted status bounds
    const bool near0 = fabsf(remaining) <= 1e-4f;
    const float produce = fminf(fmaxf(remaining, nsf * p.g_min), nsf * p.g_max);
    a_gen = near0 ? 0.0f : (remaining > 0.0f ? produce : 0.0f);
    remaining = remaining - a_gen;
  }
}

// One step of one replica.  ta = (load, pv, load - pv, max_imp*status),
// tb = (max_exp*status, price_imp + cost_co2*co2, price_exp, 0): the row's
// replica-independent terms.
template <int K0, int K1, int K2, bool kGensetOn>
__device__ __forceinline__ void step(Replica& s, const float4 ta, const float4 tb,
                                     const RbcParams& p) {
  const float load = ta.x;
  const float pv = ta.y;

  // ---- marginal-cost RBC policy, static deploy order ----
  float remaining = ta.z;
  const float max_prod_b = fminf(p.max_discharge, s.charge - p.min_cap) * p.eff;
  const float max_cons_b = fminf(p.max_charge, p.max_cap - s.charge) / p.eff;

  float a_b = 0.0f, a_g = 0.0f, a_gen = 0.0f;
  float nsf = 0.0f;
  if constexpr (kGensetOn) {
    nsf = static_cast<float>(next_status(s.gcur, s.gup, s.gdown, p.g_goal));
  }
  deploy_kind<K0>(remaining, a_b, a_g, a_gen, max_prod_b, max_cons_b, ta.w, tb.x,
                  nsf, p);
  deploy_kind<K1>(remaining, a_b, a_g, a_gen, max_prod_b, max_cons_b, ta.w, tb.x,
                  nsf, p);
  deploy_kind<K2>(remaining, a_b, a_g, a_gen, max_prod_b, max_cons_b, ta.w, tb.x,
                  nsf, p);

  // ---- dispatch ----
  float gen_prov = 0.0f, r_gen = 0.0f;
  if constexpr (kGensetOn) {
    update_status(s.gcur, s.ggoal, s.gup, s.gdown, p.g_goal, p.g_start_up,
                  p.g_wind_down, p.g_abort != 0);
    const float statusf = static_cast<float>(s.gcur);
    const float lo = statusf * p.g_min;
    const float hi = statusf * p.g_max;
    gen_prov = a_gen > hi ? hi : (a_gen < lo ? lo : a_gen);
    r_gen = -(p.g_cost * gen_prov + p.g_cost_co2 * (p.g_co2 * gen_prov));
  }
  const float b_prov = fmaxf(a_b, 0.0f);
  const float b_abs = fmaxf(-a_b, 0.0f);
  const float internal = a_b < 0.0f ? b_abs * p.eff : -b_prov / p.eff;
  const float new_charge = fmaxf(s.charge + internal, p.min_cap);
  const float r_batt = -fabsf(internal) * p.cycle;

  const float g_prov = fmaxf(a_g, 0.0f);
  const float g_abs = fmaxf(-a_g, 0.0f);
  const float r_grid = -tb.y * g_prov + tb.z * g_abs;

  const float diff = (gen_prov + b_prov + g_prov) - (load + b_abs + g_abs);
  const float needed = -diff;
  const float pv_used = diff > 0.0f ? 0.0f : fminf(pv, needed);
  const float resid = needed - pv_used;
  const float r_bal =
      diff > 0.0f ? -p.over_cost * diff : -p.loss_cost * fmaxf(resid, 0.0f);

  s.acc = s.acc + r_gen + r_batt + r_grid + r_bal;
  s.charge = new_charge;
}

// rows: (>= t0 + n_steps, 8) float32, row t = (load, pv, price_imp,
// price_exp, co2, status, 0, 0).  Block b owns replicas
// [b * NT * R, (b + 1) * NT * R); thread x of it replicas x + r * NT.
template <int NT, int R, int K0, int K1, int K2, bool kGensetOn>
__global__ void __launch_bounds__(NT, kMinBlocksPerSM)
    rbc_rollout_kernel(const RbcParams p, const float4* __restrict__ rows,
                       const float* __restrict__ init_charge,
                       float* __restrict__ out, int64_t B) {
  __shared__ __align__(128) float4 ring[2][2 * kChunk];
  __shared__ __align__(8) uint64_t full[2];

  const int64_t first = static_cast<int64_t>(blockIdx.x) * NT * R + threadIdx.x;
  Replica s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = first + static_cast<int64_t>(r) * NT;
    s[r].charge = i < B ? init_charge[i] : 0.0f;
    s[r].acc = 0.0f;
    s[r].gcur = p.g_init_status;
    s[r].ggoal = p.g_init_status;
    s[r].gup = p.g_init_status == 1 ? 0 : p.g_start_up;
    s[r].gdown = p.g_init_status == 1 ? p.g_wind_down : 0;
  }

  const int n_chunks = (p.n_steps + kChunk - 1) / kChunk;
  const float4* src = rows + 2 * static_cast<int64_t>(p.t0);
  auto chunk_bytes = [&](int k) {
    const int n = min(kChunk, p.n_steps - k * kChunk);
    return static_cast<uint32_t>(n) * 32u;
  };
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_chunks > 0) bulk_load(ring[0], src, chunk_bytes(0), &full[0]);
  }
  __syncthreads();

  for (int k = 0; k < n_chunks; ++k) {
    const int stage = k & 1;
    const int n = min(kChunk, p.n_steps - k * kChunk);
    float4* buf = ring[stage];
    mbar_wait(&full[stage], (k >> 1) & 1);

    // the chunk's rows -> their replica-independent terms, in place
    for (int j = threadIdx.x; j < n; j += NT) {
      const float4 a = buf[2 * j];      // load, pv, price_imp, price_exp
      const float4 b = buf[2 * j + 1];  // co2, status, 0, 0
      const float load = -a.x;
      buf[2 * j] = make_float4(load, a.y, load - a.y, p.max_imp * b.y);
      buf[2 * j + 1] = make_float4(p.max_exp * b.y, a.z + p.cost_co2 * b.x, a.w, 0.0f);
    }
    // every thread is done with the other stage (the previous chunk) and
    // this chunk's terms are visible
    __syncthreads();
    if (threadIdx.x == 0 && k + 1 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(ring[stage ^ 1], src + 2 * static_cast<int64_t>(k + 1) * kChunk,
                chunk_bytes(k + 1), &full[stage ^ 1]);
    }

    for (int j = 0; j < n; ++j) {
      const float4 ta = buf[2 * j];
      const float4 tb = buf[2 * j + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) step<K0, K1, K2, kGensetOn>(s[r], ta, tb, p);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = first + static_cast<int64_t>(r) * NT;
    if (i < B) out[i] = s[r].acc;
  }
}

template <int K0, int K1, int K2, bool kGensetOn>
void launch(const RbcParams& p, const float4* rows, const float* init, float* out,
            int64_t batch, cudaStream_t stream) {
  constexpr int R = kGensetOn ? RBC_GENSET_REPLICAS : RBC_REPLICAS;
  constexpr int64_t per_block = static_cast<int64_t>(RBC_THREADS) * R;
  const unsigned int blocks = static_cast<unsigned int>((batch + per_block - 1) / per_block);
  rbc_rollout_kernel<RBC_THREADS, R, K0, K1, K2, kGensetOn>
      <<<blocks, RBC_THREADS, 0, stream>>>(p, rows, init, out, batch);
}

}  // namespace

// The variant table: code -> deploy order (and whether the genset is
// there).  Mirrored by _VARIANTS in pymgrid_tpu_torch/ops/rbc_rollout.py.
extern "C" int rbc_rollout_launch(const RbcParams* params, int variant,
                                  const float* rows, const float* init_charge,
                                  float* out, long long batch, void* stream) {
  if (variant < 0 || variant > 7) return kUnknownVariant;
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0) return kMisaligned;
  if (batch <= 0) return 0;
  const RbcParams& p = *params;
  const float4* r = reinterpret_cast<const float4*>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: launch<kBattery, kGrid, kGenset, true>(p, r, init_charge, out, batch, s); break;
    case 1: launch<kBattery, kGenset, kGrid, true>(p, r, init_charge, out, batch, s); break;
    case 2: launch<kGrid, kBattery, kGenset, true>(p, r, init_charge, out, batch, s); break;
    case 3: launch<kGrid, kGenset, kBattery, true>(p, r, init_charge, out, batch, s); break;
    case 4: launch<kGenset, kBattery, kGrid, true>(p, r, init_charge, out, batch, s); break;
    case 5: launch<kGenset, kGrid, kBattery, true>(p, r, init_charge, out, batch, s); break;
    case 6: launch<kBattery, kGrid, kNone, false>(p, r, init_charge, out, batch, s); break;
    case 7: launch<kGrid, kBattery, kNone, false>(p, r, init_charge, out, batch, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
