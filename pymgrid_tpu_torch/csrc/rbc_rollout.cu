// Fused-horizon rule-based-control rollout for Hopper (sm_90a).
//
// Replaces pymgrid_tpu/ops/pallas_rollout.py:make_pallas_rbc_rollout (the
// Pallas TPU kernel).  One thread owns one replica for the whole horizon:
// battery charge, the four genset counters and the reward accumulator live
// in registers; per step the thread runs the marginal-cost RBC policy with a
// static deploy order, the genset status machine, battery / grid dispatch and
// the PV + balancing flex phase, and adds the step's reward.
//
// Bound: the serial per-step dependency chain (latency), not bytes.  The
// three series are read at row t by every lane of a warp (one broadcast load
// through L1/L2, no shared-memory staging), and nothing is written until the
// end.  The launch uses 256-thread blocks so that B = 131072 replicas give
// 512 blocks, ~31 resident warps per SM on 132 SMs, to hide that latency.
//
// Built with --fmad=false so that every product rounds before the add, as
// the plain PyTorch version's eager ops do
// (pymgrid_tpu_torch/ops/rbc_rollout.py:plain_rbc_rollout).

#include <cuda_runtime.h>
#include <stdint.h>

enum DeployKind : int32_t { kBattery = 0, kGrid = 1, kGenset = 2 };

// Host-computed constants (pallas_rollout.py:80-121); layout mirrored by the
// ctypes Structure in pymgrid_tpu_torch/ops/rbc_rollout.py.
struct RbcParams {
  float min_cap, max_cap, max_charge, max_discharge, eff, cycle;
  float max_imp, max_exp, cost_co2;
  float loss_cost, over_cost;
  float g_min, g_max, g_cost, g_co2, g_cost_co2;
  int32_t g_start_up, g_wind_down, g_abort, g_init_status, g_goal;
  int32_t has_genset;
  int32_t t0, n_steps;
  int32_t n_order;
  int32_t order[3];
};

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

__global__ void __launch_bounds__(256)
rbc_rollout_kernel(const RbcParams p, const float* __restrict__ load_ts,
                   const float* __restrict__ pv_ts,
                   const float4* __restrict__ grid_ts,
                   const float* __restrict__ init_charge,
                   float* __restrict__ out, int64_t B) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;

  float charge = init_charge[i];
  int gcur = p.g_init_status, ggoal = p.g_init_status;
  int gup = p.g_init_status == 1 ? 0 : p.g_start_up;
  int gdown = p.g_init_status == 1 ? p.g_wind_down : 0;
  float acc = 0.0f;

  const int t_end = p.t0 + p.n_steps;
  for (int t = p.t0; t < t_end; ++t) {
    const float load = -__ldg(load_ts + t);
    const float pv = __ldg(pv_ts + t);
    const float4 g = __ldg(grid_ts + t);  // import, export, co2, status

    // ---- marginal-cost RBC policy, static deploy order ----
    float remaining = load - pv;
    const float max_prod_b = fminf(p.max_discharge, charge - p.min_cap) * p.eff;
    const float max_cons_b = fminf(p.max_charge, p.max_cap - charge) / p.eff;
    const float max_prod_g = p.max_imp * g.w;
    const float max_cons_g = p.max_exp * g.w;

    float a_b = 0.0f, a_g = 0.0f, a_gen = 0.0f;
    float nsf = 0.0f;
    if (p.has_genset) {
      nsf = static_cast<float>(next_status(gcur, gup, gdown, p.g_goal));
    }
    for (int k = 0; k < p.n_order; ++k) {
      const int kind = p.order[k];
      if (kind == kBattery) {
        a_b = deploy(remaining, max_prod_b, max_cons_b);
        remaining = remaining - a_b;
      } else if (kind == kGrid) {
        a_g = deploy(remaining, max_prod_g, max_cons_g);
        remaining = remaining - a_g;
      } else {  // genset: produce only, within the predicted status bounds
        const bool near0 = fabsf(remaining) <= 1e-4f;
        const float produce = fminf(fmaxf(remaining, nsf * p.g_min), nsf * p.g_max);
        a_gen = near0 ? 0.0f : (remaining > 0.0f ? produce : 0.0f);
        remaining = remaining - a_gen;
      }
    }

    // ---- dispatch ----
    float gen_prov = 0.0f, r_gen = 0.0f;
    if (p.has_genset) {
      update_status(gcur, ggoal, gup, gdown, p.g_goal, p.g_start_up,
                    p.g_wind_down, p.g_abort != 0);
      const float statusf = static_cast<float>(gcur);
      const float lo = statusf * p.g_min;
      const float hi = statusf * p.g_max;
      gen_prov = a_gen > hi ? hi : (a_gen < lo ? lo : a_gen);
      r_gen = -(p.g_cost * gen_prov + p.g_cost_co2 * (p.g_co2 * gen_prov));
    }
    const float b_prov = fmaxf(a_b, 0.0f);
    const float b_abs = fmaxf(-a_b, 0.0f);
    const float internal = a_b < 0.0f ? b_abs * p.eff : -b_prov / p.eff;
    const float new_charge = fmaxf(charge + internal, p.min_cap);
    const float r_batt = -fabsf(internal) * p.cycle;

    const float g_prov = fmaxf(a_g, 0.0f);
    const float g_abs = fmaxf(-a_g, 0.0f);
    const float r_grid = -(g.x + p.cost_co2 * g.z) * g_prov + g.y * g_abs;

    const float diff = (gen_prov + b_prov + g_prov) - (load + b_abs + g_abs);
    const float needed = -diff;
    const float pv_used = diff > 0.0f ? 0.0f : fminf(pv, needed);
    const float resid = needed - pv_used;
    const float r_bal =
        diff > 0.0f ? -p.over_cost * diff : -p.loss_cost * fmaxf(resid, 0.0f);

    acc = acc + r_gen + r_batt + r_grid + r_bal;
    charge = new_charge;
  }
  out[i] = acc;
}

// Plain C entry, bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() so a refused launch surfaces in the wrapper.
extern "C" int rbc_rollout_launch(const RbcParams* params, const float* load_ts,
                                  const float* pv_ts, const float* grid_ts,
                                  const float* init_charge, float* out,
                                  long long batch, void* stream) {
  if (batch <= 0) return 0;
  const int threads = 256;
  const long long blocks = (batch + threads - 1) / threads;
  rbc_rollout_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *params, load_ts, pv_ts, reinterpret_cast<const float4*>(grid_ts),
      init_charge, out, static_cast<int64_t>(batch));
  return static_cast<int>(cudaGetLastError());
}
