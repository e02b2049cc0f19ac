"""Fused-horizon RBC rollout: the hand-written CUDA kernel and its plain twin.

``make_rbc_rollout(spec, params, n_steps, device="cuda")`` builds
``rollout(init_charge (B,) f32) -> cumulative reward (B,) f32``: a whole
``n_steps`` horizon of the marginal-cost rule-based controller per replica,
for one config, every replica starting at ``params["initial_step"]`` from its
own battery charge (an init-charge sweep).

* Replaces ``pymgrid_tpu/ops/pallas_rollout.py:make_pallas_rbc_rollout`` (same
  contract and arithmetic; :func:`supported_spec` is copied from there).  The
  kernel is ``pymgrid_tpu_torch/csrc/rbc_rollout.cu``, CUDA C++ for
  ``sm_90a``: each thread steps a few replicas through the horizon with their
  state in registers.
* What bounds it on the H100: operations on a serial per-replica chain, not
  bytes (one 32-byte row per step is shared by every replica, and nothing is
  written until the end).  The design fixes the deploy order and the module
  set at compile time (8 template variants, picked here by a variant code),
  brings the rows into shared memory one chunk ahead with a bulk copy and
  computes each row's replica-independent terms once per block, and
  interleaves two independent replicas per thread (one with the genset) to
  hide the chain's latency.
* The deploy order and every module constant are fixed on the host from the
  ``t0`` prices, exactly as the Pallas kernel fixes them, and travel to the
  kernel in one small struct.

The wrapper takes the plain PyTorch version (:func:`plain_rbc_rollout`, a
Python loop over t of ``(B,)`` tensor ops) only for a tensor on the CPU; a
CUDA tensor launches the kernel, or the call raises.
"""
import ctypes

import numpy as np
import torch

from pymgrid_tpu_torch._device import resolve_device
from pymgrid_tpu_torch.core import physics, xp

__all__ = [
    "make_rbc_rollout",
    "plain_rbc_rollout",
    "supported_spec",
    "variant_code",
    "RbcRollout",
    "VARIANTS",
]

# code -> deploy order; the switch in csrc/rbc_rollout.cu:rbc_rollout_launch
# compiles one kernel for each
VARIANTS = (
    ("battery", "grid", "genset"),
    ("battery", "genset", "grid"),
    ("grid", "battery", "genset"),
    ("grid", "genset", "battery"),
    ("genset", "battery", "grid"),
    ("genset", "grid", "battery"),
    ("battery", "grid"),
    ("grid", "battery"),
)

_FLOAT_FIELDS = (
    "min_cap", "max_cap", "max_charge", "max_discharge", "eff", "cycle",
    "max_imp", "max_exp", "cost_co2", "loss_cost", "over_cost",
    "g_min", "g_max", "g_cost", "g_co2", "g_cost_co2",
)
_INT_FIELDS = (
    "g_start_up", "g_wind_down", "g_abort", "g_init_status", "g_goal",
    "t0", "n_steps",
)
_ERRORS = {-1: "unknown variant code", -2: "series rows not 16-byte aligned"}

# Operations of one replica-step of the plain version, counted from
# plain_rbc_rollout: each add, subtract, multiply, divide, min, max, compare,
# select, logical op and int/float conversion counts one; negation and
# absolute value are free.  Without the genset: battery bounds 6, two deploys
# 14, battery dispatch 9, grid 5, balancing 14, accumulation 4.  The genset
# adds 87 (next-status predictor 11, deploy 9, status machine 56, status
# bounds and clip 7, cost 4).  A row's replica-independent terms take 5.  The
# kernel's bound is their sum over a call at the card's float32 peak
# (RbcRollout.bound_ms).
OPS_PER_REPLICA_STEP = {False: 52, True: 139}
OPS_PER_ROW = 5


def supported_spec(spec):
    """Covers the load+pv+battery[+genset][+grid]+balancing families —
    every pymgrid25 shape (the genset machine runs branchless per lane;
    grid-less configs get a zero-capacity neutral grid slot whose deploys
    and rewards are exactly 0)."""
    return (
        spec.n_load == 1
        and spec.n_renewable == 1
        and spec.n_battery == 1
        and spec.n_grid <= 1
        and spec.n_genset <= 1
        and spec.n_balancing == 1
        and all(m.custom_fn is None for m in spec.modules)
    )


def variant_code(order):
    """The kernel variant of a deploy order (raises on an order no variant
    compiles)."""
    try:
        return VARIANTS.index(tuple(order))
    except ValueError:
        raise ValueError(f"no kernel variant for deploy order {order}") from None


class RbcParams(ctypes.Structure):
    """Mirror of ``struct RbcParams`` in ``csrc/rbc_rollout.cu``."""

    _fields_ = (
        [(name, ctypes.c_float) for name in _FLOAT_FIELDS]
        + [(name, ctypes.c_int32) for name in _INT_FIELDS]
    )


def _host_constants(spec, params, n_steps):
    """Series and constants as ``pallas_rollout.py:68-121`` fixes them."""
    load_ts = np.asarray(params["load"]["ts"][0], np.float32)[:, 0]
    pv_ts = np.asarray(params["renewable"]["ts"][0], np.float32)[:, 0]
    has_grid = spec.n_grid == 1
    if has_grid:
        grid_ts = np.asarray(params["grid"]["ts"][0], np.float32)
    else:
        # neutral zero-capacity grid slot (parallel/suite.py semantics)
        grid_ts = np.zeros((load_ts.shape[0], 4), np.float32)
        grid_ts[:, 3] = 1.0

    f = lambda x: float(np.float32(x))
    pb = params["battery"]
    c = {
        "min_cap": f(pb["min_capacity"][0]),
        "max_cap": f(pb["max_capacity"][0]),
        "max_charge": f(pb["max_charge"][0]),
        "max_discharge": f(pb["max_discharge"][0]),
        "eff": f(pb["efficiency"][0]),
        "cycle": f(pb["battery_cost_cycle"][0]),
        "loss_cost": f(params["balancing"]["loss_load_cost"][0]),
        "over_cost": f(params["balancing"]["overgeneration_cost"][0]),
        "max_imp": 0.0, "max_exp": 0.0, "cost_co2": 0.0,
        "g_min": 0.0, "g_max": 0.0, "g_cost": 0.0, "g_co2": 0.0, "g_cost_co2": 0.0,
        "g_start_up": 0, "g_wind_down": 0, "g_abort": 0, "g_init_status": 0,
        "g_goal": 0,
        "has_genset": int(spec.n_genset == 1),
        "t0": int(params["initial_step"]),
        "n_steps": int(n_steps),
    }
    if has_grid:
        pg = params["grid"]
        c.update(max_imp=f(pg["max_import"][0]), max_exp=f(pg["max_export"][0]),
                 cost_co2=f(pg["cost_per_unit_co2"][0]))
    if c["has_genset"]:
        pg = params["genset"]
        c.update(
            g_min=f(pg["running_min_production"][0]),
            g_max=f(pg["running_max_production"][0]),
            g_cost=f(pg["genset_cost"][0]),
            g_co2=f(pg["co2_per_unit"][0]),
            g_cost_co2=f(pg["cost_per_unit_co2"][0]),
            g_start_up=int(pg["start_up_time"][0]),
            g_wind_down=int(pg["wind_down_time"][0]),
            g_abort=int(bool(pg["allow_abortion"][0])),
            g_init_status=int(pg["init_status"][0]),
        )
        # reference dedupe keeps the genset-ON element only when
        # running_min_production == 0 (priority_list.py:40-67)
        c["g_goal"] = 1 if c["g_min"] == 0 else 0

    # static marginal-cost deployment order (rbc.py:31-44 semantics)
    costs = []
    if c["has_genset"]:
        costs.append(("genset", c["g_cost"] + c["g_cost_co2"] * c["g_co2"]))
    costs.append(("battery", c["cycle"]))
    costs.append(("grid", float(grid_ts[c["t0"], 0])))
    order = [k for k, _ in sorted(costs, key=lambda kv: kv[1])]
    return load_ts, pv_ts, grid_ts, c, order


def plain_rbc_rollout(series, c, order, init_charge):
    """The plain PyTorch version: a Python loop over t of ``(B,)`` tensor
    ops, the same arithmetic as the kernel.  Constants are 0-dim tensors on
    ``init_charge``'s device (a division by a Python float would become a
    multiplication by its reciprocal on CUDA)."""
    f32, i32 = torch.float32, torch.int32
    dev = init_charge.device
    k = {name: torch.tensor(c[name], dtype=f32, device=dev) for name in _FLOAT_FIELDS}
    load_ts, pv_ts, grid_ts = (s.to(dev) for s in series)
    neg_load = -load_ts
    zero = torch.zeros((), dtype=f32, device=dev)
    B = init_charge.shape[0]

    has_genset = bool(c["has_genset"])
    goal = torch.tensor(c["g_goal"], dtype=i32, device=dev)
    sut = torch.tensor(c["g_start_up"], dtype=i32, device=dev)
    wdt = torch.tensor(c["g_wind_down"], dtype=i32, device=dev)
    abort = torch.tensor(bool(c["g_abort"]), device=dev)
    init_status = c["g_init_status"]
    gcur = torch.full((B,), init_status, dtype=i32, device=dev)
    ggoal = gcur.clone()
    gup = torch.full((B,), 0 if init_status == 1 else c["g_start_up"], dtype=i32,
                     device=dev)
    gdown = torch.full((B,), c["g_wind_down"] if init_status == 1 else 0, dtype=i32,
                       device=dev)

    def deploy(remaining, max_p, max_c):
        near0 = remaining.abs() <= 1e-4
        produce = torch.minimum(remaining, max_p)
        consume = torch.maximum(remaining, -max_c)
        return torch.where(near0, 0.0, torch.where(remaining > 0, produce, consume))

    charge = init_charge.clone()
    acc = torch.zeros(B, dtype=f32, device=dev)
    for t in range(c["t0"], c["t0"] + c["n_steps"]):
        load, pv = neg_load[t], pv_ts[t]
        price_imp, price_exp, co2k, status = grid_ts[t].unbind()

        remaining = load - pv
        max_prod_b = torch.minimum(k["max_discharge"], charge - k["min_cap"]) * k["eff"]
        max_cons_b = torch.minimum(k["max_charge"], k["max_cap"] - charge) / k["eff"]
        max_prod_g = k["max_imp"] * status
        max_cons_g = k["max_exp"] * status

        a_b = a_g = a_gen = zero
        if has_genset:
            nsf = physics.genset_next_status(gcur, gup, gdown, goal, xp=xp).to(f32)
        for kind in order:
            if kind == "battery":
                a_b = deploy(remaining, max_prod_b, max_cons_b)
                remaining = remaining - a_b
            elif kind == "grid":
                a_g = deploy(remaining, max_prod_g, max_cons_g)
                remaining = remaining - a_g
            else:  # genset: produce only, within the predicted status bounds
                near0 = remaining.abs() <= 1e-4
                produce = torch.clamp(remaining, nsf * k["g_min"], nsf * k["g_max"])
                a_gen = torch.where(near0, 0.0, torch.where(remaining > 0, produce, 0.0))
                remaining = remaining - a_gen

        gen_prov = r_gen = zero
        if has_genset:
            gcur, ggoal, gup, gdown = physics.genset_update_status(
                gcur, ggoal, gup, gdown, goal, sut, wdt, abort, xp=xp
            )
            statusf = gcur.to(f32)
            gen_prov = physics.clip_source(
                a_gen, statusf * k["g_min"], statusf * k["g_max"], xp=xp
            )
            r_gen = -(k["g_cost"] * gen_prov + k["g_cost_co2"] * (k["g_co2"] * gen_prov))
        b_prov = torch.maximum(a_b, zero)
        b_abs = torch.maximum(-a_b, zero)
        internal = torch.where(a_b < 0, b_abs * k["eff"], -b_prov / k["eff"])
        new_charge = torch.maximum(charge + internal, k["min_cap"])
        r_batt = -internal.abs() * k["cycle"]
        g_prov = torch.maximum(a_g, zero)
        g_abs = torch.maximum(-a_g, zero)
        r_grid = -(price_imp + k["cost_co2"] * co2k) * g_prov + price_exp * g_abs
        diff = (gen_prov + b_prov + g_prov) - (load + b_abs + g_abs)
        needed = -diff
        pv_used = torch.where(diff > 0, 0.0, torch.minimum(pv, needed))
        resid = needed - pv_used
        r_bal = torch.where(diff > 0, -k["over_cost"] * diff,
                            -k["loss_cost"] * torch.maximum(resid, zero))
        acc = acc + r_gen + r_batt + r_grid + r_bal
        charge = new_charge
    return acc


def _rows(load_ts, pv_ts, grid_ts):
    """The kernel's input: ``(T, 8)`` float32 rows ``(load, pv, price_imp,
    price_exp, co2, status, 0, 0)``, 32 bytes each."""
    rows = np.zeros((load_ts.shape[0], 8), np.float32)
    rows[:, 0], rows[:, 1], rows[:, 2:6] = load_ts, pv_ts, grid_ts
    return rows


def _bind(lib):
    fn = lib.rbc_rollout_launch
    fn.argtypes = [ctypes.POINTER(RbcParams), ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


class RbcRollout:
    """``rollout(init_charge) -> cumulative reward`` for one config.

    ``launches`` counts kernel launches (plain-version calls do not count).
    ``defines`` are ``-D`` flags for the kernel's build (its launch
    configuration: ``RBC_THREADS``, ``RBC_REPLICAS``,
    ``RBC_GENSET_REPLICAS``).
    """

    def __init__(self, spec, params, n_steps, device="cuda", defines=()):
        if not supported_spec(spec):
            raise NotImplementedError(
                "rbc rollout supports the load+pv+battery[+genset][+grid]"
                "+balancing families"
            )
        self.device = resolve_device(device)
        load_ts, pv_ts, grid_ts, self.constants, self.order = _host_constants(
            spec, params, n_steps
        )
        self.variant = variant_code(self.order)
        T = load_ts.shape[0]
        if self.constants["t0"] + n_steps > T:
            raise ValueError(f"initial_step + n_steps exceeds the {T} series rows")
        self.rows = torch.as_tensor(_rows(load_ts, pv_ts, grid_ts), device=self.device)
        self.series = (self.rows[:, 0], self.rows[:, 1], self.rows[:, 2:6])
        self.n_steps = n_steps
        self.defines = tuple(defines)
        self.launches = 0
        self._cparams = RbcParams(**{k: self.constants[k] for k in _FLOAT_FIELDS + _INT_FIELDS})

    def _check(self, init_charge):
        if not isinstance(init_charge, torch.Tensor):
            raise TypeError("init_charge must be a torch tensor")
        if init_charge.dtype != torch.float32 or init_charge.dim() != 1:
            raise ValueError(
                f"init_charge must be a 1-D float32 tensor, got "
                f"{tuple(init_charge.shape)} {init_charge.dtype}"
            )
        if not init_charge.is_contiguous():
            raise ValueError("init_charge must be contiguous")
        if init_charge.device != self.rows.device:
            raise ValueError(
                f"init_charge is on {init_charge.device}, the rollout's series "
                f"on {self.rows.device}"
            )

    def plain(self, init_charge):
        """The plain PyTorch version on ``init_charge``'s device."""
        self._check(init_charge)
        return plain_rbc_rollout(self.series, self.constants, self.order, init_charge)

    def bound_ms(self, batch):
        """The least time an H100 could take for one call on ``batch``
        replicas: the larger of the bytes (the rows read, init_charge and
        the output) at 3.35 TB/s and the operations
        (:data:`OPS_PER_REPLICA_STEP`, :data:`OPS_PER_ROW`) at the float32
        peak of 67 TFLOP/s; bound by operations at the main path's shapes."""
        n = self.n_steps
        nbytes = n * self.rows.shape[1] * 4 + 2 * batch * 4
        ops = (batch * n * OPS_PER_REPLICA_STEP[bool(self.constants["has_genset"])]
               + n * OPS_PER_ROW)
        return max(nbytes / 3.35e12, ops / 67e12) * 1e3

    def __call__(self, init_charge):
        self._check(init_charge)
        if init_charge.device.type == "cpu":
            return self.plain(init_charge)
        if init_charge.device.type != "cuda":
            raise ValueError(f"unsupported device {init_charge.device}")
        from pymgrid_tpu_torch.ops._build import load_library

        launch = _bind(load_library("rbc_rollout", self.defines))
        out = torch.empty_like(init_charge)
        stream = torch.cuda.current_stream(init_charge.device).cuda_stream
        rc = launch(ctypes.byref(self._cparams), self.variant, self.rows.data_ptr(),
                    init_charge.data_ptr(), out.data_ptr(), init_charge.shape[0], stream)
        if rc != 0:
            raise RuntimeError(
                f"rbc_rollout kernel launch failed: {_ERRORS.get(rc, f'CUDA error {rc}')}"
            )
        self.launches += 1
        return out


def make_rbc_rollout(spec, params, n_steps, device="cuda", defines=()):
    """Build the fused-horizon RBC rollout for one config (numpy ``params``
    from :func:`~pymgrid_tpu_torch.core.spec.extract_spec`) with its series
    on ``device``."""
    return RbcRollout(spec, params, n_steps, device, defines)
