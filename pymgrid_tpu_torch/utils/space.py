"""Normalization spaces.

Self-contained replacements for the reference's gym-backed spaces
(reference: ``src/pymgrid/utils/space.py:183-299``).  This framework does not
depend on ``gym``; a minimal :class:`Box` with the API subset the simulator
needs is provided here, and the env layer optionally wraps gymnasium.

Normalization is affine: ``normalized = (val - low) / spread`` with
``spread = high - low`` and zero spreads mapped to one
(reference: ``utils/space.py:204-205``).
"""
import operator
import warnings

import numpy as np

__all__ = ["Box", "ModuleSpace", "MicrogridSpace"]


class Box:
    """Minimal continuous box space (numpy float64 by default).

    API-compatible subset of ``gym.spaces.Box`` used by the simulator:
    ``low``, ``high``, ``shape``, ``dtype``, ``sample``, ``contains``.
    """

    def __init__(self, low, high, shape=None, dtype=np.float64, seed=None):
        low = np.asarray(low, dtype=dtype)
        high = np.asarray(high, dtype=dtype)
        if shape is not None:
            low = np.broadcast_to(low, shape).astype(dtype)
            high = np.broadcast_to(high, shape).astype(dtype)
        if low.shape != high.shape:
            raise ValueError(f"low/high shape mismatch: {low.shape} vs {high.shape}")
        self.low = low
        self.high = high
        self.dtype = np.dtype(dtype)
        self._rng = np.random.RandomState(seed) if seed is not None else None

    @property
    def shape(self):
        return self.low.shape

    def seed(self, seed=None):
        self._rng = np.random.RandomState(seed)

    def sample(self):
        rng = self._rng if self._rng is not None else np.random
        low = np.where(np.isfinite(self.low), self.low, -1e20)
        high = np.where(np.isfinite(self.high), self.high, 1e20)
        return rng.uniform(low=low, high=high, size=self.shape).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low) and np.all(x <= self.high)
        )

    def __contains__(self, x):
        return self.contains(x)

    def __eq__(self, other):
        return (
            isinstance(other, Box)
            and self.shape == other.shape
            and np.array_equal(self.low, other.low)
            and np.array_equal(self.high, other.high)
        )

    def __repr__(self):
        return f"Box({self.low}, {self.high}, {self.shape}, {self.dtype})"


class ModuleSpace:
    """Paired unnormalized/normalized boxes for a single module.

    ``space['normalized']`` is always the unit box of the same shape.
    Out-of-bounds values warn rather than raise
    (reference: ``utils/space.py:233-239``).
    """

    def __init__(self, unnormalized_low, unnormalized_high, shape=None, seed=None):
        low = np.atleast_1d(np.asarray(unnormalized_low, dtype=np.float64))
        high = np.atleast_1d(np.asarray(unnormalized_high, dtype=np.float64))
        if shape is not None:
            low = low.reshape(shape)
            high = high.reshape(shape)

        self._unnormalized = Box(low=low, high=high, seed=seed)
        self._normalized = Box(
            low=np.zeros_like(low), high=np.ones_like(high), seed=seed
        )

        self._spread = high - low
        self._spread = np.where(self._spread == 0, 1.0, self._spread)

    @property
    def unnormalized(self):
        return self._unnormalized

    @property
    def normalized(self):
        return self._normalized

    @property
    def shape(self):
        return self._unnormalized.shape

    @property
    def low(self):
        return self._unnormalized.low

    @property
    def high(self):
        return self._unnormalized.high

    @property
    def spread(self):
        return self._spread

    def __getitem__(self, item):
        if item == "normalized":
            return self._normalized
        if item == "unnormalized":
            return self._unnormalized
        raise KeyError(item)

    def _shape_check(self, val, func_name):
        val = np.asarray(val)
        if val.size not in (self._unnormalized.low.size,) and val.size != 1:
            warnings.warn(
                f"Calling {func_name} on value of shape {val.shape} against "
                f"space of shape {self.shape}."
            )

    def _bounds_check(self, val, low, high):
        arr = np.asarray(val)
        if arr.size == 0:
            return
        in_bounds = np.all((low <= arr) & (arr <= high))
        if not (in_bounds or np.allclose(arr, low) or np.allclose(arr, high)):
            warnings.warn(
                f"Value {val} resides out of expected bounds of value to be "
                f"normalized: [{low}, {high}]."
            )

    def normalize(self, val):
        low, high = self._unnormalized.low, self._unnormalized.high
        self._bounds_check(val, low, high)
        normalized = (val - low) / self._spread
        try:
            return normalized.item()
        except (AttributeError, ValueError):
            return normalized

    def denormalize(self, val):
        low = self._unnormalized.low
        self._bounds_check(val, 0, 1)
        denormalized = low + self._spread * val
        try:
            return denormalized.item()
        except (AttributeError, ValueError):
            return denormalized

    def sample(self):
        return self._unnormalized.sample()

    def seed(self, seed=None):
        self._unnormalized.seed(seed)
        self._normalized.seed(seed)

    def __eq__(self, other):
        if not isinstance(other, ModuleSpace):
            return NotImplemented
        return self._unnormalized == other._unnormalized

    def __repr__(self):
        return f"ModuleSpace(unnormalized={self._unnormalized})"


class MicrogridSpace:
    """Dict-of-lists-of-ModuleSpace over module names.

    The action variant contains only controllable modules; the observation
    variant contains all modules (reference: ``utils/space.py:32-48``).
    """

    def __init__(self, module_space_dict, act_or_obs="obs", seed=None):
        # module_space_dict: {name: [{'action_space': ..., 'module_type': ...}, ...]}
        # or directly {name: [ModuleSpace, ...]}
        self.act_or_obs = act_or_obs
        self._spaces = {}
        for name, entries in module_space_dict.items():
            spaces = []
            for entry in entries:
                if isinstance(entry, ModuleSpace):
                    spaces.append(entry)
                    continue
                space_key = "action_space" if act_or_obs == "act" else "observation_space"
                space = entry.get(space_key)
                if act_or_obs == "act":
                    module_type = entry.get("module_type")
                    if module_type is NotImplemented or module_type is None:
                        continue
                    if module_type[1] != "controllable":
                        continue
                if space is None or space is NotImplemented:
                    continue
                spaces.append(space)
            if spaces:
                self._spaces[name] = spaces

    @property
    def spaces(self):
        return self._spaces

    def __getitem__(self, item):
        if item in ("normalized", "unnormalized"):
            return {
                name: [s[item] for s in spaces] for name, spaces in self._spaces.items()
            }
        return self._spaces[item]

    def items(self):
        return self._spaces.items()

    def keys(self):
        return self._spaces.keys()

    @staticmethod
    def dict_op(first, second, op):
        out = {}
        for k, first_list in first.items():
            second_list = second[k]
            out[k] = [op(f, s) for f, s in zip(first_list, second_list)]
        return out

    def normalize(self, val):
        return {
            name: [space.normalize(v) for space, v in zip(spaces, val[name])]
            for name, spaces in self._spaces.items()
            if name in val
        }

    def denormalize(self, val):
        return {
            name: [space.denormalize(v) for space, v in zip(spaces, val[name])]
            for name, spaces in self._spaces.items()
            if name in val
        }

    def sample(self):
        return {
            name: [space.sample() for space in spaces]
            for name, spaces in self._spaces.items()
        }

    def __eq__(self, other):
        if not isinstance(other, MicrogridSpace):
            return NotImplemented
        if set(self._spaces) != set(other._spaces):
            return False
        return all(
            a == b
            for name in self._spaces
            for a, b in zip(self._spaces[name], other._spaces[name])
        )

    def __repr__(self):
        return f"MicrogridSpace({self._spaces})"
