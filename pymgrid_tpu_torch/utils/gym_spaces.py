"""Composite spaces and flattening for the env layer.

Self-contained equivalents of the gym/gymnasium composite spaces the
reference env layer uses (``Dict``, ``Tuple``, ``Discrete``,
``flatten_space``, ``flatten``).  Key ordering matches gym(nasium): ``Dict``
sorts keys alphabetically, which fixes the flattened observation layout.
"""
import numpy as np

from pymgrid_tpu_torch.utils.space import Box

__all__ = ["Discrete", "Tuple", "Dict", "flatten_space", "flatten"]


class Discrete:
    def __init__(self, n, seed=None):
        self.n = int(n)
        self._rng = np.random.RandomState(seed) if seed is not None else None

    def seed(self, seed=None):
        self._rng = np.random.RandomState(seed)

    def sample(self):
        rng = self._rng if self._rng is not None else np.random
        return int(rng.randint(self.n))

    def contains(self, x):
        try:
            return 0 <= int(x) < self.n and float(x) == int(x)
        except (TypeError, ValueError):
            return False

    def __contains__(self, x):
        return self.contains(x)

    def __eq__(self, other):
        return isinstance(other, Discrete) and self.n == other.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Tuple:
    def __init__(self, spaces):
        self.spaces = tuple(spaces)

    def sample(self):
        return tuple(s.sample() for s in self.spaces)

    def contains(self, x):
        return len(x) == len(self.spaces) and all(
            s.contains(v) for s, v in zip(self.spaces, x)
        )

    def __contains__(self, x):
        return self.contains(x)

    def __iter__(self):
        return iter(self.spaces)

    def __len__(self):
        return len(self.spaces)

    def __getitem__(self, i):
        return self.spaces[i]

    def __eq__(self, other):
        return isinstance(other, Tuple) and self.spaces == other.spaces

    def __repr__(self):
        return f"Tuple({self.spaces})"


class Dict:
    """Dict space with gym-compatible alphabetical key ordering."""

    def __init__(self, spaces):
        self.spaces = {k: spaces[k] for k in sorted(spaces)}

    def sample(self):
        return {k: s.sample() for k, s in self.spaces.items()}

    def contains(self, x):
        return set(x) == set(self.spaces) and all(
            self.spaces[k].contains(v) for k, v in x.items()
        )

    def __contains__(self, x):
        return self.contains(x)

    def __getitem__(self, k):
        return self.spaces[k]

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def values(self):
        return self.spaces.values()

    def __eq__(self, other):
        return isinstance(other, Dict) and self.spaces == other.spaces

    def __repr__(self):
        return f"Dict({self.spaces})"


def flatten_space(space):
    """Flatten a composite space into a single Box."""
    if isinstance(space, Box):
        return Box(space.low.reshape(-1), space.high.reshape(-1))
    if isinstance(space, Tuple):
        boxes = [flatten_space(s) for s in space.spaces]
        if not boxes:
            return Box(np.array([]), np.array([]))
        return Box(
            np.concatenate([b.low for b in boxes]),
            np.concatenate([b.high for b in boxes]),
        )
    if isinstance(space, Dict):
        boxes = [flatten_space(s) for s in space.spaces.values()]
        if not boxes:
            return Box(np.array([]), np.array([]))
        return Box(
            np.concatenate([b.low for b in boxes]),
            np.concatenate([b.high for b in boxes]),
        )
    if isinstance(space, Discrete):
        return Box(np.zeros(space.n), np.ones(space.n))
    raise TypeError(f"Cannot flatten space {space}")


def flatten(space, x):
    """Flatten a sample of ``space`` into a 1-D float array."""
    if isinstance(space, Box):
        return np.asarray(x, dtype=np.float64).reshape(-1)
    if isinstance(space, Tuple):
        if not space.spaces:
            return np.array([])
        return np.concatenate(
            [flatten(s, v) for s, v in zip(space.spaces, x)]
        )
    if isinstance(space, Dict):
        if not space.spaces:
            return np.array([])
        return np.concatenate([flatten(s, x[k]) for k, s in space.spaces.items()])
    if isinstance(space, Discrete):
        onehot = np.zeros(space.n)
        onehot[int(x)] = 1.0
        return onehot
    raise TypeError(f"Cannot flatten space {space}")
