"""Append-only per-module logger.

Mirrors the behavioral contract of the reference logger
(``src/pymgrid/utils/logger.py:7-51``): keys appearing mid-run are back-filled
with NaN to the current log length, ``flush`` returns-and-clears, and the log
can be materialized as a DataFrame.
"""
import numpy as np

__all__ = ["ModularLogger"]


class ModularLogger:
    def __init__(self, data=None):
        self.data = dict(data) if data else {}
        self._log_length = (
            max((len(v) for v in self.data.values()), default=0) if self.data else 0
        )

    def log(self, **log_dict):
        for key, value in log_dict.items():
            if hasattr(value, "item"):
                value = value.item()
            column = self.data.get(key)
            if column is None:
                column = [np.nan] * self._log_length
                self.data[key] = column
            column.append(value)
        self._log_length += 1

    def flush(self):
        d = self.data.copy()
        self.data.clear()
        self._log_length = 0
        return d

    def to_dict(self):
        return self.data.copy()

    def raw(self):
        return {k: list(map(float, v)) for k, v in self.data.items()}

    def to_frame(self):
        import pandas as pd

        return pd.DataFrame(self.data)

    def serialize(self, key):
        return {key: self.to_frame()} if len(self) > 0 else {}

    @classmethod
    def from_raw(cls, raw):
        if raw is None:
            return cls()
        if isinstance(raw, str):
            import pandas as pd

            raw = pd.read_csv(raw).to_dict()
        if hasattr(raw, "to_dict"):  # DataFrame
            raw = {k: list(v.values()) for k, v in raw.to_dict().items()}
        else:
            raw = {
                k: (list(v.values()) if isinstance(v, dict) else list(v))
                for k, v in raw.items()
            }
        return cls(raw)

    def items(self):
        return self.data.items()

    def keys(self):
        return self.data.keys()

    def values(self):
        return self.data.values()

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    def __contains__(self, key):
        return key in self.data

    def __iter__(self):
        return iter(self.data.items())

    def __len__(self):
        return self._log_length

    def __eq__(self, other):
        if not isinstance(other, ModularLogger):
            return NotImplemented
        if set(self.data) != set(other.data):
            return False
        return all(
            np.allclose(self.data[k], other.data[k], equal_nan=True)
            for k in self.data
        )

    def __repr__(self):
        return f"ModularLogger(keys={list(self.data)}, len={self._log_length})"
