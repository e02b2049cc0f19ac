"""Ray compatibility decorator (reference ``src/pymgrid/utils/ray.py``).

Ray can hand back read-only arrays after ``ray.get``; when a wrapped call
trips over one, re-run it on shallow copies of every argument.
"""
import functools
from copy import copy

__all__ = ["ray_decorator"]

_READONLY_MARKER = "assignment destination is read-only"


def _retry_on_copies(func, args, kwargs):
    copied_args = [copy(a) for a in args]
    copied_kwargs = {k: copy(v) for k, v in kwargs.items()}
    return func(*copied_args, **copied_kwargs)


def ray_decorator(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except ValueError as e:
            if _READONLY_MARKER not in e.args[0]:
                raise
            return _retry_on_copies(func, args, kwargs)

    return wrapper
