"""Carrying the engine's params and states across to torch.

``params_to_torch`` turns the nested numpy dict of
:func:`pymgrid_tpu_torch.core.spec.extract_spec` (or a config-stacked suite dict)
into tensors on one device: float leaves take ``dtype``, integer leaves become
int64 and bool leaves stay bool.  Every parameter then is a tensor on the
operand's device, which keeps CUDA from rewriting a division by it into a
multiplication by its reciprocal.

The engine of the port works on a leading config axis: every params leaf is
``(C, ...)`` and every state leaf ``(C, B, ...)`` (configs x replicas).
:func:`with_config_axis` lifts one config's params to ``C = 1``.
"""
import numpy as np
import torch

from pymgrid_tpu_torch._device import resolve_device, torch_dtype

__all__ = [
    "params_to_torch",
    "state_to_torch",
    "with_config_axis",
    "without_config_axis",
    "stack_configs",
    "tree_map",
]


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaf_to_torch(x, device, dtype, int_dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.dtype == np.bool_:
        target = torch.bool
    elif np.issubdtype(arr.dtype, np.integer):
        target = int_dtype
    elif np.issubdtype(arr.dtype, np.floating):
        target = dtype
    else:
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return torch.as_tensor(np.array(arr, order="C"), device=device).to(target)


def params_to_torch(params, device, dtype):
    """Nested numpy params -> the same nested dict of tensors on ``device``."""
    device, dtype = resolve_device(device), torch_dtype(dtype)
    return tree_map(lambda x: _leaf_to_torch(x, device, dtype, torch.int64), params)


def state_to_torch(state, device, dtype):
    """An engine state (numpy leaves, e.g. a JAX state fetched with
    ``np.asarray``) -> tensors.  Integer leaves (step, genset counters)
    become int32 as in the engine; the ``rng`` key has no use here and is
    dropped.  A JAX batched env's state (``(B, ...)`` leaves plus ``rng``)
    thus becomes the port env's state, which continues it bitwise."""
    device, dtype = resolve_device(device), torch_dtype(dtype)
    state = {k: v for k, v in state.items() if k != "rng"}
    return tree_map(lambda x: _leaf_to_torch(x, device, dtype, torch.int32), state)


def with_config_axis(params):
    """One config's params (or states) -> ``C = 1`` config-stacked ones."""
    return tree_map(lambda x: x.unsqueeze(0), params)


def without_config_axis(tree):
    """Drop the leading ``C = 1`` config axis again."""
    return tree_map(lambda x: x[0], tree)


def stack_configs(params_list):
    """Stack per-config numpy params along a new leading config axis."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_configs([p[k] for p in params_list]) for k in first}
    return np.stack([np.asarray(p) for p in params_list])
