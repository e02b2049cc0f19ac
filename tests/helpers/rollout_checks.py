"""Checks shared by the port's rollout tests; imports nothing of JAX, so
the tests run on the card import it too."""
import torch


def assert_same_rollout(got, want):
    """Two rollouts' returns, a checksum or ``(checksum, StepOutput)``,
    equal in every tensor's dtype, shape, strides and bits."""
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    flat = lambda out: [y for x in out for y in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    for a, b in zip(flat(got), flat(want), strict=True):
        assert (a.dtype, a.shape, a.stride()) == (b.dtype, b.shape, b.stride())
        assert torch.equal(a, b)
