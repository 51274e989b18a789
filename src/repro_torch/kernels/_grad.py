"""The float kernels' gradient: recompute through the plain version.

The reference wraps each Pallas forward in ``jax.custom_vjp`` whose
backward recomputes the jnp reference from the saved inputs and returns
its VJP (``kernels/{flash_attention,mamba2_ssd,rwkv6_wkv}/ops.py``); no
backward kernel exists.  :func:`plain_vjp` is that backward for a
``torch.autograd.Function``: the forward has launched the kernel (or, on
the CPU, run the plain version without a graph), and the backward builds
the plain version's graph for this one call, takes its gradient and frees
it.

Where no data exists, on the fake tensors of ``FakeTensorMode`` (the dry
run's steps), :func:`shapes_only` says so: the WKV and SSD wrappers then
give their outputs' shapes and dtypes without running a scan, and
:func:`plain_vjp` gives its gradients' so.  (A ``meta`` tensor is refused
by the wrappers, as any device without a kernel.)
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def shapes_only(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data: a fake tensor."""
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def plain_vjp(plain: Callable[..., torch.Tensor],
              saved: Sequence[torch.Tensor], needs: Sequence[bool],
              grad_out: torch.Tensor, **kw
              ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of ``plain(*saved, **kw)`` with respect to each saved
    input whose ``needs`` entry is set (``None`` for the others), against
    the upstream gradient ``grad_out``.  On a ``grad_out`` that holds no
    data (:func:`shapes_only`) the gradients are empty tensors of the
    inputs' shapes and dtypes, and ``plain`` does not run."""
    if shapes_only(grad_out):
        return tuple(t.new_empty(t.shape) if n else None
                     for t, n in zip(saved, needs))
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n))
               for t, n in zip(saved, needs)]
        wanted = [t for t in ins if t.requires_grad]
        out = plain(*ins, **kw)
        grads = iter(torch.autograd.grad(out, wanted, grad_out,
                                         materialize_grads=True))
    return tuple(next(grads) if t.requires_grad else None for t in ins)
