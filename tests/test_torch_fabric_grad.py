"""Gradients through the port's crossbar data planes against the JAX
package's backward oracles, on the CPU.

- ``cuda_kernel`` data plane (``kernels/crossbar_dispatch/ops.py``: the
  autograd Functions around the scatter and combine kernels, whose CPU path
  is the kernels' plain versions) against ``ref.dispatch_bwd_ref`` and
  ``ref.combine_bwd_ref``;
- ``reference`` data plane (``core/arbiter.py``'s ``dispatch_at`` and
  ``combine_at`` under PyTorch's autograd) against
  ``arbiter.dispatch_at_bwd_ref`` and ``arbiter.combine_at_bwd_ref``.

Plans come from seeded registers with isolation holes, quotas and a reset
port over packets with ``dst = -1`` padding and out-of-range ports, so
packets are dropped every way.  ``d_x`` and ``d_y`` are pure row moves
(one product per row for ``d_y``) and are bit-equal; dropped packets get
exactly zero.  ``d_w`` is a row dot summed in another order: within 1e-5
relative to its largest value.  The port's own copies of the oracles are
bit-equal to JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_packets, np_registers, torch_registers
from repro.core import arbiter as jarb
from repro.kernels.crossbar_dispatch import ref as jref
from repro_torch.core import arbiter as tarb
from repro_torch.fabric.backends import ReferenceBackend, get_backend
from repro_torch.kernels.crossbar_dispatch import ref as tref

T, S, C, D = 96, 4, 16, 32
W_REL = 1e-5


def _plan(seed):
    rng = np.random.default_rng(seed)
    regs = torch_registers(np_registers(rng, S, capacity=C))
    dst, src = np_packets(rng, T, S)
    plan = ReferenceBackend().plan(torch.from_numpy(dst),
                                   torch.from_numpy(src), regs)
    assert 0 < int(plan.keep.sum()) < T           # some packets dropped
    return rng, regs, plan


def _np(t):
    return t.detach().float().numpy()


def _route(plan):
    return (jnp.asarray(plan.dst.numpy()), jnp.asarray(plan.keep.numpy()),
            jnp.asarray(plan.slot.numpy()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_plane_dispatch_grad_is_the_oracle_gather(seed, dtype):
    rng, regs, plan = _plan(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)
                         ).to(dtype).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((S, C, D)).astype(np.float32)
                         ).to(dtype)
    slabs = get_backend("cuda_kernel").dispatch(x, plan, regs, C)
    assert type(slabs.grad_fn).__name__ == "_DispatchCoreBackward"
    (d_x,) = torch.autograd.grad(slabs, x, g)
    want = jref.dispatch_bwd_ref(jnp.asarray(_np(g)), *_route(plan), S, C)
    assert np.array_equal(_np(d_x), np.asarray(want))
    assert not d_x[~plan.keep].any()              # drops: exactly zero
    port = tref.dispatch_bwd_ref(g.float(), plan.dst, plan.keep, plan.slot,
                                 S, C)
    assert np.array_equal(port.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_plane_combine_grads_match_the_oracle(seed):
    rng, regs, plan = _plan(seed)
    y = torch.from_numpy(rng.standard_normal((S, C, D)).astype(np.float32)
                         ).requires_grad_()
    w = torch.from_numpy(rng.random(T).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    out = get_backend("cuda_kernel").combine(y, plan, w)
    assert type(out.grad_fn).__name__ == "_CombineCoreBackward"
    d_y, d_w = torch.autograd.grad(out, (y, w), g)
    want_y, want_w = jref.combine_bwd_ref(
        jnp.asarray(g.numpy()), jnp.asarray(_np(y)), *_route(plan),
        jnp.asarray(_np(w)))
    assert np.array_equal(d_y.numpy(), np.asarray(want_y))
    want_w = np.asarray(want_w)
    np.testing.assert_allclose(d_w.numpy(), want_w,
                               atol=W_REL * np.abs(want_w).max(), rtol=0)
    assert not d_w[~plan.keep].any()
    port_y, port_w = tref.combine_bwd_ref(g, y.detach(), plan.dst, plan.keep,
                                          plan.slot, w.detach())
    assert np.array_equal(port_y.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(port_w.numpy(), want_w,
                               atol=W_REL * np.abs(want_w).max(), rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_plane_grads_match_the_at_oracles(seed):
    rng, regs, plan = _plan(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)
                         ).requires_grad_()
    y = torch.from_numpy(rng.standard_normal((S, C, D)).astype(np.float32)
                         ).requires_grad_()
    w = torch.from_numpy(rng.random(T).astype(np.float32)).requires_grad_()
    gs = torch.from_numpy(rng.standard_normal((S, C, D)).astype(np.float32))
    gp = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    be = get_backend("reference")
    (d_x,) = torch.autograd.grad(be.dispatch(x, plan, regs, C), x, gs)
    d_y, d_w = torch.autograd.grad(be.combine(y, plan, w), (y, w), gp)

    daddr = tarb.flat_slot_addr(plan, S, C)
    caddr, cmask = tarb.combine_addr(plan, S, C)
    want_x = jarb.dispatch_at_bwd_ref(jnp.asarray(gs.numpy()),
                                      jnp.asarray(daddr.numpy()), S, C)
    want_y, want_w = jarb.combine_at_bwd_ref(
        jnp.asarray(gp.numpy()), jnp.asarray(_np(y)),
        jnp.asarray(caddr.numpy()), jnp.asarray(cmask.numpy()),
        jnp.asarray(_np(w)))
    assert np.array_equal(d_x.numpy(), np.asarray(want_x))
    assert not d_x[~plan.keep].any()
    assert np.array_equal(d_y.numpy(), np.asarray(want_y))
    want_w = np.asarray(want_w)
    np.testing.assert_allclose(d_w.numpy(), want_w,
                               atol=W_REL * np.abs(want_w).max(), rtol=0)
    assert not d_w[~plan.keep].any()

    port_x = tarb.dispatch_at_bwd_ref(gs, daddr, S, C)
    port_y, port_w = tarb.combine_at_bwd_ref(gp, y.detach(), caddr, cmask,
                                             w.detach())
    assert np.array_equal(port_x.numpy(), np.asarray(want_x))
    assert np.array_equal(port_y.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(port_w.numpy(), want_w,
                               atol=W_REL * np.abs(want_w).max(), rtol=0)
