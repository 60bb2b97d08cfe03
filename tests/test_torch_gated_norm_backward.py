"""K11's gate variant (the backward of K8's gate: Mamba2's gated norm
rmsnorm(y * silu(z)) * w) against the JAX package's gradients, on the
CPU, and (``cuda`` lane) against its plain version on the card.

``gated_rmsnorm_backward_ref`` (the closed form: du as the plain
variant's dx of u = y silu(z), dy = du silu(z), dz = du y silu'(z), dw as
the plain variant's) is held to ``torch.autograd`` of the plain forward
``gated_rmsnorm_ref`` and to ``jax.grad`` of the JAX package's
composition (``repro.models.ssm.ssm_block``'s: ``rmsnorm_ref`` of
``y.astype(z.dtype) * silu(z).astype(z.dtype)``), and
``ops.gated_rmsnorm`` under autograd (the ``torch.autograd.Function``
whose forward is K8's gate and backward K11's gate; plain versions on CPU
tensors), z a column slice of a wider projection as in the model.  fp32
within rtol = atol = 2e-4 (``tests/test_kernels.py``).  On the card the
gate variant is held to the plain version at zamba2's and mamba2's
training rows, fp32 within 2e-4 (bf16 within 3e-2), bit-identical
twice."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ops as T
from repro_torch.kernels.rmsnorm.ref import (gated_rmsnorm_backward_ref,
                                             gated_rmsnorm_ref)

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

FP32 = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(16, 64), (2, 9, 100), (3, 5, 256), (7, 36)]


@functools.lru_cache(maxsize=None)
def _inputs(shape, seed=0):
    """y, a projection whose columns 3 .. 3 + D are z, w and the output's
    gradient."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    f = np.float32
    y = (rng.standard_normal(shape) * 2).astype(f)
    proj = (rng.standard_normal((*shape[:-1], d + 11)) * 2).astype(f)
    w = (1 + 0.5 * rng.standard_normal(d)).astype(f)
    dout = rng.standard_normal(shape).astype(f)
    return y, proj, w, dout


def _z(proj):
    return proj[..., 3:proj.shape[-1] - 8]


@functools.lru_cache(maxsize=None)
def _jax_grads(shape):
    y, proj, w, dout = _inputs(shape)

    def obj(y_, z_, w_):
        u = y_.astype(z_.dtype) * jax.nn.silu(
            z_.astype(jnp.float32)).astype(z_.dtype)
        return jnp.sum(j_rmsnorm(u, w_) * dout)
    return [np.asarray(g) for g in jax.jit(jax.grad(obj, argnums=(0, 1, 2)))(
        y, np.ascontiguousarray(_z(proj)), w)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gate_backward_ref_matches_autograd(shape):
    y, proj, w, dout = (torch.from_numpy(a) for a in _inputs(shape))
    yy = y.clone().requires_grad_()
    zz = _z(proj).clone().requires_grad_()
    ww = w.clone().requires_grad_()
    want = torch.autograd.grad((gated_rmsnorm_ref(yy, zz, ww) * dout).sum(),
                               (yy, zz, ww))
    got = gated_rmsnorm_backward_ref(y, _z(proj), w, dout)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), **FP32)


@pytest.mark.skipif(jax is None, reason="needs JAX")
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gate_backward_ref_matches_jax_grad(shape):
    y, proj, w, dout = (torch.from_numpy(a) for a in _inputs(shape))
    got = gated_rmsnorm_backward_ref(y, _z(proj), w, dout)
    for g, wnt in zip(got, _jax_grads(shape)):
        np.testing.assert_allclose(g.numpy(), wnt, **FP32)


@pytest.mark.skipif(jax is None, reason="needs JAX")
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gate_function_matches_jax_grad(shape):
    """``ops.gated_rmsnorm`` under autograd: K8's gate forward and K11's
    gate backward (plain versions here), z read at the projection's row
    stride."""
    y, proj, w, dout = (torch.from_numpy(a) for a in _inputs(shape))
    y.requires_grad_()
    proj.requires_grad_()
    w.requires_grad_()
    before = dict(RK.rmsnorm_backward.variants)
    calls = []
    fn = T.rmsnorm_backward_gate

    def count(*a, **k):
        calls.append(True)
        return fn(*a, **k)
    T.rmsnorm_backward_gate = count
    try:
        out = T.gated_rmsnorm(y, _z(proj), w)
        (out * dout).sum().backward()
    finally:
        T.rmsnorm_backward_gate = fn
    assert calls == [True] and RK.rmsnorm_backward.variants == before
    jy, jz, jw = _jax_grads(shape)
    np.testing.assert_allclose(y.grad.numpy(), jy, **FP32)
    np.testing.assert_allclose(_z(proj.grad).numpy(), jz, **FP32)
    assert float(proj.grad[..., :3].abs().max()) == 0.0
    np.testing.assert_allclose(w.grad.numpy(), jw, **FP32)


def test_gate_wrapper_names_the_differentiable_entry_point():
    y = torch.randn(4, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ops.gated_rmsnorm"):
        RK.rmsnorm_2d(y, torch.ones(16), gate=torch.randn(4, 16))
    with pytest.raises(NotImplementedError, match="K11"):
        RK.rmsnorm_backward_gate(y, torch.randn(4, 16), torch.ones(16),
                                 torch.randn(4, 16))


# ---------------------------------------------------------------------------
# cuda lane: K11's gate variant against its plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,width,zd,wd", [
    (2048, 5120, 10448, torch.float32, torch.float32),    # zamba2 training
    (2048, 1536, 3352, torch.float32, torch.float32),     # mamba2-130m
    (300, 1000, 2011, torch.float32, torch.float32),      # scalar path
    (64, 2048, 4200, torch.bfloat16, torch.float32),
    (5, 100, 213, torch.bfloat16, torch.bfloat16)], ids=str)
def test_cuda_gate_backward_matches_plain(cuda, rows, d, width, zd, wd):
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    y = 2 * torch.randn(rows, d, generator=g, device=cuda)
    proj = (2 * torch.randn(rows, width, generator=g, device=cuda)).to(zd)
    z = proj[:, d:2 * d]
    w = (1 + 0.5 * torch.randn(d, generator=g, device=cuda)).to(wd)
    dout = torch.randn(rows, d, generator=g, device=cuda).to(zd)
    before = RK.rmsnorm_backward.variants.get("gate", 0)
    got = RK.rmsnorm_backward_gate(y, z, w, dout)
    again = RK.rmsnorm_backward_gate(y, z, w, dout)
    assert RK.rmsnorm_backward.variants["gate"] == before + 2
    want = gated_rmsnorm_backward_ref(y, z, w, dout)
    for name, a, b, c in zip(("dy", "dz", "dw"), got, again, want):
        assert torch.equal(a, b), name
        tol = 2e-4 if a.dtype == torch.float32 else 3e-2
        scale = max(float(c.float().abs().max()), 1.0)
        assert float((a.float() - c.float()).abs().max()) <= tol * scale, name
