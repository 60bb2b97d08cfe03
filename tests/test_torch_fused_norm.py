"""The port's fused RMSNorm forms against the JAX package's composition.

K8 has two prologues beside the plain norm: ``add`` (the residual add
x + r, written out, then the norm of the sum) and ``gate`` (Mamba2's
rmsnorm(y * silu(z)), y the scan's fp32 output).  Their plain versions
(``add_rmsnorm_ref``, ``gated_rmsnorm_ref``: what the wrappers run on CPU
tensors) are held against the JAX package's composition -- ``x + r`` and
``y * silu(z)`` as ``repro.models.ssm.ssm_block`` forms it, then the
Pallas norm in interpret mode -- in fp32 and bf16 at ragged widths, every
(row, w) dtype mix, z as a strided column view.  The ops wrappers and the
model routing give the plain versions' bits on the CPU, and a CUDA lane
holds each variant against its plain version (skipped where there is no
card).  Tolerances: fp32 rtol = atol = 2e-4, bf16 3e-2
(``tests/test_kernels.py``); on the card bf16 within one bf16 rounding
step, and the add variant's h equal to the eager add bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ops as T
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_ref,
                                             gated_rmsnorm_ref)
from repro_torch.models import layers

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.rmsnorm.ops import rmsnorm as J
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = jnp = J = None  # lane (-m cuda) runs there

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)    # one bf16 rounding step
MIXES = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("bfloat16", "float32"), ("float32", "bfloat16")]


def _rows(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 3).astype(np.float32)
            for _ in range(n)] + [
        (1 + 0.5 * rng.standard_normal(shape[-1])).astype(np.float32)]


def _gate_inputs(shape, seed):
    """y (fp32), and z as a column slice of a wider projection row (the
    model's ``_split_proj`` view), and w."""
    y, proj, w = _rows(shape[:-1] + (2 * shape[-1] + 5,), seed)
    d = shape[-1]
    return y[..., :d].copy(), proj, w[:d], d


@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 128), (3, 5, 100),
                                   (7, 36)])
@pytest.mark.parametrize("xd,wd", MIXES)
def test_add_rmsnorm_plain_matches_jax(shape, xd, wd):
    x, r, w = _rows(shape, sum(shape))
    jx, jr = (jnp.asarray(a, getattr(jnp, xd)) for a in (x, r))
    jh = jx + jr
    want = J(jh, jnp.asarray(w, getattr(jnp, wd)), interpret=True)
    tx, tr = (torch.from_numpy(a).to(getattr(torch, xd)) for a in (x, r))
    h, got = add_rmsnorm_ref(tx, tr, torch.from_numpy(w).to(getattr(torch,
                                                                     wd)))
    assert h.dtype == got.dtype == getattr(torch, xd)
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(jh, np.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[xd])


@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 128), (3, 5, 100),
                                   (7, 36)])
@pytest.mark.parametrize("zd,wd", MIXES)
def test_gated_rmsnorm_plain_matches_jax(shape, zd, wd):
    """z is read as a column slice of a wider row, as the Mamba2 block
    slices it out of in_proj's output."""
    y, proj, w, d = _gate_inputs(shape, sum(shape) + 1)
    jz = jnp.asarray(proj, getattr(jnp, zd))[..., d:2 * d]
    jy = jnp.asarray(y)
    dt = getattr(jnp, zd)
    g = jy.astype(dt) * jax.nn.silu(jz.astype(jnp.float32)).astype(dt)
    want = J(g, jnp.asarray(w, getattr(jnp, wd)), interpret=True)
    tz = torch.from_numpy(proj).to(getattr(torch, zd))[..., d:2 * d]
    assert not tz.is_contiguous()
    got = gated_rmsnorm_ref(torch.from_numpy(y), tz,
                            torch.from_numpy(w).to(getattr(torch, wd)))
    assert got.dtype == getattr(torch, zd) and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[zd])


@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
def test_fused_ops_on_cpu_are_the_plain_versions(xd):
    """The ops wrappers and the model's routing give the plain versions'
    bits on CPU tensors, and count no launch."""
    dt = getattr(torch, xd)
    x, r, w = (torch.from_numpy(a) for a in _rows((2, 9, 64), 4))
    x, r = x.to(dt), r.to(dt)
    y, proj, wg, d = _gate_inputs((2, 9, 64), 5)
    y, z = torch.from_numpy(y), torch.from_numpy(proj).to(dt)[..., d:2 * d]
    wg = torch.from_numpy(wg)
    n0, v0 = RK.rmsnorm_2d.launches, dict(RK.rmsnorm_2d.variants)
    want_h, want_y = add_rmsnorm_ref(x, r, w)
    want_g = gated_rmsnorm_ref(y, z, wg)
    for h, out in (T.add_rmsnorm(x, r, w), layers.add_rmsnorm(x, r, w)):
        assert torch.equal(h, want_h) and torch.equal(out, want_y)
    for out in (T.gated_rmsnorm(y, z, wg), layers.gated_rmsnorm(y, z, wg)):
        assert torch.equal(out, want_g)
    assert RK.rmsnorm_2d.launches == n0
    assert dict(RK.rmsnorm_2d.variants) == v0


def test_fused_wrapper_checks_its_operands():
    x = torch.zeros((4, 32))
    w = torch.ones(32)
    with pytest.raises(ValueError):
        RK.rmsnorm_2d(x, w, residual=torch.zeros((4, 16)))
    with pytest.raises(ValueError):
        RK.rmsnorm_2d(x, w, residual=x, gate=x)


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


SHAPES = [(8, 2048), (300, 2048), (33, 5120), (4, 2560), (4, 36), (5, 100),
          (2, 3, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("xd,wd", MIXES)
def test_cuda_add_rmsnorm_matches_plain(cuda, shape, xd, wd):
    x, r, w = (torch.from_numpy(a).to(cuda) for a in _rows(shape, 7))
    x, r = x.to(getattr(torch, xd)), r.to(getattr(torch, xd))
    w = w.to(getattr(torch, wd))
    n0 = RK.rmsnorm_2d.variants.get("add", 0)
    h, got = T.add_rmsnorm(x, r, w)
    assert RK.rmsnorm_2d.variants.get("add", 0) == n0 + 1
    assert torch.equal(h, x + r)            # the eager add, bit for bit
    want_h, want = add_rmsnorm_ref(x, r, w)
    assert torch.equal(h, want_h)
    tol = BF16_ULP if xd == "bfloat16" else TOL[xd]
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("zd,wd", MIXES)
def test_cuda_gated_rmsnorm_matches_plain(cuda, shape, zd, wd):
    y, proj, w, d = _gate_inputs(shape, 8)
    y = torch.from_numpy(y).to(cuda)
    z = torch.from_numpy(proj).to(cuda, getattr(torch, zd))[..., d:2 * d]
    w = torch.from_numpy(w).to(cuda, getattr(torch, wd))
    n0 = RK.rmsnorm_2d.variants.get("gate", 0)
    got = T.gated_rmsnorm(y, z, w)
    assert RK.rmsnorm_2d.variants.get("gate", 0) == n0 + 1
    want = gated_rmsnorm_ref(y, z, w)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = BF16_ULP if zd == "bfloat16" else TOL[zd]
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_cuda_fused_norms_route_from_the_model_and_raise(cuda):
    x = torch.randn((4, 1, 2048), device=cuda).bfloat16()
    w = torch.ones(2048, device=cuda)
    n0 = dict(RK.rmsnorm_2d.variants)
    layers.add_rmsnorm(x, x, w)
    layers.gated_rmsnorm(x.float(), x, w)
    got = dict(RK.rmsnorm_2d.variants)
    assert got.get("add", 0) == n0.get("add", 0) + 1
    assert got.get("gate", 0) == n0.get("gate", 0) + 1
    with pytest.raises(TypeError):        # the gate takes the fp32 scan
        T.gated_rmsnorm(x, x, w)
    with pytest.raises(TypeError):        # x and r in one dtype
        T.add_rmsnorm(x, x.float(), w)
    with pytest.raises(ValueError):       # wider than a CTA holds
        T.rmsnorm(torch.zeros((2, 40000), device=cuda), torch.ones(
            40000, device=cuda))
