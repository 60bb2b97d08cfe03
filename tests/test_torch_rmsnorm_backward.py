"""K11's plain version and the differentiable RMSNorm against the JAX
package's gradients, on the CPU, and (``cuda`` lane) K11 against its plain
version on the card.

``rmsnorm_backward_ref`` (the closed form: dx = rstd (gw - xhat c) + dh,
dw = sum dy xhat) is held, plain and add, to ``jax.grad`` of the JAX
package's ``rmsnorm_ref`` (the add: of ``rmsnorm_ref(x + r)`` with h's own
gradient added), and ``ops.rmsnorm`` / ``ops.add_rmsnorm`` under autograd
(the ``torch.autograd.Function``s whose forward is K8's wrapper and
backward K11's; plain versions on CPU tensors) likewise, at ragged widths,
fp32 within rtol = atol = 2e-4 (``tests/test_kernels.py``).  On the card
K11 is held to the plain version at every (row, w) dtype mix, each output
within 2e-4 where its dtype is fp32 and 3e-2 where it is bf16 (dx in the
rows' dtype, dw in w's), and two calls are bit-identical."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ops as T
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

FP32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
SHAPES = [(16, 64), (2, 9, 100), (3, 5, 256), (7, 36)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    return x, r, w, dy, dh


@functools.lru_cache(maxsize=None)
def _jax_grads(shape, variant):
    """jax.grad of sum(y * dy) (+ sum(h * dh), add) over (x[, r], w)."""
    x, r, w, dy, dh = _inputs(shape)

    def plain(x_, w_):
        return jnp.sum(j_rmsnorm(x_, w_) * dy)

    def add(x_, r_, w_):
        h = x_ + r_
        return jnp.sum(j_rmsnorm(h, w_) * dy) + jnp.sum(h * dh)
    if variant == "plain":
        return [np.asarray(g) for g in jax.jit(jax.grad(
            plain, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))]
    return [np.asarray(g) for g in jax.jit(jax.grad(
        add, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(r),
                                 jnp.asarray(w))]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["plain", "add"])
def test_backward_ref_matches_jax_grad(shape, variant):
    x, r, w, dy, dh = (torch.from_numpy(a) for a in _inputs(shape))
    d = shape[-1]
    if variant == "plain":
        dx, dw = rmsnorm_backward_ref(x.reshape(-1, d), w, dy.reshape(-1, d))
        got = [dx, dw]
    else:
        h = x + r
        dx, dw = rmsnorm_backward_ref(h.reshape(-1, d), w, dy.reshape(-1, d),
                                      dh=dh.reshape(-1, d))
        got = [dx, dx, dw]
    for g, want in zip(got, _jax_grads(shape, variant)):
        np.testing.assert_allclose(g.reshape(want.shape).numpy(), want,
                                   **FP32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["plain", "add"])
def test_autograd_function_matches_jax_grad(shape, variant):
    x, r, w, dy, dh = (torch.from_numpy(a).requires_grad_()
                       for a in _inputs(shape))
    n0 = (RK.rmsnorm_2d.launches, RK.rmsnorm_backward.launches)
    if variant == "plain":
        y = T.rmsnorm(x, w)
        assert y.grad_fn is not None
        (y * dy.detach()).sum().backward()
        got = [x.grad, w.grad]
    else:
        h, y = T.add_rmsnorm(x, r, w)
        ((y * dy.detach()).sum() + (h * dh.detach()).sum()).backward()
        got = [x.grad, r.grad, w.grad]
    assert (RK.rmsnorm_2d.launches, RK.rmsnorm_backward.launches) == n0
    for g, want in zip(got, _jax_grads(shape, variant)):
        np.testing.assert_allclose(g.numpy(), want, **FP32)


def test_add_function_when_only_h_or_only_y_has_a_gradient():
    x, r, w, dy, dh = (torch.from_numpy(a).requires_grad_()
                       for a in _inputs((4, 64)))
    h, _y = T.add_rmsnorm(x, r, w)          # the norm's output unused
    (h * dh.detach()).sum().backward()
    torch.testing.assert_close(x.grad, dh.detach())
    torch.testing.assert_close(r.grad, dh.detach())
    assert w.grad is None
    x.grad = r.grad = None
    _h, y = T.add_rmsnorm(x, r, w)          # h unused: dx = dnorm(dy)
    (y * dy.detach()).sum().backward()
    want, wdw = rmsnorm_backward_ref((x + r).detach(), w.detach(),
                                     dy.detach())
    torch.testing.assert_close(x.grad, want)
    torch.testing.assert_close(w.grad, wdw)


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


# K11 on the card: the training shape, widths that are not a multiple of a
# thread's 8 columns or of a CTA's 256 (80, 1000, 2304), a row wider than
# 1024 threads' 16-byte vectors would hold in one pass (5120), rows whose
# bf16 width breaks the 16-byte vectors (100, 36: the scalar path), and
# fewer rows than CTAs (5, 1, 2)
CARD_SHAPES = [(4096, 2048), (300, 2048), (33, 5120), (5, 100), (1, 36),
               (7, 80), (9, 1000), (2, 2048), (64, 2304)]


def _card_inputs(cuda, shape, xd, wd, variant, pad=0):
    """x, w, dy, dh on the card; pad > 0: the rows of x, dy and dh are
    column slices of rows ``pad`` wider (a row stride larger than D)."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + pad)
    xdt, wdt = getattr(torch, xd), getattr(torch, wd)
    wide = (shape[0], shape[1] + pad)

    def rows(scale=1.0):
        t = (scale * torch.randn(wide, generator=g, device=cuda)).to(xdt)
        return t[:, :shape[1]]
    x = rows(3.0)
    w = (1 + 0.5 * torch.randn(shape[-1], generator=g, device=cuda)).to(wdt)
    dy = rows()
    dh = rows() if variant == "add" else None
    return x, w, dy, dh


def _hold_k11(x, w, dy, dh, xd, wd, variant):
    """Two K11 calls: bit-identical, each output to its dtype's tolerance
    against the plain version."""
    n0 = RK.rmsnorm_backward.variants.get(variant, 0)
    got = RK.rmsnorm_backward(x, w, dy, dh=dh)
    again = RK.rmsnorm_backward(x, w, dy, dh=dh)
    assert RK.rmsnorm_backward.variants[variant] == n0 + 2
    want = rmsnorm_backward_ref(x, w, dy, dh=dh)
    for a, a2, ref, t in zip(got, again, want, (x, w)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, a2)
    # each output to the tolerance of its dtype: dx in the rows', dw in
    # w's (a bf16 dw may round one bf16 step the other way: its fp32 sums
    # run in another order than the plain version's)
    tol = FP32 if xd == "float32" else BF16
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    # dw sums one product per row: hold it relative to its largest value
    tol = FP32 if wd == "float32" else BF16
    scale = float(want[1].float().abs().max())
    torch.testing.assert_close(got[1].float(), want[1].float(),
                               rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
@pytest.mark.parametrize("variant", ["plain", "add"])
def test_cuda_rmsnorm_backward_matches_plain(cuda, shape, xd, wd, variant):
    _hold_k11(*_card_inputs(cuda, shape, xd, wd, variant), xd, wd, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 80), (9, 1000), (300, 2048),
                                   (2, 2304)])
@pytest.mark.parametrize("pad", [8, 1])
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("variant", ["plain", "add"])
def test_cuda_rmsnorm_backward_row_stride(cuda, shape, pad, xd, wd,
                                          variant):
    """Rows at a stride larger than D: 16-byte aligned rows (pad 8) and
    rows that are not (pad 1: the scalar path)."""
    x, w, dy, dh = _card_inputs(cuda, shape, xd, wd, variant, pad)
    assert x.stride(0) == shape[1] + pad
    _hold_k11(x, w, dy, dh, xd, wd, variant)


@pytest.mark.cuda
def test_cuda_functions_launch_k8_and_k11(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 8, 256, generator=g, device=cuda, requires_grad=True)
    r = torch.randn(2, 8, 256, generator=g, device=cuda, requires_grad=True)
    w = torch.ones(256, device=cuda, requires_grad=True)
    n0 = (RK.rmsnorm_2d.launches, RK.rmsnorm_backward.launches)
    h, y = T.add_rmsnorm(x, r, w)
    (T.rmsnorm(h, w) + y).sum().backward()
    assert (RK.rmsnorm_2d.launches - n0[0],
            RK.rmsnorm_backward.launches - n0[1]) == (2, 2)
    assert all(torch.isfinite(t.grad).all() for t in (x, r, w))
