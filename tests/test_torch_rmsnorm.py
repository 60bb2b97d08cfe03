"""The port's RMSNorm against the JAX package's: the plain version (what the
port's ``ops.rmsnorm`` runs on CPU tensors) against the Pallas kernel in
interpret mode and against the JAX reference at ragged widths, every
(x, w) dtype mix, the routing of ``models.layers.rmsnorm``, and a CUDA lane
holding K8 against its plain version (skipped where there is no card).
Tolerances: fp32 rtol = atol = 2e-4, bf16 3e-2 (``tests/test_kernels.py``);
on the card bf16 within one bf16 rounding step."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ops as T
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import layers

try:
    import jax.numpy as jnp
    from repro.kernels.rmsnorm.ops import rmsnorm as J
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as J_ref
except ImportError:      # the card's machine has no JAX: only the CUDA
    jnp = J = J_ref = None  # lane (-m cuda) runs there

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)    # one bf16 rounding step


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = (1 + 0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 128), (3, 5, 256),
                                   (7, 96)])
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_rmsnorm_plain_matches_pallas(shape, xd, wd):
    x, w = _inputs(shape, sum(shape))
    want = J(jnp.asarray(x, getattr(jnp, xd)), jnp.asarray(w, getattr(jnp, wd)),
             interpret=True)
    n0 = RK.rmsnorm_2d.launches
    got = T.rmsnorm(torch.from_numpy(x).to(getattr(torch, xd)),
                    torch.from_numpy(w).to(getattr(torch, wd)))
    assert RK.rmsnorm_2d.launches == n0         # CPU: the plain version
    assert got.dtype == getattr(torch, xd) and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[xd])


@pytest.mark.parametrize("d", [36, 100, 5, 2048])
@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_ref_at_ragged_widths(d, xd):
    x, w = _inputs((4, d), d)
    want = J_ref(jnp.asarray(x, getattr(jnp, xd)), jnp.asarray(w), 1e-6)
    got = rmsnorm_ref(torch.from_numpy(x).to(getattr(torch, xd)),
                      torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[xd])


def test_rmsnorm_wrapper_reads_rows_at_their_stride_on_cpu():
    x, w = _inputs((6, 80), 1)
    xt = torch.from_numpy(x)
    got = RK.rmsnorm_2d(xt[:, :48], torch.from_numpy(w[:48]))
    want = rmsnorm_ref(xt[:, :48].contiguous(), torch.from_numpy(w[:48]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        RK.rmsnorm_2d(xt, torch.from_numpy(w[:48]))


def test_rmsnorm_routing(monkeypatch):
    """On the CPU ``layers.rmsnorm`` keeps the plain code (the JAX
    package's ``models.layers.rmsnorm``); routed to the kernel it takes the
    ops wrapper, whose CPU branch is the kernel's plain version -- the
    same bits."""
    x, w = _inputs((2, 9, 64), 2)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w)
    assert not layers._rmsnorm_kernel_eligible(xt)
    n0 = RK.rmsnorm_2d.launches
    plain = layers.rmsnorm(xt, wt)
    monkeypatch.setattr(layers, "_rmsnorm_kernel_eligible", lambda x: True)
    routed = layers.rmsnorm(xt, wt)
    assert RK.rmsnorm_2d.launches == n0
    assert torch.equal(plain.view(torch.int16), routed.view(torch.int16))


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 2048), (300, 2048), (33, 5120),
                                   (4, 36), (5, 100), (2, 3, 768)])
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_cuda_rmsnorm_matches_plain(cuda, shape, xd, wd):
    x, w = _inputs(shape, sum(shape))
    xt = torch.from_numpy(x).to(cuda, getattr(torch, xd))
    wt = torch.from_numpy(w).to(cuda, getattr(torch, wd))
    n0 = RK.rmsnorm_2d.launches
    got = T.rmsnorm(xt, wt)
    assert RK.rmsnorm_2d.launches == n0 + 1
    want = rmsnorm_ref(xt, wt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = BF16_ULP if xd == "bfloat16" else TOL[xd]
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_cuda_rmsnorm_strided_rows_and_routing(cuda):
    x, w = _inputs((64, 2056), 3)
    xt = torch.from_numpy(x).to(cuda).bfloat16()
    wt = torch.from_numpy(w[:2048]).to(cuda)
    view = xt[:, 8:]                    # rows 2056 apart, 16-byte aligned
    n0 = RK.rmsnorm_2d.launches
    got = RK.rmsnorm_2d(view, wt)
    torch.testing.assert_close(got.float(), rmsnorm_ref(view, wt).float(),
                               **BF16_ULP)
    odd = xt[:, 3:2051]                 # rows that no vector load can take
    torch.testing.assert_close(RK.rmsnorm_2d(odd, wt).float(),
                               rmsnorm_ref(odd, wt).float(), **BF16_ULP)
    layers.rmsnorm(xt[:, :2048], wt)    # the model's norm routes to K8
    assert RK.rmsnorm_2d.launches == n0 + 3
    with pytest.raises(TypeError):
        RK.rmsnorm_2d(xt[:, :2048].half(), wt)
