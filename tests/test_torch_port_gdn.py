"""Port parity: GDN/IGDN and kernel B2's plain version.

The port's plain GDN is held to ``lic_tpu.layers.gdn.GDN`` (its plain
einsum path) and to the JAX kernel ``gdn_fused`` run in interpret mode, at
atol 1e-5 / rtol 1e-5 (fp32 sums in another order).  The CUDA kernel
itself needs a card: ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``
hold it to the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.layers.gdn import GDN as JGDN
from lic_tpu.layers.pallas_gdn import gdn_fused as jgdn_fused
from lic_tpu_torch.layers import GDN, gdn_fused, gdn_plain

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(c, inverse, seed):
    """JAX GDN params moved off their init, plus an input (NHWC)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 5, c)).astype(np.float32)
    jm = JGDN(c, inverse=inverse)
    p = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    p["gamma"] = p["gamma"] + 0.05 * np.abs(rng.standard_normal((c, c))).astype(np.float32)
    p["beta"] = p["beta"] + 0.2 * rng.uniform(size=c).astype(np.float32)
    return jm, p, x


def _port(c, inverse, p):
    m = GDN(c, inverse=inverse)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return m


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax_plain(c, inverse):
    jm, p, x = _case(c, inverse, seed=c + inverse)
    yj = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    m = _port(c, inverse, p)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )
    with torch.no_grad():
        yt = m(xt)
    assert yt.shape == xt.shape
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), yj, **TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_plain_matches_jax_kernel_interpret(inverse):
    """The port's plain GDN vs the Pallas kernel ``gdn_fused`` (interpret
    mode on the CPU), on the effective β/Γ of the JAX module."""
    c = 32
    jm, p, x = _case(c, inverse, seed=7 + inverse)
    m = _port(c, inverse, p)
    gamma = m._gamma_rp(m.gamma).detach()
    beta = m._beta_rp(m.beta).detach()
    yj = np.asarray(
        jgdn_fused(jnp.asarray(x), jnp.asarray(gamma.numpy()),
                   jnp.asarray(beta.numpy()), inverse, True)
    )
    x2d = torch.from_numpy(x.reshape(-1, c))
    yt = gdn_plain(x2d, gamma, beta, inverse)
    np.testing.assert_allclose(yt.numpy().reshape(x.shape), yj, **TOL)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = gdn_fused.launches
    np.testing.assert_array_equal(gdn_fused(x2d, gamma, beta, inverse).numpy(), yt.numpy())
    assert gdn_fused.launches == before


def test_gdn_plain_bf16_norm_in_fp32():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    gamma = 0.1 * torch.eye(16) + 0.01
    beta = torch.ones(16)
    y16 = gdn_plain(x.bfloat16(), gamma, beta, False)
    assert y16.dtype == torch.bfloat16
    ref = gdn_plain(x.bfloat16().float(), gamma, beta, False)
    np.testing.assert_allclose(y16.float().numpy(), ref.numpy(), rtol=1e-2, atol=1e-2)
