"""``entropy/xla_f32.py`` and the entropy bottleneck's pmf table against
eager JAX on the CPU, bit for bit (ROADMAP §C7).

* each function (``exp``, ``log``, ``log1p``, ``tanh``, ``sigmoid``,
  ``softplus``) on at least a million seeded float32 inputs per domain the
  EB meets: its parameters and logits (normal, scales 0.05 to 30), the
  sigmoid's and exp's arguments up to and past the clamps, log1p's (0, 1],
  and values near zero;
* ``einsum_cij_cjn`` at the EB's three layer shapes;
* ``EntropyBottleneck.pmf_table`` against ``lic_tpu``'s at C 32 and 192
  with the zero-init ``factor_i`` woken (seeds 11-16), trained-like
  parameters under hypothesis, and its quantized CDF tables.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from lic_tpu.coding.codec import FactorizedCoder as JFactorizedCoder
from lic_tpu.entropy.factorized import EntropyBottleneck as JEB
from lic_tpu_torch.coding.host_rans import FactorizedCoder
from lic_tpu_torch.entropy import xla_f32
from lic_tpu_torch.entropy.factorized import EntropyBottleneck

FUNCS = {
    "exp": jnp.exp,
    "log": jnp.log,
    "log1p": jnp.log1p,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "softplus": jax.nn.softplus,
}


def _domain(name, seed):
    rng = np.random.default_rng(seed)
    n = 1_000_000
    if name == "normal":
        x = rng.standard_normal(n) * rng.choice([0.05, 0.5, 3.0, 30.0], n)
    elif name == "wide":  # past every clamp: exp's ±88, tanh's 8 and 20
        x = rng.uniform(-100, 100, n)
    elif name == "unit":  # log1p's and log's (0, 1]
        x = rng.uniform(0, 1, n)
    elif name == "magnitudes":  # positive, 1e-35 to 1e35
        x = np.exp(rng.uniform(-80, 80, n))
    else:  # near zero, both signs
        x = rng.standard_normal(n) * 10.0 ** rng.uniform(-12, -1, n)
    return x.astype(np.float32)


CASES = [(f, d) for f in ("exp", "tanh", "sigmoid", "softplus") for d in ("normal", "wide", "tiny")]
CASES += [(f, d) for f in ("log", "log1p") for d in ("unit", "magnitudes")] + [("log1p", "tiny")]


@pytest.mark.parametrize("fn,domain", CASES)
def test_function_bitexact_vs_jax(fn, domain):
    x = _domain(domain, CASES.index((fn, domain)))
    want = np.asarray(FUNCS[fn](jnp.asarray(x)))
    got = getattr(xla_f32, fn)(x)
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (fn, domain, int((~same).sum()), x[~same][:4], want[~same][:4])


def test_fma_rounds_once():
    """a·b + c exactly 1 + 2⁻²³ + 2⁻²⁴ − 2⁻⁶⁰: just under the float32 tie,
    so one rounding gives 1 + 2⁻²³, while the float64 sum rounds onto
    the tie and then to even, 1 + 2⁻²²."""
    a = np.float32(1 + 2**-18)
    b = np.float32(2**-24 * (1 - 2**-18))
    c = np.float32(1 + 2**-23)
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive == np.float32(1 + 2**-22)
    assert xla_f32.fma(a, b, c) == np.float32(1 + 2**-23)
    assert xla_f32.fma(-a, b, -c) == -np.float32(1 + 2**-23)


@pytest.mark.parametrize("shape", [(32, 3, 1, 256), (192, 3, 3, 256), (192, 1, 3, 256)])
def test_einsum_bitexact_vs_jax(shape):
    c, i, j, s = shape
    rng = np.random.default_rng(c + i + j)
    m = rng.standard_normal((c, i, j)).astype(np.float32)
    v = (rng.standard_normal((c, j, s)) * 5).astype(np.float32)
    want = np.asarray(jnp.einsum("cij,cjn->cin", jnp.asarray(m), jnp.asarray(v)))
    np.testing.assert_array_equal(xla_f32.einsum_cij_cjn(m, v).view(np.int32),
                                  want.view(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_eb(c):
    jm = JEB(c)
    p = jm.init(jax.random.PRNGKey(c), jnp.zeros((1, 2, 2, c)), training=False)["params"]
    return jm, jax.tree.map(np.array, p)


def _tables(jm, p, c):
    want = np.asarray(jm.apply({"params": p}, -128, 127, method=JEB.pmf_table))
    tm = EntropyBottleneck(c)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    got = tm.pmf_table(-128, 127)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    return got.numpy(), want


@pytest.mark.parametrize("c", [32, 192])
@pytest.mark.parametrize("seed", range(11, 17))
def test_woken_pmf_table_and_cdfs_bitexact(c, seed):
    jm, p = _jax_eb(c)
    rng = np.random.default_rng(seed)
    p = {k: v if np.any(v) else (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
         for k, v in p.items()}
    got, want = _tables(jm, p, c)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    med = p["quantiles"][:, 0, 1]
    np.testing.assert_array_equal(FactorizedCoder(got, med, -128).codec.cdfs,
                                  JFactorizedCoder(want, med, -128).codec.cdfs)


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), spread=st.sampled_from([0.1, 0.5, 1.0, 2.0]))
def test_trained_like_pmf_table_bitexact(seed, spread):
    """Every leaf moved off its init, as training moves it, medians
    included."""
    c = 32
    jm, p = _jax_eb(c)
    rng = np.random.default_rng(seed)
    p = {k: (v + rng.standard_normal(v.shape) * (spread * (4 if k == "quantiles" else 1)))
         .astype(np.float32) for k, v in p.items()}
    got, want = _tables(jm, p, c)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

