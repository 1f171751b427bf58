"""Float32 functions as XLA's CPU backend computes them, in numpy.

The factorized prior's code tables must be the same bits in both
packages: the ``.ltc`` digest is the crc32 of their quantized CDFs, and
one moved CDF entry makes a stream of one package undecodable by the
other.  ``lic_tpu/entropy/factorized.py::pmf_table`` runs eagerly under
JAX on the CPU, where XLA compiles each operation on its own (and
``jax.nn.softplus``, ``jax.nn.sigmoid`` and ``jnp.einsum``, which are
``jax.jit``-wrapped, each as one fusion).  XLA lowers ``exp``, ``log1p``
and ``tanh`` to its own polynomials, not to libm, and the x86 backend
contracts a product feeding one sum into a fused multiply-add, so neither
numpy nor torch reproduces them.  The functions here follow the LLVM IR
that XLA emits for each of them (``--xla_dump_to``), operation by
operation and with the same contractions:

* ``fma(a, b, c)`` rounds a·b + c once.  The float32 product is exact in
  float64 (24 + 24 bits), the float64 sum is made round-to-odd from its
  exact error (two-sum), and round-to-odd at 53 bits followed by the
  float32 rounding equals one rounding to float32 (53 ≥ 24 + 2).
* XLA's CPU runtime flushes subnormal inputs and results to zero, so
  every operation here does too (``_ftz``).

``tests/test_torch_port_xla_f32.py`` holds each function bit for bit
against its JAX function on over a million seeded inputs, and the
entropy bottleneck's table against ``pmf_table``.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32
_MIN_NORMAL = np.float32(2.0**-126)


def _c(bits: int) -> np.float32:
    """A float32 constant from the hex of the double that LLVM IR prints
    for it (every such double is a float32 value)."""
    return np.float64(np.array([bits], np.uint64).view(np.float64)[0]).astype(_F32)


def _ftz(x) -> np.ndarray:
    """float32 with subnormals flushed to zero, keeping the sign."""
    x = np.asarray(x, _F32)
    return np.where(np.abs(x) < _MIN_NORMAL, np.copysign(_F32(0), x), x).astype(_F32)


def f32(x) -> np.ndarray:
    """An input as XLA reads it: float32, subnormals as zero."""
    return _ftz(x)


def add(a, b):
    with np.errstate(over="ignore", invalid="ignore"):
        return _ftz(np.add(a, b, dtype=_F32))


def sub(a, b):
    with np.errstate(over="ignore", invalid="ignore"):
        return _ftz(np.subtract(a, b, dtype=_F32))


def mul(a, b):
    with np.errstate(over="ignore", invalid="ignore"):
        return _ftz(np.multiply(a, b, dtype=_F32))


def div(a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        return _ftz(np.divide(a, b, dtype=_F32))


def fma(a, b, c) -> np.ndarray:
    """round_f32(a·b + c), rounded once (see the module docstring)."""
    p = np.asarray(a, _F32).astype(np.float64) * np.asarray(b, _F32).astype(np.float64)
    c = np.asarray(c, _F32).astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        s = p + c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)  # exact: p + c == s + err
        even = (s.view(np.int64) & 1) == 0
        fix = (err != 0) & even & np.isfinite(s)
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
        return _ftz(s.astype(_F32))


# ------------------------------------------------------------------ exp

_EXP_LO, _EXP_HI = _c(0xC055F33340000000), _c(0x4056333340000000)  # -87.8, 88.8
_LOG2E = _c(0x3FF7154760000000)
_LN2_HI, _LN2_LO = _c(0x3FE6300000000000), _c(0xBF2BD01060000000)
_EXP_P = [_c(b) for b in (0x3F2A0D2CE0000000, 0x3F56E879C0000000, 0x3F81112100000000,
                          0x3FA5553820000000, 0x3FC5555540000000)]


def _exp_parts(x):
    """exp(x) = y · 2ⁿ: the clamped Cody–Waite reduction and degree-5
    polynomial of XLA's float32 exp → (y, 2ⁿ), both float32."""
    x = np.minimum(np.maximum(f32(x), _EXP_LO), _EXP_HI)
    fx = np.floor(fma(x, _LOG2E, _F32(0.5)))
    fx = np.minimum(np.maximum(fx, _F32(-127)), _F32(127))
    r = fma(-fx, _LN2_HI, x)
    r = fma(-fx, _LN2_LO, r)
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for k in _EXP_P[2:]:
        p = fma(p, r, k)
    p = fma(p, r, _F32(0.5))
    y = add(fma(p, mul(r, r), r), _F32(1))
    # 2ⁿ from its bits; n = -127 gives the bits of 0.0
    pow2 = ((fx.astype(np.int32) + 127) << 23).astype(np.int32).view(_F32)
    return y, pow2


def exp(x) -> np.ndarray:
    """``jnp.exp`` on float32."""
    y, pow2 = _exp_parts(x)
    return mul(y, pow2)


def sigmoid(x) -> np.ndarray:
    """``jax.nn.sigmoid`` (``lax.logistic``): 1 / (1 + exp(−x)), the last
    product of the exp fused with the + 1."""
    y, pow2 = _exp_parts(-f32(x))
    return div(_F32(1), fma(y, pow2, _F32(1)))


# ------------------------------------------------------------------ log

_SQRT_HALF = _c(0x3FE6A09E60000000)
_LOG_P = [_c(b) for b in (0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
                          0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
                          0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000)]


def log(u) -> np.ndarray:
    """XLA's float32 log: the exponent split off, the mantissa folded
    into [√½, √2), a degree-8 polynomial evaluated in three interleaved
    parts, and e·ln2 added in two pieces."""
    u = f32(u)
    v = np.maximum(u, _MIN_NORMAL)
    bits = v.view(np.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)  # mantissa in [0.5, 1)
    e = add(((bits >> 23) - 127).astype(_F32), _F32(1))
    small = m < _SQRT_HALF
    e = sub(e, np.where(small, _F32(1), _F32(0)))
    x = add(add(m, _F32(-1)), np.where(small, m, _F32(0)))
    x2 = mul(x, x)
    x3 = mul(x2, x)
    p = _LOG_P
    y = fma(fma(x, p[0], p[1]), x, p[2])
    y1 = fma(fma(x, p[3], p[4]), x, p[5])
    y2 = fma(fma(x, p[6], p[7]), x, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, mul(e, _LN2_LO))
    x = fma(-x2, _F32(0.5), x)
    out = fma(e, _LN2_HI, add(x, y))
    with np.errstate(invalid="ignore"):
        out = np.where(u < 0, _F32(np.nan), out)
        out = np.where(u == 0, _F32(-np.inf), out)
        out = np.where(u == np.inf, _F32(np.inf), out)
    return out.astype(_F32)


_LOG1P_SMALL = _c(0x3FDA8279A0000000)  # √2 − 1
_LOG1P_NUM = [_c(b) for b in (0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
                              0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
                              0x40340A2020000000)]
_LOG1P_DEN = [_F32(1)] + [_c(b) for b in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000, 0x4073519460000000,
    0x406B0DB140000000, 0x404E0F3040000000)]


def _horner(x, coeffs):
    poly = coeffs[0]
    for k in coeffs[1:]:
        poly = fma(poly, x, k)
    return poly


def log1p(x) -> np.ndarray:
    """XLA's ``EmitLog1p``: for |x| < √2 − 1 the Cephes rational form
    x + (−½x² + x³·P(x)/Q(x)), else log(1 + x)."""
    x = f32(x)
    x2 = mul(x, x)
    ratio = div(_horner(x, _LOG1P_NUM), _horner(x, _LOG1P_DEN))
    small = add(x, fma(x2, _F32(-0.5), mul(mul(x, x2), ratio)))
    large = log(add(x, _F32(1)))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, large).astype(_F32)


def softplus(x) -> np.ndarray:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as XLA fuses it,
    max(x, 0) + log1p(exp(−|x|)), NaN passed through."""
    x = f32(x)
    out = add(np.maximum(x, _F32(0)), log1p(exp(-np.abs(x))))
    return np.where(np.isnan(x), x, out).astype(_F32)


# ----------------------------------------------------------------- tanh

_TANH_SMALL = _c(0x3F3A36E2E0000000)  # 0.0004
_TANH_CLAMP = _c(0x401FFEC880000000)  # 7.99881172180175781
_TANH_NUM = [_c(b) for b in (0xBCB3E4B800000000, 0x3D4C266FC0000000, 0xBDD7A6FFE0000000,
                             0x3E6B800820000000, 0x3EEF286940000000, 0x3F44E1BDA0000000,
                             0x3F740B3B80000000)]
_TANH_DEN = [_c(b) for b in (0x3EB41A7B00000000, 0x3F1F12BAC0000000, 0x3F629540A0000000,
                             0x3F740B3BA0000000)]


def tanh(x) -> np.ndarray:
    """``jnp.tanh``: the clamped odd rational approximation, x itself
    below 0.0004 and ±1 from 20 up."""
    x = f32(x)
    xc = np.minimum(np.maximum(x, -_TANH_CLAMP), _TANH_CLAMP)
    x2 = mul(xc, xc)
    r = div(mul(xc, _horner(x2, _TANH_NUM)), _horner(x2, _TANH_DEN))
    r = np.where(np.abs(x) < _TANH_SMALL, x, r)
    return np.where(np.abs(x) >= 20, np.copysign(_F32(1), x), r).astype(_F32)


# --------------------------------------------------------------- einsum

def einsum_cij_cjn(m, v) -> np.ndarray:
    """``jnp.einsum("cij,cjn->cin", m, v)``: a broadcast product for
    j = 1, else the sum over j in order, each term fused into it."""
    m, v = f32(m), f32(v)
    if m.shape[2] == 1:
        return mul(m, v)
    acc = np.zeros((m.shape[0], m.shape[1], v.shape[2]), _F32)
    for j in range(m.shape[2]):
        acc = fma(m[:, :, j : j + 1], v[:, j : j + 1, :], acc)
    return acc
