"""The float32 log1p and expm1 of the JAX package's codec, bit for bit, in
numpy: the means codec stores sign(x) log1p(|x|) and decodes with
sign(y) expm1(|y|), and the JAX package computes both with XLA's float32
approximations on the host, whose results differ from correctly rounded
ones in the last bit for about a quarter of all inputs. Reproducing them
op by op keeps the port's bitstreams and decodes equal to the JAX
package's (tests/test_torch_codec.py holds them against jnp).

The approximations (XLA's CPU code generation of them):
  * exp: Cephes expf, n = floor(x log2(e) + 1/2), the reduced argument
    in two steps, a degree-5 polynomial, scaled by 2^n;
  * tanh: Eigen's rational approximation (odd degree 13 over even degree
    6), the input clamped to +-7.99881172, x itself below 4e-4;
  * expm1: exp(x) - 1 above |x| = 1/2, else tanh(x/2) (exp(x) + 1);
  * log: Cephes logf on the mantissa in [sqrt(1/2), sqrt(2)), a degree-8
    polynomial in three parts;
  * log1p: log(1 + x) from |x| = sqrt(2) - 1 up, else Cephes' rational
    approximation.
Where XLA fuses a multiply and an add into one rounding, so does this
code (``_fma``, exact in long double before the one rounding to float32).
"""

from __future__ import annotations

import numpy as np

_F = np.float32
_L = np.longdouble


def _fma(a, b, c) -> np.ndarray:
    return (np.asarray(a, _L) * np.asarray(b, _L)
            + np.asarray(c, _L)).astype(_F)


def _mul(a, b) -> np.ndarray:
    return (np.asarray(a, _F) * np.asarray(b, _F)).astype(_F)


def _add(a, b) -> np.ndarray:
    return (np.asarray(a, _F) + np.asarray(b, _F)).astype(_F)


def _exp(x: np.ndarray) -> np.ndarray:
    xc = np.clip(x, _F(-87.8), _F(88.8))
    n = np.floor(_fma(xc, _F(1.44269504088896341), _F(0.5)))
    r = _fma(n, -_F(0.693359375), xc)
    r = _fma(n, -_F(-2.12194440e-4), r)
    y = np.full_like(r, _F(1.9875691500e-4))
    for c in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        y = _fma(y, r, _F(c))
    y = _add(_fma(y, _mul(r, r), r), _F(1))
    with np.errstate(over="ignore"):
        return np.ldexp(y, n.astype(np.int32)).astype(_F)


def _tanh(x: np.ndarray) -> np.ndarray:
    xc = np.clip(x, _F(-7.99881172180175781), _F(7.99881172180175781))
    x2 = _mul(xc, xc)
    num = np.full_like(x2, _F(-2.76076847742355e-16))
    for c in (2.00018790482477e-13, -8.60467152213735e-11,
              5.12229709037114e-08, 1.48572235717979e-05,
              6.37261928875436e-04, 4.89352455891786e-03):
        num = _fma(x2, num, _F(c))
    den = np.full_like(x2, _F(1.19825839466702e-06))
    for c in (1.18534705686654e-04, 2.26843463243900e-03,
              4.89352518554385e-03):
        den = _fma(x2, den, _F(c))
    out = (_mul(xc, num) / den).astype(_F)
    return np.where(np.abs(x) < _F(0.0004), x, out)


def _log(x: np.ndarray) -> np.ndarray:
    bits = np.maximum(x, _F(1.17549435e-38)).view(np.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(_F)  # in [0.5, 1)
    e = _add(((bits >> 23) - 0x7F).astype(_F), _F(1))
    low = m < _F(0.707106781186547524)
    t = _add(_add(m, _F(-1)), np.where(low, m, _F(0)))
    e = _add(e, -np.where(low, _F(1), _F(0)))
    t2 = _mul(t, t)
    t3 = _mul(t2, t)
    p = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
         -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
         2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
    y = _fma(_F(p[0]), t, _F(p[1]))
    y1 = _fma(_F(p[3]), t, _F(p[4]))
    y2 = _fma(_F(p[6]), t, _F(p[7]))
    y = _fma(y, t, _F(p[2]))
    y1 = _fma(y1, t, _F(p[5]))
    y2 = _fma(y2, t, _F(p[8]))
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, _mul(e, _F(-2.12194440e-4)))
    out = _fma(e, _F(0.693359375), _add(_fma(t2, _F(-0.5), t), y))
    out = np.where(x == 0, _F(-np.inf), out)
    out = np.where(x < 0, _F(np.nan), out)
    return np.where(np.isposinf(x), x, out).astype(_F)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p(x) -> np.ndarray:
    """log(1 + x) of float32 x >= 0, with the JAX package's bits."""
    x = np.asarray(x, _F)

    def poly(cs):
        r = np.full_like(x, _F(cs[0]))
        for c in cs[1:]:
            r = _fma(r, x, _F(c))
        return r

    with np.errstate(over="ignore", invalid="ignore"):  # large x: unused
        x2 = _mul(x, x)
        small = _mul(_mul(x, x2),
                     (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)).astype(_F))
        small = _add(x, _fma(_F(-0.5), x2, small))
    return np.where(np.abs(x) < _F(0.41421356237309504880), small,
                    _log(_add(x, _F(1))))


def expm1(x) -> np.ndarray:
    """exp(x) - 1 of float32 x, with the JAX package's bits."""
    x = np.asarray(x, _F)
    e = _exp(x)
    small = _mul(_tanh(_mul(x, _F(0.5))), _add(e, _F(1)))
    return np.where(np.abs(x) > _F(0.5), _add(e, _F(-1)), small)


def log_transform(x) -> np.ndarray:
    """sign(x) log1p(|x|), as the JAX package's means codec forms it."""
    x = np.asarray(x, _F)
    return _mul(np.sign(x), log1p(np.abs(x)))


def inverse_log_transform(y) -> np.ndarray:
    """sign(y) expm1(|y|), log_transform's inverse."""
    y = np.asarray(y, _F)
    return _mul(np.sign(y), expm1(np.abs(y)))
