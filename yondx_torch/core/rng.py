"""Deterministic RNG plumbing (port of yondx/core/rng.py), with a numpy
threefry2x32 that reproduces `jax.random` keys and draws bit for bit.

The held-out scenes draw each crop's camera from `jax.random.PRNGKey(seed)`
(yondx/eval/heldout.py build_scene -> data/unprocess.py). The card machine
has no JAX, so the port keeps the arithmetic of jax 0.9.0 at its defaults
(`jax_threefry_partitionable=True`, 32-bit mode) over numpy uint32:
- a key is two uint32 words; `PRNGKey(seed)` = [seed >> 32, seed & 0xffffffff]
  of the seed as a 32-bit integer;
- `split(key, n)` and the 32-bit draws hash the counters of a uint64 iota
  of the output shape, split into (hi, lo) words: keys are the two output
  words of threefry2x32(key, (hi, lo)), draws are their xor;
- `uniform` keeps the top 23 bits as a mantissa in [1, 2), subtracts 1,
  scales to [minval, maxval) with the bounds cast to float32 first, and
  clamps below at minval;
- `normal` is sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1)), with XLA's
  single-precision erfinv (Giles' polynomial) evaluated in float32;
- `randint` draws two 32-bit words from split(key) and folds them into
  [minval, maxval) as JAX's `_randint` does.

The draws are a few scalars per crop, so they run on the host.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_F32 = np.float32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def setup_seed(seed: int) -> None:
    """Pin the host's global numpy RNG."""
    np.random.seed(seed)


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2); uint32 arrays in, a pair of uint32 arrays out."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    a = np.asarray(x1, _U32) + ks[0]
    b = np.asarray(x2, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r)
                b = a ^ b
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def _iota_2x32(shape):
    """(hi, lo) uint32 words of a uint64 iota reshaped to `shape`."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    idx = idx.reshape(shape)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))


def _key(key) -> np.ndarray:
    key = np.asarray(key, _U32)
    if key.shape != (2,):
        raise ValueError(f"a threefry key is uint32[2], got {key.shape}")
    return key


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) with 64-bit mode off: uint32[2]."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit a 32-bit integer")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _uniform_bits(bits, minval, maxval) -> np.ndarray:
    lo = _F32(minval)
    hi = _F32(maxval)
    mant = (np.asarray(bits, _U32) >> _U32(32 - 23)) | _U32(0x3F800000)
    floats = mant.view(_F32) - _F32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# Every draw takes a batch of keys [n, 2] (one row per key, as n calls of
# jax.random for one key each give them: the per-crop draws of a batch);
# the one-key functions are their first row.

def split_each(keys, num: int = 2) -> np.ndarray:
    """split(k, num) of every key of keys [n, 2] -> uint32[n, num, 2]."""
    keys = np.asarray(keys, _U32)
    hi, lo = _iota_2x32((int(num),))
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], hi, lo)
    return np.stack([b1, b2], axis=-1)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) -> uint32[num, 2]."""
    return split_each(_key(key)[None], num)[0]


def _bits_each(keys, shape) -> np.ndarray:
    """32 random bits per element and key: the xor of the hash's two
    words -> uint32[n, *shape]."""
    keys = np.asarray(keys, _U32)
    shape = tuple(shape)
    expand = (len(keys),) + (1,) * len(shape)
    if shape:
        hi, lo = _iota_2x32(shape)
    else:
        hi = lo = np.zeros((), _U32)
    b1, b2 = threefry2x32(keys[:, 0].reshape(expand),
                          keys[:, 1].reshape(expand), hi, lo)
    return np.asarray(b1 ^ b2, _U32)


def random_bits(key, shape=()) -> np.ndarray:
    """32 random bits per element: the xor of the hash's two words."""
    return _bits_each(_key(key)[None], shape)[0, ...]


def uniform_each(keys, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """uniform(k, shape, minval, maxval) of every key -> [n, *shape]."""
    return _uniform_bits(_bits_each(keys, shape), minval, maxval)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    return uniform_each(_key(key)[None], shape, minval, maxval)[0, ...]


def normal_each(keys, shape=()) -> np.ndarray:
    """normal(k, shape) of every key -> [n, *shape]: sqrt(2) *
    erfinv(uniform(nextafter(-1, 0), 1))."""
    u = uniform_each(keys, shape, np.nextafter(_F32(-1.0), _F32(0.0)), 1.0)
    return (_F32(np.sqrt(2)) * erfinv_f32(u)).astype(_F32)


def normal(key, shape=()) -> np.ndarray:
    """jax.random.normal(key, shape) in float32."""
    return normal_each(_key(key)[None], shape)[0, ...]


# XLA's ErfInv for float32 (M. Giles, "Approximating the erfinv function"),
# as XLA's CPU backend compiles it: log1p by its Cephes rational form for
# |x| < sqrt(2) - 1 and by its polynomial log of 1 + x beyond, and every
# multiply whose product feeds one add fused into an fma
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _log_f32(y):
    """XLA CPU's float32 log (Cephes polynomial) for positive normal y."""
    y = np.maximum(np.asarray(y, _F32), _F32(1.17549435e-38))
    bits = y.view(_U32)
    m = ((bits & _U32(0x7FFFFF)) | _U32(0x3F000000)).view(_F32)
    e = ((bits >> _U32(23)).astype(np.int32) - 127).astype(_F32) + _F32(1)
    small = m < _F32(0.707106781186547524)
    x = (m - _F32(1)) + np.where(small, m, _F32(0))
    e = e - np.where(small, _F32(1), _F32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y0 = _fma(_fma(x, _F32(p[0]), _F32(p[1])), x, _F32(p[2]))
    y1 = _fma(_fma(x, _F32(p[3]), _F32(p[4])), x, _F32(p[5]))
    y2 = _fma(_fma(x, _F32(p[6]), _F32(p[7])), x, _F32(p[8]))
    t = _fma(y0, x3, y1)
    t = _fma(t, x3, y2)
    s = _fma(t, x3, e * _F32(-2.12194440e-4))
    r = (x - x2 * _F32(0.5)) + s
    return _fma(e, _F32(0.693359375), r)


def _log1p_f32(x):
    """XLA's float32 log1p."""
    x = np.asarray(x, _F32)
    x2 = x * x
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, _F32(c))
    for c in _LOG1P_DEN:
        den = _fma(den, x, _F32(c))
    small = (x * x2) * (num / den)
    small = x + _fma(x2, _F32(-0.5), small)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    _log_f32(x + _F32(1))).astype(_F32)


def erfinv_f32(x) -> np.ndarray:
    """Single-precision inverse error function, evaluated in float32 in
    the order XLA's CPU backend evaluates it; +-1 map to +-inf."""
    x = np.asarray(x, _F32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        lg = _log1p_f32(x * -x)             # -w
        lt = lg > _F32(-5.0)
        w = np.where(lt, _F32(-2.5) - lg,
                     np.sqrt(-lg) + _F32(-3.0)).astype(_F32)
        p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0]))
        for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = _fma(p, w, np.where(lt, _F32(c_lt), _F32(c_ge)))
        p = np.where(np.abs(x) == _F32(1.0), _F32(np.inf), p)
        return np.asarray(x * p, _F32)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) in int32."""
    shape = tuple(shape)
    lo, hi = int(minval), int(maxval)
    if not -2 ** 31 <= lo <= hi < 2 ** 31:
        raise ValueError(f"randint bounds [{lo}, {hi}) outside int32")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(max(hi - lo, 1))
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
    return (np.int64(lo) + off.astype(np.int64)).astype(np.int32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) for a uint32 `data`: the hash of the
    counter words (0, data) under the key."""
    k = _key(key)
    b1, b2 = threefry2x32(k[0], k[1], np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([b1, b2]).astype(_U32)


def rng_seq(seed_or_key):
    """Infinite generator of fresh keys: key, sub = split(key) per step."""
    key = PRNGKey(seed_or_key) if isinstance(seed_or_key, (int, np.integer)) \
        else _key(seed_or_key)
    while True:
        key, sub = split(key)
        yield sub


# XLA CPU's float32 exp (Cephes): n = floor(x log2(e) + 1/2) clamped to
# [-127, 127], the remainder r = x - n ln2 in two fused steps, a degree-5
# polynomial in fmas, times 2^n built from the exponent bits
_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3,
          4.1665795894E-2, 1.6666665459E-1, 5.0000001201E-1)


def exp_f32(x) -> np.ndarray:
    """jnp.exp(x) for float32 as XLA's CPU backend evaluates it."""
    x = np.clip(np.asarray(x, _F32), _F32(-87.8), _F32(88.8))
    n = np.floor(_fma(x, _F32(1.44269504088896341), _F32(0.5)))
    n = np.clip(n, _F32(-127), _F32(127))
    r = _fma(_F32(-0.693359375), n, x)
    r = _fma(_F32(2.12194440e-4), n, r)
    z = _fma(r, _F32(_EXP_P[0]), _F32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        z = _fma(z, r, _F32(c))
    z = _F32(1) + _fma(z, r * r, r)
    two_n = ((n.astype(np.int32) + 127) << 23).astype(np.int32).view(_F32)
    return np.asarray(z * two_n, _F32)


# XLA's float32 lgamma (the Lanczos form of its CHLO expansion, g = 7,
# with log(t) as log(7.5) + log1p(z / 7.5) and z / 7.5 folded to
# z * (1 / 7.5)), for x >= 0.5: the reflection branch below 0.5 is left out
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156422894,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936895,
            -0.13857109526572011689554706,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def lgamma_f32(x) -> np.ndarray:
    """jax.lax.lgamma(x) for float32 x >= 0.5 as XLA's CPU backend
    evaluates it."""
    x = np.asarray(x, _F32)
    if np.any(x < _F32(0.5)):
        raise ValueError("lgamma_f32 takes x >= 0.5 (no reflection branch)")
    z = x + _F32(-1)
    log_t = _log1p_f32(z * _F32(1 / 7.5)) + _F32(np.log(7.5))
    r = _fma(((z + _F32(0.5)) - (z + _F32(7.5)) / log_t), log_t,
             _F32((np.log(2) + np.log(np.pi)) / 2))
    a = _F32(_LANCZOS[0]) / (z + _F32(1)) + _F32(1)
    for i, c in enumerate(_LANCZOS[1:], start=2):
        a = a + _F32(c) / (z + _F32(i))
    return np.asarray(r + _log_f32(a), _F32)


def _uniform_at(key, idx) -> np.ndarray:
    """uniform(key, shape) read at the flat positions idx of the shape."""
    idx = np.asarray(idx, np.uint64)
    b1, b2 = threefry2x32(key[0], key[1],
                          (idx >> np.uint64(32)).astype(_U32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return _uniform_bits(b1 ^ b2, 0.0, 1.0)


def _log_or_ninf(u):
    """XLA's float32 log of u in [0, 1), with log(0) = -inf."""
    with np.errstate(divide="ignore"):
        return np.where(u > 0, _log_f32(u), _F32(-np.inf)).astype(_F32)


def _poisson_knuth(key, lam) -> np.ndarray:
    """Knuth's sampler of jax.random's _poisson_knuth: one split(key) and
    one uniform field a round while any element still runs; an element
    runs while its sum of log-uniforms exceeds -lam. Only the running
    elements are drawn (each element's bits depend on its position
    alone), so the result equals the whole-field loop's."""
    k = np.zeros(lam.shape, np.int32)
    log_prod = np.zeros(lam.shape, _F32)
    neg = -lam
    run = np.flatnonzero(log_prod > neg)
    while run.size:
        key, sub = split(key)
        k[run] += 1
        log_prod[run] = log_prod[run] + _log_or_ninf(_uniform_at(sub, run))
        run = run[log_prod[run] > neg[run]]
    return k - 1


def _poisson_rejection(key, lam) -> np.ndarray:
    """Hörmann's transformed rejection as jax.random's _poisson_rejection
    runs it over the whole field: split(key, 3) a round, until every
    element has accepted once; `k_out = select(accept, k, k_out)` lets
    every later acceptance overwrite, so an element's result is its draw
    in the last round that accepted it, and the number of rounds (set by
    the slowest element) changes every element. Computed in two sparse
    passes: forward over the not-yet-accepted elements to find the
    number of rounds, then backward from the last round over the
    elements whose last acceptance is still unknown."""
    sq = np.sqrt(lam)
    log_lam = _log_f32(lam)
    b = _fma(sq, _F32(2.53), _F32(0.931))
    a = _fma(b, _F32(0.02483), _F32(-0.059))
    two_a = a * _F32(2)
    inv_alpha = _F32(1.1328) / _fma(sq, _F32(2.53), _F32(0.931) - _F32(3.4)) \
        + _F32(1.1239)
    v_r = _F32(0.9277) - _F32(3.6224) / _fma(sq, _F32(2.53),
                                             _F32(0.931) - _F32(2))

    def round_at(keys, idx):
        """(accept, k) of the elements idx in one round."""
        u = _uniform_at(keys[1], idx) + _F32(-0.5)
        v = _uniform_at(keys[2], idx)
        us = _F32(0.5) - np.abs(u)
        la, ai, bi = lam[idx], a[idx], b[idx]
        kk = np.floor(_fma(two_a[idx] / us + bi, u, la) + _F32(0.43))
        accept = (us >= _F32(0.07)) & (v <= v_r[idx])
        reject = (kk < 0) | ((us < _F32(0.013)) & (v > us))
        test = np.flatnonzero(~reject & ~accept)
        if test.size:
            j = idx[test]
            uu, vv = us[test], v[test]
            with np.errstate(divide="ignore"):
                s = _log_or_ninf((vv * inv_alpha[j])
                                 / (ai[test] / (uu * uu) + bi[test]))
            t = _fma(kk[test], log_lam[j], -la[test]) \
                - lgamma_f32(kk[test] + _F32(1))
            accept[test] = s <= t
        return accept, kk

    rounds = []
    todo = np.arange(lam.size)
    while todo.size:
        key, k0, k1 = split(key, 3)
        rounds.append((key, k0, k1))
        accept, _ = round_at(rounds[-1], todo)
        todo = todo[~accept]
    k_out = np.full(lam.shape, -1.0, _F32)
    todo = np.arange(lam.size)
    for keys in reversed(rounds):
        accept, kk = round_at(keys, todo)
        k_out[todo[accept]] = kk[accept]
        todo = todo[~accept]
        if not todo.size:
            break
    return k_out.astype(np.int32)


def poisson(key, lam) -> np.ndarray:
    """jax.random.poisson(key, lam) (int32, the shape of lam) as jax 0.9.0
    samples it: Knuth's method where lam < 10 (or NaN), Hörmann's
    transformed rejection elsewhere, both run over the whole field (the
    other branch's elements at lam 0 and 1e5), and 0 where lam == 0."""
    key = _key(key)
    lam = np.asarray(lam, _F32)
    flat = lam.reshape(-1)
    knuth = np.isnan(flat) | (flat < _F32(10))
    k1 = _poisson_knuth(key, np.where(knuth, flat, _F32(0)))
    k2 = _poisson_rejection(key, np.where(knuth, _F32(1e5), flat))
    out = np.where(knuth, k1, k2)
    return np.where(flat == 0, 0, out).astype(np.int32).reshape(lam.shape)
