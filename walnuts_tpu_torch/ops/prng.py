"""The JAX package's threefry stream restated in PyTorch on raw key data.

Counterpart of ``walnuts_tpu/ops/prng.py`` plus the ``jax.random`` calls
the sampler makes (``key``, ``fold_in``, ``split``, ``uniform``,
``normal``, ``bernoulli``). Randomness is not a ``torch.Generator``: the
port draws exactly the numbers the reference draws from the same key, so
its chains can be compared with the reference's lane by lane.

Key layout. A key is its raw threefry key data, ``(..., 2)`` int32 holding
the bit patterns of JAX's ``uint32`` key data (``key.view(np.uint32)`` in
NumPy equals ``jax.random.key_data``). PyTorch's ``uint32`` has few
operations, so the plain arithmetic widens to int64 and masks to 32 bits;
the CUDA replay kernel reinterprets the same storage as ``uint32``.

Bit-exactness. ``split``, ``fold_in``, ``uniform`` and ``bernoulli`` are
integer ARX plus an exact bit transform, so they equal ``jax.random``
bitwise. ``normal`` goes through ``erf_inv``: :func:`erf_inv` restates
XLA's polynomial (and its ``log1p``) but XLA contracts some of the
multiply-adds into FMAs, so normals agree to a few ulp, not bitwise
(``tests/test_torch_prng.py`` states the bound).

``replay_split_chain`` is the deferred key-split replay of the batched
scheduler: its plain version runs here for CPU tensors, and CUDA tensors go
to the hand-written kernel in ``csrc/replay.cu``.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values —
    the arithmetic of ``walnuts_tpu/ops/prng.py::_threefry2x32`` and of
    jax's ``threefry2x32_p``."""

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & _M32

    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` as a (2,) int32 key."""
    seed = int(seed)
    hi, lo = (seed >> 32) & _M32, seed & _M32
    return _i32(torch.tensor([hi, lo], dtype=torch.int64, device=device))


def fold_in(key_data: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` (``threefry2x32(key, (hi, lo) of data)``),
    broadcast over ``data``: key (2,) and data (n,) give (n, 2)."""
    k = _u64(key_data)
    d = torch.as_tensor(data, dtype=torch.int64, device=key_data.device)
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], (d >> 32) & _M32, d & _M32)
    return _i32(torch.stack([x0, x1], dim=-1))


def split(key_data: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` under the partitionable lowering
    (``subkey_j = threefry2x32(key, 0, j)``): (..., 2) -> (..., num, 2)."""
    k = _u64(key_data)
    k0, k1 = k[..., 0, None], k[..., 1, None]
    j = torch.arange(num, dtype=torch.int64, device=key_data.device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(j), j)
    return _i32(torch.stack([x0, x1], dim=-1))


def counter_bits(key_data: torch.Tensor, shape):
    """The two threefry output words ``(x0, x1)`` for every element of
    ``shape`` (row-major counter), batched over the key's leading dims:
    the raw material of jax's ``random_bits`` under the partitionable
    lowering."""
    n = math.prod(shape)
    k = _u64(key_data)
    k0, k1 = k[..., 0, None], k[..., 1, None]
    j = torch.arange(n, dtype=torch.int64, device=key_data.device)
    x0, x1 = threefry2x32(k0, k1, (j >> 32) & _M32, j & _M32)
    out = key_data.shape[:-1] + tuple(shape)
    return x0.reshape(out), x1.reshape(out)


def uniform_from_bits(x0, x1, dtype) -> torch.Tensor:
    """jax's uniform [0, 1) bit transform: the mantissa is filled with
    random bits at exponent 0 and 1 is subtracted — 32 bits ``x0 ^ x1``
    for float32, 64 bits ``(x0 << 32) | x1`` for float64."""
    if dtype == torch.float64:
        # ((x0 << 32) | x1) >> 12 stays below 2^52: no uint64 needed
        mant = (x0 << 20) | (x1 >> 12)
        f = (mant | 0x3FF0000000000000).view(torch.float64)
    elif dtype == torch.float32:
        mant = (x0 ^ x1) >> 9
        f = (mant | 0x3F800000).to(torch.int32).view(torch.float32)
    else:
        raise ValueError(f"uniform supports float32 and float64, not {dtype}")
    return f - 1.0


def uniform(key_data: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1), batched over
    the key's leading dims. Bitwise equal to jax."""
    return uniform_from_bits(*counter_bits(key_data, shape), dtype)


# XLA's erf_inv polynomials (Giles, "Approximating the erfinv function"):
# float32 in w = -log1p(-x^2) around 2.5 / sqrt(w) - 3; float64 over three
# ranges of w.
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV_F64_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356,
)
_ERFINV_F64_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_ERFINV_F64_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221,
)
# XLA's log1p for |x| < sqrt(2) - 1 (a Cephes rational approximation)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    def poly(cs):
        r = torch.zeros_like(x)
        for c in cs:
            r = r * x + c
        return r

    x2 = x * x
    small = x + ((-0.5 * x2) + (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` on (-1, 1) for float32 and float64."""
    w = -_log1p_xla(-x * x)
    full = lambda c: torch.full_like(x, c)
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        lo_c, hi_c = _ERFINV_F32
        p = torch.where(lt, full(lo_c[0]), full(hi_c[0]))
        for a, b in zip(lo_c[1:], hi_c[1:]):
            p = torch.where(lt, full(a), full(b)) + p * w
        return p * x
    if x.dtype != torch.float64:
        raise ValueError(f"erf_inv supports float32 and float64, not {x.dtype}")
    lt_a, lt_b = w < 6.25, w < 16.0

    def coeff(i):
        c = full(_ERFINV_F64_LT_6_25[i])
        if i < 19:
            c = torch.where(lt_a, c, full(_ERFINV_F64_LT_16[i]))
        if i < 17:
            c = torch.where(lt_b, c, full(_ERFINV_F64_GE_16[i]))
        return c

    w = torch.where(lt_a, w - 3.125,
                    torch.sqrt(w) - torch.where(lt_b, full(3.25), full(5.0)))
    p = coeff(0)
    for i in range(1, 17):
        p = coeff(i) + p * w
    for i in range(17, 19):
        p = torch.where(lt_b, coeff(i) + p * w, p)
    for i in range(19, 23):
        p = torch.where(lt_a, coeff(i) + p * w, p)
    return p * x


def normal_from_bits(x0, x1, dtype) -> torch.Tensor:
    """jax's normal transform of random bits: ``sqrt(2) * erf_inv(u)``
    with ``u`` uniform on ``[nextafter(-1, 0), 1)`` (``_normal_real``)."""
    one = torch.tensor(1.0, dtype=dtype, device=x0.device)
    lo = torch.nextafter(-one, torch.zeros_like(one))
    u = uniform_from_bits(x0, x1, dtype)
    u = torch.maximum(u * (one - lo) + lo, lo)
    return torch.tensor(math.sqrt(2.0), dtype=dtype, device=x0.device) * erf_inv(u)


def normal(key_data: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``, batched over the key's
    leading dims."""
    return normal_from_bits(*counter_bits(key_data, shape), dtype)


def bernoulli_half(key_data: torch.Tensor, dtype) -> torch.Tensor:
    """``jax.random.bernoulli(key)`` (p = 0.5): one uniform of ``dtype``
    below one half. JAX takes the comparison dtype from the canonical
    float (float64 under x64, float32 otherwise); the port takes the
    sampler state's dtype, which agrees in both configurations the
    reference runs (float64 state under x64, float32 without)."""
    return uniform(key_data, (1,), dtype)[..., 0] < 0.5


# ---------------------------------------------------------------------------
# deferred key-split replay (kernel 1)
# ---------------------------------------------------------------------------


def replay_split_chain_plain(key_data, ku_data, n_ends, leaf_end_at):
    """Per lane: advance ``key`` through ``n_ends`` sequential splits
    (keeping subkey 0); at round ``leaf_end_at`` (1-based) latch subkey 1
    into ``ku``. Lanes with ``n_ends == 0`` pass through. The batched
    while loop of ``walnuts_tpu/core/batched.py:702-733``."""
    key_data, ku_data = key_data.clone(), ku_data.clone()
    for j in range(int(n_ends.max()) if n_ends.numel() else 0):
        ks = split(key_data)
        adv = (j < n_ends)[:, None]
        hit = adv & (leaf_end_at == j + 1)[:, None]
        ku_data = torch.where(hit, ks[:, 1], ku_data)
        key_data = torch.where(adv, ks[:, 0], key_data)
    return key_data, ku_data


def replay_split_chain(key_data, ku_data, n_ends, leaf_end_at):
    """The replay of :func:`replay_split_chain_plain`: CPU tensors take the
    plain version, CUDA tensors the kernel of ``csrc/replay.cu`` (one
    thread per lane, bitwise equal to the plain version). The arguments
    are checked on either device, so the CPU tests hold callers to what
    the kernel takes.

    ``key_data``/``ku_data``: (C, 2) int32; ``n_ends``/``leaf_end_at``:
    (C,) int32. Returns new ``(key_data, ku_data)``.
    """
    if key_data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"replay_split_chain: unsupported device {key_data.device}")
    c = key_data.shape[0]
    for name, t, shape in (("key_data", key_data, (c, 2)),
                           ("ku_data", ku_data, (c, 2)),
                           ("n_ends", n_ends, (c,)),
                           ("leaf_end_at", leaf_end_at, (c,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != key_data.device or not t.is_contiguous()):
            raise ValueError(
                f"replay_split_chain: {name} must be a contiguous int32 "
                f"{shape} tensor on {key_data.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}"
            )
    if key_data.device.type == "cpu":
        return replay_split_chain_plain(key_data, ku_data, n_ends, leaf_end_at)
    from walnuts_tpu_torch.ops import _cuda

    lib = _cuda.library("replay")
    key_out = torch.empty_like(key_data)
    ku_out = torch.empty_like(ku_data)
    if c:
        with torch.cuda.device(key_data.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.wt_replay_split_chain(
                key_data.data_ptr(), ku_data.data_ptr(), n_ends.data_ptr(),
                leaf_end_at.data_ptr(), key_out.data_ptr(), ku_out.data_ptr(),
                c, stream,
            )
        _cuda.check(err, "wt_replay_split_chain")
        replay_split_chain.launches += 1
    return key_out, ku_out


replay_split_chain.launches = 0


__all__ = [
    "bernoulli_half",
    "counter_bits",
    "erf_inv",
    "fold_in",
    "key",
    "normal",
    "normal_from_bits",
    "replay_split_chain",
    "replay_split_chain_plain",
    "split",
    "threefry2x32",
    "uniform",
    "uniform_from_bits",
]
