"""The JAX package's initial weights, computed without JAX.

The JAX trainers draw a new model's parameters with flax from
``jax.random.PRNGKey(1234)`` (``idiaptts_tpu/train/handler.py:
init_params``).  A recipe whose scores are pinned (the quality pins of
``tests/integration/test_quality_pins.py``) is pinned for that one draw:
another draw of the same distributions trains to other scores.  This
module repeats the draw in numpy, so that the port can start such a
recipe where the JAX package starts it, on a machine without JAX:

- the threefry-2x32 counter hash and JAX's key derivation (``PRNGKey``,
  ``fold_in``, and ``random_bits`` in the partitionable layout that JAX
  uses by default);
- flax's key for each parameter: one ``fold_in`` of the SHA-1 of the
  parameter's scope path and its creation counter within the scope;
- the initializers the rnn_dyn model uses: ``lecun_normal`` (a
  truncated normal), ``orthogonal`` (QR of a normal draw) and ``zeros``.

The uniform bits are JAX's exactly; ``erf``, ``erfinv`` and the QR are
numpy's and scipy's in float64, rounded to float32, so a weight can sit
an ulp or so from JAX's.  :func:`rnn_dyn_params` gives the flax tree that
``models/convert.py`` loads into the port's model.
"""

import hashlib

import numpy as np
from scipy import special

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry-2x32 block hash of the counters (x0, x1) (uint32
    arrays) under ``key`` (two uint32), 20 rounds."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` for a seed below 2**32."""
    return np.array([0, seed], np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    y0, y1 = threefry2x32(key, np.array([0], np.uint32),
                          np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def random_bits(key, shape):
    """``jax.random.bits(key, shape)`` (uint32, partitionable layout): the
    hash of each element's 64-bit row-major index, its two words xored."""
    n = int(np.prod(shape, dtype=np.int64))
    index = np.arange(n, dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    minval, maxval = np.float32(minval), np.float32(maxval)
    return np.maximum(minval, floats * (maxval - minval) + minval)


def _erfinv32(u):
    return special.erfinv(u.astype(np.float64)).astype(np.float32)


def normal(key, shape):
    """``jax.random.normal`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2.0)) * _erfinv32(
        uniform(key, shape, lo, 1.0))


def truncated_normal(key, lower, upper, shape):
    """``jax.random.truncated_normal`` in float32."""
    sqrt2 = np.float32(np.sqrt(2.0))
    lower, upper = np.float32(lower), np.float32(upper)
    a = np.float32(special.erf(np.float64(lower / sqrt2)))
    b = np.float32(special.erf(np.float64(upper / sqrt2)))
    out = sqrt2 * _erfinv32(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf)))


def lecun_normal(key, shape):
    """flax ``lecun_normal()``: variance 1/fan_in, truncated at two
    standard deviations; fan_in = shape[-2] times the leading dims."""
    fan_in = shape[-2] * int(np.prod(shape[:-2], dtype=np.int64))
    std = np.float32(np.sqrt(1.0 / fan_in)) / np.float32(
        .87962566103423978)
    return truncated_normal(key, -2.0, 2.0, shape) * std


def orthogonal(key, shape):
    """flax ``orthogonal()``: the leading dims and rows flattened against
    the last axis, an orthonormal factor of a normal draw."""
    n_cols = shape[-1]
    n_rows = int(np.prod(shape, dtype=np.int64)) // n_cols
    matrix_shape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
    q, r = np.linalg.qr(normal(key, matrix_shape).astype(np.float64))
    q = q * np.sign(np.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).astype(np.float32)


def param_key(root, path, counter):
    """flax's key for the ``counter``-th parameter (from 1) created in the
    scope ``path``: one fold_in of the SHA-1 of the path's names and the
    counter's bytes."""
    digest = hashlib.sha1()
    for name in path:
        digest.update(name.encode("utf-8"))
    digest.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(digest.digest()[:4], "big"))


# The JAX handler's model is a NamedForwardWrapper around an adapter
# around RNNDyn: the scope path of every rnn_dyn parameter starts so.
_SCOPE_PREFIX = ("wrapped", "inner")


def rnn_dyn_params(config, seed=1234):
    """The flax parameter tree that the JAX package's
    ``ModularModelHandler.init_params`` draws for an rnn_dyn model
    ``config`` (Dense and bidirectional LSTM groups) with ``seed``:
    ``{"params": {"wrapped": {"inner": {...}}}}``, numpy float32."""
    root = prng_key(seed)
    tree = {}
    in_dim = config.in_dim
    for g_idx, layer in enumerate(config.layer_configs):
        t = layer.layer_type
        name = "g{}_{}".format(g_idx, t)
        if t in ("Linear", "FC", "LIN"):
            for i in range(layer.num_layers):
                path = _SCOPE_PREFIX + ("{}_{}".format(name, i),)
                # The bias (the scope's second parameter) is zeros.
                tree[path[-1]] = {
                    "kernel": lecun_normal(param_key(root, path, 1),
                                           (in_dim, layer.out_dim)),
                    "bias": np.zeros(layer.out_dim, np.float32)}
                in_dim = layer.out_dim
        elif t == "LSTM" and layer.bidirectional:
            F = layer.out_dim
            group = tree.setdefault(name, {})
            for i in range(layer.num_layers):
                path = _SCOPE_PREFIX + (name, "bi{}".format(i))
                group[path[-1]] = {
                    "Wx": lecun_normal(param_key(root, path, 1),
                                       (2, in_dim, 4 * F)),
                    "Wh": orthogonal(param_key(root, path, 2),
                                     (2, F, 4 * F)),
                    "b": np.zeros((2, 4 * F), np.float32)}
                in_dim = 2 * F
        else:
            raise NotImplementedError(
                "flax initial weights of layer type {} (bidirectional: {})"
                .format(t, layer.bidirectional))
    node = tree
    for name in reversed(_SCOPE_PREFIX):
        node = {name: node}
    return {"params": node}
