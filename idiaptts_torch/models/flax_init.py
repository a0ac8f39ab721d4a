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
  truncated normal), ``orthogonal`` (QR of a normal draw), the embedding
  tables' ``variance_scaling`` normal, ``zeros`` and ``ones``.

The uniform bits are JAX's exactly; ``erf``, ``erfinv`` and the QR are
numpy's and scipy's in float64, rounded to float32, so a weight can sit
an ulp or so from JAX's.  :func:`rnn_dyn_params` gives the flax tree that
``models/convert.py`` loads into the port's model, for every layer type
but Custom; :func:`model_params` gives it for the composite models of
the intonation and VTLN pins too.
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


def _variance_scaling_normal(key, shape):
    """flax ``Embed``'s default ``variance_scaling(1, "fan_in", "normal",
    out_axis=0)`` for a (num, features) table: a normal draw times
    sqrt(1 / features)."""
    return normal(key, shape) * np.sqrt(np.float32(1.0 / shape[1]))


def _dense(root, path, in_dim, out_dim, bias=True, kernel=lecun_normal):
    """A flax Dense scope: ``kernel`` (the scope's first parameter) and a
    zero ``bias`` (its second)."""
    leaves = {"kernel": kernel(param_key(root, path, 1), (in_dim, out_dim))}
    if bias:
        leaves["bias"] = np.zeros(out_dim, np.float32)
    return leaves


def _recurrent(root, path, layer, in_dim):
    """The parameters of a ``_MaskedFlipRNN`` group; returns (tree,
    output width)."""
    F = layer.out_dim
    t = layer.layer_type
    tree = {}
    directions = ("fwd", "bwd") if layer.bidirectional else ("fwd",)
    for i in range(layer.num_layers):
        if t == "LSTM" and layer.bidirectional:
            scope = path + ("bi{}".format(i),)
            tree[scope[-1]] = {
                "Wx": lecun_normal(param_key(root, scope, 1),
                                   (2, in_dim, 4 * F)),
                "Wh": orthogonal(param_key(root, scope, 2), (2, F, 4 * F)),
                "b": np.zeros((2, 4 * F), np.float32)}
        elif t == "LSTM":
            scope = path + ("fwd{}".format(i),)
            tree[scope[-1]] = {
                "Wx": lecun_normal(param_key(root, scope, 1),
                                   (in_dim, 4 * F)),
                "Wh": orthogonal(param_key(root, scope, 2), (F, 4 * F)),
                "b": np.zeros(4 * F, np.float32)}
        else:
            for direction in directions:
                cell = path + ("{}{}".format(direction, i),)
                gates = ("r", "z", "n") if t == "GRU" else ("",)
                leaves = {}
                for g in gates:
                    leaves["i" + g] = _dense(root, cell + ("i" + g,),
                                             in_dim, F)
                    leaves["h" + g] = _dense(
                        root, cell + ("h" + g,), F, F, bias=(g == "n"),
                        kernel=orthogonal)
                tree[cell[-1]] = leaves
        in_dim = F * len(directions)
    return tree, in_dim


# The JAX handler's model is a NamedForwardWrapper around an adapter
# around RNNDyn: the scope path of every rnn_dyn parameter starts so.
_SCOPE_PREFIX = ("wrapped", "inner")


def rnn_dyn_params(config, seed=1234, scope=()):
    """The flax variables that the JAX package's
    ``ModularModelHandler.init_params`` draws for an rnn_dyn model
    ``config`` with ``seed``: ``{"params": {"wrapped": {"inner": {...}}}}``
    in numpy float32, with ``"batch_stats"`` (BatchNorm's running mean 0
    and variance 1) beside it when the model has BatchNorm groups.
    ``scope``: the path of the model inside a composite model (the
    returned tree starts there too).

    Every layer type draws as flax draws it: Dense, Conv and the VAE's
    Dense layers ``lecun_normal`` kernels and zero biases; LSTM ``Wx``
    lecun_normal, ``Wh`` orthogonal, ``b`` zeros; GRU ``ir``/``iz``/``in``
    and the simple cell's ``i`` lecun_normal with zero biases, the
    recurrent ``hr``/``hz``/``hn``/``h`` orthogonal (``hn``'s bias zero);
    embedding tables ``variance_scaling(1, fan_in, normal, out_axis=0)``;
    BatchNorm scale 1 and bias 0.  Custom groups raise: their draw is
    their module's own."""
    root = prng_key(seed)
    prefix = tuple(scope) + _SCOPE_PREFIX
    tree, stats = {}, {}
    num_groups = len(config.layer_configs)
    for emb in config.emb_configs:
        path = prefix + ("emb_" + str(emb.name),)
        tree[path[-1]] = {"embedding": _variance_scaling_normal(
            param_key(root, path, 1),
            (emb.num_embeddings, emb.embedding_dim))}
    in_dim = int(np.prod(config.in_dim))
    for g_idx, layer in enumerate(config.layer_configs):
        in_dim += sum(e.embedding_dim for e in config.emb_configs
                      if -1 in e.affected_layer_group_indices
                      or g_idx in e.affected_layer_group_indices
                      or g_idx - num_groups in e.affected_layer_group_indices)
        t = layer.layer_type
        name = "g{}_{}".format(g_idx, t)
        path = prefix + (name,)
        if t in ("Linear", "FC", "LIN") or t.startswith("Conv1d"):
            for i in range(layer.num_layers):
                scope = prefix + ("{}_{}".format(name, i),)
                if t.startswith("Conv1d"):
                    k = np.atleast_1d(layer.kernel_size)[0]
                    leaves = {
                        "kernel": lecun_normal(
                            param_key(root, scope, 1),
                            (int(k), in_dim // layer.groups, layer.out_dim)),
                        "bias": np.zeros(layer.out_dim, np.float32)}
                else:
                    leaves = _dense(root, scope, in_dim, layer.out_dim)
                tree[scope[-1]] = leaves
                in_dim = layer.out_dim
        elif t in ("LSTM", "GRU", "RNN"):
            tree[name], in_dim = _recurrent(root, path, layer, in_dim)
        elif t == "BatchNorm1d":
            tree[name] = {"scale": np.ones(in_dim, np.float32),
                          "bias": np.zeros(in_dim, np.float32)}
            stats[name] = {"mean": np.zeros(in_dim, np.float32),
                           "var": np.ones(in_dim, np.float32)}
        elif t == "Embedding":
            tree[name] = {"embedding": _variance_scaling_normal(
                param_key(root, path, 1),
                (layer.num_embeddings, layer.out_dim))}
            in_dim = layer.out_dim
        elif t == "VanillaVAE":
            tree[name] = {k: _dense(root, path + (k,), in_dim,
                                    layer.out_dim)
                          for k in ("mu", "logvar")}
            in_dim = layer.out_dim
        elif t == "Custom":
            raise NotImplementedError(
                "flax initial weights of a Custom group are its module's")
    variables = {"params": tree}
    if stats:
        variables["batch_stats"] = stats
    for collection in variables:
        node = variables[collection]
        for name in reversed(prefix):
            node = {name: node}
        variables[collection] = node
    return variables


def _merge(into, tree):
    for key, value in tree.items():
        if isinstance(value, dict) and isinstance(into.get(key), dict):
            _merge(into[key], value)
        else:
            into[key] = value
    return into


def model_params(config, seed=1234, scope=()):
    """The flax variables the JAX package draws for a model ``config``
    with ``seed``, for every model type a quality pin trains: an rnn_dyn
    model; ``NeuralFilters`` and ``PhraseNeuralFilters`` around one
    (the filters' poles, phases and the phrase bias are their
    deterministic initial values); ``Sequential`` of such modules and
    ``AllPassWarpLayer`` (each alpha layer a ``lecun_normal`` Dense of
    ``alpha_layer_in_dims[i]`` inputs and a zero bias).  Other types
    raise."""
    kind = type(config).__module__.rsplit(".", 1)[-1] + ":" \
        + type(config).__qualname__
    scope = tuple(scope)
    if kind == "rnn_dyn:RNNDyn.Config":
        return rnn_dyn_params(config, seed, scope)
    if kind == "intonation:NeuralFilters.Config":
        variables = model_params(config.atom_model_config, seed,
                                 scope + ("atom_model",))
        moduli = np.exp(-1.0 / (np.asarray(config.thetas) * 200)).astype(
            np.float32)
        filters = {"pole_logit": np.log(moduli / (1 - moduli))}
        if config.complex_poles:
            filters["phase"] = np.full(len(moduli), config.phase_init,
                                       np.float32)
        return _merge(variables, _nest(
            scope + ("intonation_filters",), filters))
    if kind == "intonation:PhraseNeuralFilters.Config":
        variables = model_params(config.neural_filters_config, seed,
                                 scope + ("neural_filters",))
        modulus = np.float32(np.exp(-1.0 / (config.phrase_theta_init * 200)))
        leaves = {"phrase_filter": {"pole_logit": np.log(
                      np.array([modulus / (1 - modulus)], np.float32))},
                  "phrase_bias": np.float32(config.phrase_bias_init)}
        return _merge(variables, _nest(scope, leaves))
    if kind == "named:Sequential.Config":
        variables = {"params": {}}
        for i, sub in enumerate(config.module_configs):
            _merge(variables, model_params(
                sub, seed, scope + ("modules_list_{}".format(i),)))
        return variables
    if kind == "vtln:AllPassWarpLayer.Config":
        root = prng_key(seed)
        dims = config.alpha_layer_in_dims \
            or (1,) * len(config.alpha_input_names)
        layers = {}
        for i, dim in enumerate(dims):
            name = "alpha_layer_{}".format(i)
            layers[name] = _dense(root, scope + ("all_pass_warp", name),
                                  int(dim), 1)
        return _nest(scope + ("all_pass_warp",), layers)
    raise NotImplementedError("no JAX initial draw for " + kind)


def _nest(path, leaves):
    """``{"params": {path[0]: {...: leaves}}}``."""
    node = leaves
    for name in reversed(path):
        node = {name: node}
    return {"params": node}
