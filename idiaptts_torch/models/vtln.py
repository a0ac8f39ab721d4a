"""Neural vocal tract length normalisation (VTLN) by all-pass warping:
the port of ``idiaptts_tpu/models/vtln.py``.

- :func:`gen_w_matrix_3d` (numpy, cached): the polynomial coefficient
  tensor W (n, n, 2n) of the all-pass warp matrix, M(α)[r, c] =
  Σ_k W[r, c, k] α^k, built exactly by the recursion on polynomial
  coefficients.
- :func:`get_warp_matrix` (one einsum of W with the powers of α),
  :func:`combine_warping_parameters` ((a1 + a2) / (1 + a1·a2)),
  :func:`all_pass_warp` (every block of n coefficients warped by the
  frame's matrix, c0-type entries halved before and doubled after).
- :func:`grad_scale`: the identity forward, the gradient scaled by λ
  backward (a ``torch.autograd.Function``, the JAX package's
  ``jax.custom_vjp``).
- :class:`AllPassWarpLayer`: per-frame α from one float32 Dense + tanh
  per alpha input times its range, denormalise, warp, renormalise; the
  dict module of :class:`AllPassWarpLayer.Config` reads the pre-net
  output and the alpha inputs by name and writes the warped features
  and the α.

Everything is float32 (the JAX package asks for ``Precision.HIGHEST``;
keep TF32 off on the card).  The warp matrix sums 2n powers of α times
polynomial coefficients that reach 1e11 at n = 20 and cancel, so the
roundings of the powers and of the sum move its entries by a few 1e-5.
At n = 60 the float32 coefficients overflow (the polynomial tensor holds
inf, the matrices NaN), in the JAX package as here.  Parameter names
follow the flax tree (``all_pass_warp.alpha_layer_<i>.kernel`` (d_i,
1), ``.bias``).  The JAX
package infers each alpha layer's input width from the data; the port's
config carries it (``alpha_layer_in_dims``, default 1 each), and the
VTLN trainers set it from their data.
"""

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.named import default_generator, merge_inputs
from idiaptts_torch.models.rnn_dyn import _Dense


@lru_cache(maxsize=None)
def gen_w_matrix_3d(n):
    """Polynomial coefficient tensor W (n, n, 2n) of the warp matrix,
    by m[r][c] = m[r-1][c-1] + α (m[r-1][c] - m[r][c-1]) with
    m[r][0] = α^r, carried out on polynomial coefficients (exact)."""
    max_poly = 2 * n
    W = np.zeros((n, n, max_poly))
    W[0, 0, 0] = 1.0
    for r in range(1, n):
        if r < max_poly:
            W[r, 0, r] = 1.0
    for c in range(1, n):
        for r in range(1, n):
            poly = np.copy(W[r - 1, c - 1])
            shift = np.zeros(max_poly)
            diff = W[r - 1, c] - W[r, c - 1]
            shift[1:] = diff[:-1]
            W[r, c] = poly + shift
    return W.astype(np.float32)


def alpha_powers(alphas, max_polynomial):
    """(..., 1) alphas -> (..., max_polynomial) [1, a, a², ...]."""
    a = torch.cumprod(alphas.expand(alphas.shape[:-1]
                                    + (max_polynomial - 1,)), dim=-1)
    return torch.cat([torch.ones_like(alphas), a], dim=-1)


def get_warp_matrix(alphas, n):
    """alphas (..., 1) -> warp matrices (..., n, n)."""
    W = torch.as_tensor(gen_w_matrix_3d(n), device=alphas.device)
    return torch.einsum("ijk,...k->...ij", W, alpha_powers(alphas, 2 * n))


def combine_warping_parameters(alphas):
    """Composition law of successive all-pass warps:
    (a1 + a2) / (1 + a1·a2)."""
    if isinstance(alphas, (list, tuple)):
        out = alphas[0]
        for a in alphas[1:]:
            out = (out + a) / (1.0 + out * a)
        return out
    return alphas


def all_pass_warp(features, alphas, warp_matrix_size):
    """Warp cepstral features (B, T, K·n) by per-frame alphas (B, T, 1):
    each block of n coefficients by the frame's matrix, the first
    coefficient of the first three blocks halved before and doubled
    after."""
    n = warp_matrix_size
    B, T, D = features.shape
    num_blocks = D // n
    warp = get_warp_matrix(alphas, n)
    c0_scale = torch.ones(D, device=features.device)
    c0_scale[torch.arange(0, min(3 * n, D), n)] = 0.5
    x = features * c0_scale
    blocks = x[..., :num_blocks * n].reshape(B, T, num_blocks, n)
    warped = torch.einsum("btkn,btnm->btkm", blocks, warp)
    out = warped.reshape(B, T, num_blocks * n)
    if D > num_blocks * n:
        out = torch.cat([out, x[..., num_blocks * n:]], dim=-1)
    return out / c0_scale


class _GradScale(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, lmbda):
        ctx.lmbda = lmbda
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.lmbda, None


def grad_scale(x, lmbda):
    """Identity forward; the gradient scaled by ``lmbda`` backward."""
    return _GradScale.apply(x, lmbda)


class AllPassWarpLayer(nn.Module):
    """Trainable VTLN layer: per-frame alphas from the alpha inputs,
    denormalise the cepstra, warp, renormalise."""

    def __init__(self, warp_matrix_size, alpha_layer_in_dims, alpha_ranges,
                 mean=None, std_dev=None, grad_lambda=200.0):
        super().__init__()
        self.warp_matrix_size = warp_matrix_size
        self.alpha_ranges = tuple(alpha_ranges)
        self.grad_lambda = grad_lambda
        for i, dim in enumerate(alpha_layer_in_dims):
            self.add_module("alpha_layer_{}".format(i),
                            _Dense(int(dim), 1, dtype=None))
        self.num_alpha_layers = len(alpha_layer_in_dims)
        if mean is not None:
            self.register_buffer("mean", torch.as_tensor(
                np.asarray(mean, np.float32)), persistent=False)
            self.register_buffer("std_dev", torch.as_tensor(
                np.asarray(std_dev, np.float32)), persistent=False)
        else:
            self.mean = self.std_dev = None

    def forward(self, features, alpha_inputs):
        """features (B, T, D); alpha_inputs: list of (B, T, d_i).
        Returns (warped (B, T, D), alphas (B, T, 1))."""
        alphas = []
        for i, (inp, rng) in enumerate(zip(alpha_inputs, self.alpha_ranges)):
            pre = getattr(self, "alpha_layer_{}".format(i))(inp)
            alphas.append(grad_scale(torch.tanh(pre) * rng,
                                     self.grad_lambda))
        combined = combine_warping_parameters(alphas)
        x = features
        if self.mean is not None:
            x = x * self.std_dev + self.mean
        warped = all_pass_warp(x, combined, self.warp_matrix_size)
        if self.mean is not None:
            warped = (warped - self.mean) / self.std_dev
        return warped, combined

    class Config(ModelConfig):
        def __init__(self, warp_matrix_size=None, alpha_ranges=(0.2,),
                     alpha_input_names=(), mean=None, std_dev=None,
                     grad_lambda=200.0, alpha_layer_in_dims=None, **kwargs):
            super().__init__(**kwargs)
            self.warp_matrix_size = warp_matrix_size
            self.alpha_ranges = tuple(alpha_ranges)
            self.alpha_input_names = tuple(alpha_input_names)
            self.mean = mean
            self.std_dev = std_dev
            self.grad_lambda = grad_lambda
            self.alpha_layer_in_dims = alpha_layer_in_dims

        def create_model(self, generator=None):
            module = _AllPassWarpDictModule(self)
            generator = default_generator(generator)
            for layer in module.all_pass_warp.children():
                layer.reset_parameters(generator)
            return module

        def all_input_names(self):
            return tuple(self.input_names or ()) \
                + tuple(self.alpha_input_names or ())


class _AllPassWarpDictModule(nn.Module):
    """Dict protocol: reads the pre-net output and the alpha inputs by
    name, writes the warped output and the alphas (under the second
    output name, else ``alphas``)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        dims = getattr(config, "alpha_layer_in_dims", None) \
            or (1,) * len(config.alpha_input_names)
        self.all_pass_warp = AllPassWarpLayer(
            config.warp_matrix_size, dims, config.alpha_ranges,
            config.mean, config.std_dev, config.grad_lambda)

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        cfg = self.config
        features = merge_inputs(data_dict, cfg.input_names)
        T = features.shape[1]
        alpha_inputs = []
        for name in cfg.alpha_input_names:
            inp = torch.as_tensor(data_dict[name])
            if inp.dim() == 2:
                inp = inp[:, None, :]
            if inp.shape[1] != T:
                # An utterance-level input padded along time by the
                # collate: frame 0 broadcast.
                inp = inp[:, :1].expand(inp.shape[0], T, inp.shape[-1])
            alpha_inputs.append(inp.to(torch.float32))
        warped, alphas = self.all_pass_warp(features, alpha_inputs)
        out = dict(data_dict)
        out[cfg.output_names[0]] = warped
        out[cfg.output_names[1] if len(cfg.output_names) > 1
            else "alphas"] = alphas
        return out
