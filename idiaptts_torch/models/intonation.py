"""GCR intonation filters: the port of ``idiaptts_tpu/models/intonation.py``.

Trainable second-order IIR filter banks (``CriticalFilterBank``: a
critically damped double real pole; ``ComplexFilterBank``: a conjugate
complex pole pair) with the learned-pole output normalisation
polynomial, and the end-to-end LF0 models built on an atom model
(``NeuralFilters``) and on a flat model plus a phrase filter and bias
(``PhraseNeuralFilters``).

The recurrence y[n] = x[n] + a1·y[n-1] + a2·y[n-2] is a step loop over
time in plain PyTorch on every device, float32 values with the JAX
scan's sum order and roundings (``(x_t + a1·y1) + a2·y2``, each
multiply-add rounded once, as XLA's fused multiply-adds round; the JAX
package runs it as an XLA scan, with no Pallas kernel).  On the card it
is host-bound: a few launches a frame.  The output gain's polynomial in
the pole modulus nearly cancels (gains of 0.01-0.1 from terms near 50),
so a one-ulp difference of XLA's ``exp`` from PyTorch's moves a gain by
up to 1e-4 relative.

Parameter names follow the flax tree: ``intonation_filters.pole_logit``
and ``.phase``, ``phrase_filter.pole_logit``, ``phrase_bias``, and the
atom model under ``atom_model`` (``neural_filters.atom_model`` in the
phrase model).
"""

import numpy as np
import torch
from torch import nn

from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.named import default_generator

# Output normalisation polynomial in the filter modulus.
_NORM_WEIGHTS = np.array([38.43190559738741, -50.05233847007584,
                          25.07626762013403, 3.1930363795157106],
                         np.float32)
_NORM_BIAS = np.float32(48.95299158714191)


def theta_to_modulus(thetas, fs=200):
    return np.exp(-1.0 / (np.asarray(thetas) * fs))


def modulus_to_theta(modulus, fs=200):
    return -1.0 / (fs * np.log(np.asarray(modulus)))


def _modulus_normalisation(modulus):
    """Scalar gain per filter from the learned modulus: the polynomial
    [r, e^r, r², e^2r]·w + b.  Its terms nearly cancel (gains of 0.01 to
    0.1 from terms near 50), so the dot product repeats XLA's rounding:
    a fused multiply-add chain in term order, each step rounded once to
    float32 (emulated in float64, exact for these products)."""
    feats = torch.stack([modulus, torch.exp(modulus), modulus ** 2,
                         torch.exp(modulus) ** 2], dim=-1).to(torch.float64)
    weights = torch.as_tensor(_NORM_WEIGHTS.astype(np.float64),
                              device=modulus.device)
    acc = (feats[..., 0] * weights[0]).to(torch.float32)
    for k in range(1, 4):
        acc = (feats[..., k] * weights[k] + acc.to(torch.float64)).to(
            torch.float32)
    return acc + float(_NORM_BIAS)


def _iir2_scan(x, a1, a2):
    """Bank of second-order IIR filters: y[n] = x[n] + a1·y[n-1] +
    a2·y[n-2]; x (B, T, F), a1/a2 (F,) -> y (B, T, F).  XLA compiles the
    step to two fused multiply-adds, fma(a2, y2, fma(a1, y1, x)), each
    rounded once to float32; the step repeats that in float64 (exact
    products) and rounds after each addition."""
    a1 = a1.to(torch.float64)
    a2 = a2.to(torch.float64)
    y1 = x.new_zeros(x.shape[0], x.shape[2])
    y2 = y1
    ys = []
    for x_t in x.unbind(1):
        y = (a1 * y1 + x_t).to(torch.float32)
        y = (a2 * y2 + y).to(torch.float32)
        ys.append(y)
        y1, y2 = y, y1
    return torch.stack(ys, dim=1)


def _logit(moduli):
    init = np.asarray(moduli, np.float32)
    return torch.from_numpy(np.log(init / (1 - init)).astype(np.float32))


class CriticalFilterBank(nn.Module):
    """Critically damped double-real-pole bank: poles at (r, r) ->
    a1 = 2r, a2 = -r²; r = sigmoid(pole_logit)."""

    def __init__(self, init_moduli):
        super().__init__()
        self.pole_logit = nn.Parameter(_logit(init_moduli))

    def forward(self, x, sum_filters=True):
        r = torch.sigmoid(self.pole_logit)
        y = _iir2_scan(x, 2.0 * r, -(r ** 2))
        y = y * _modulus_normalisation(r)
        return y.sum(dim=-1, keepdim=True) if sum_filters else y


class ComplexFilterBank(nn.Module):
    """Conjugate complex pole pair bank: poles r·e^{±iφ} ->
    a1 = 2r·cos(φ), a2 = -r²."""

    def __init__(self, init_moduli, phase_init=0.0):
        super().__init__()
        self.pole_logit = nn.Parameter(_logit(init_moduli))
        self.phase = nn.Parameter(torch.full((len(init_moduli),),
                                             float(phase_init)))

    def forward(self, x, sum_filters=True):
        r = torch.sigmoid(self.pole_logit)
        y = _iir2_scan(x, 2.0 * r * torch.cos(self.phase), -(r ** 2))
        y = y * _modulus_normalisation(r)
        return y.sum(dim=-1, keepdim=True) if sum_filters else y


class NeuralFilters(nn.Module):
    """End-to-end LF0 model: the atom model gives [amps..., pos, vuv]
    frames; the filter bank turns the amplitude spikes into the LF0
    curve.  Writes ``pred_intonation`` = [lf0, vuv, amps...]."""

    def __init__(self, atom_model, thetas, complex_poles=True,
                 phase_init=0.0):
        super().__init__()
        self.atom_model = atom_model
        self.num_thetas = len(thetas)
        moduli = tuple(theta_to_modulus(np.asarray(thetas)))
        self.intonation_filters = ComplexFilterBank(moduli, phase_init) \
            if complex_poles else CriticalFilterBank(moduli)

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        out = self.atom_model(data_dict, lengths=lengths, training=training,
                              **kwargs)
        atoms_out = out[self._atom_output_name(out)]
        amps = atoms_out[..., :self.num_thetas]
        vuv = atoms_out[..., -1:]
        lf0 = self.intonation_filters(amps)
        out = dict(out)
        out["pred_intonation"] = torch.cat([lf0, vuv, amps], dim=-1)
        return out

    @staticmethod
    def _atom_output_name(out):
        for key in ("pred_atoms", "pred"):
            if key in out:
                return key
        raise KeyError("Atom model output not found in dict.")

    class Config(ModelConfig):
        def __init__(self, atom_model_config=None, thetas=(),
                     complex_poles=True, phase_init=0.0, **kwargs):
            super().__init__(**kwargs)
            self.atom_model_config = atom_model_config
            self.thetas = tuple(thetas)
            self.complex_poles = complex_poles
            self.phase_init = phase_init

        def create_model(self, generator=None):
            return NeuralFilters(
                self.atom_model_config.create_model(
                    default_generator(generator)),
                self.thetas, self.complex_poles, self.phase_init)


class PhraseNeuralFilters(nn.Module):
    """NeuralFilters plus a trainable phrase component: one critically
    damped filter over the summed amplitudes plus a bias, added to the
    LF0.  Writes ``pred_intonation_phrase`` = [lf0, vuv, amps...]."""

    def __init__(self, neural_filters, phrase_theta_init=0.05,
                 phrase_bias_init=4.5):
        super().__init__()
        self.neural_filters = neural_filters
        self.phrase_filter = CriticalFilterBank(
            (float(theta_to_modulus(phrase_theta_init)),))
        self.phrase_bias = nn.Parameter(torch.tensor(
            float(phrase_bias_init), dtype=torch.float32))

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        out = self.neural_filters(data_dict, lengths=lengths,
                                  training=training, **kwargs)
        e2e = out["pred_intonation"]
        lf0_flat, vuv, amps = e2e[..., :1], e2e[..., 1:2], e2e[..., 2:]
        phrase = self.phrase_filter(amps.sum(dim=-1, keepdim=True))
        lf0 = lf0_flat + phrase + self.phrase_bias
        out = dict(out)
        out["pred_intonation_phrase"] = torch.cat([lf0, vuv, amps], dim=-1)
        return out

    class Config(ModelConfig):
        def __init__(self, neural_filters_config=None,
                     phrase_theta_init=0.05, phrase_bias_init=4.5,
                     **kwargs):
            super().__init__(**kwargs)
            self.neural_filters_config = neural_filters_config
            self.phrase_theta_init = phrase_theta_init
            self.phrase_bias_init = phrase_bias_init

        def create_model(self, generator=None):
            return PhraseNeuralFilters(
                self.neural_filters_config.create_model(generator),
                self.phrase_theta_init, self.phrase_bias_init)
