"""Named loss family: the port of ``idiaptts_tpu/models/losses.py``.

Dict-protocol losses with sequence masks and reductions
(mean_per_frame / mean_per_sample / mean / sum / none), ``start_step``
and ``loss_weight``.  Each loss function maps ``(pred, target,
data_dict, **kwargs)`` to a per-element tensor; :class:`NamedLoss` reads
predictions and targets by name from the dict, masks with ``seq_mask``
and reduces.  All losses are plain differentiable PyTorch.
"""

import inspect
import math

import numpy as np
import torch
import torch.nn.functional as F


def _as_tensor(x, like=None):
    if torch.is_tensor(x):
        return x
    device = like.device if like is not None else None
    return torch.as_tensor(np.asarray(x), device=device)


class NamedLoss:
    """Wrapper binding a loss function to named inputs/targets."""

    REDUCTIONS = ("mean_per_frame", "mean_per_sample", "mean", "sum",
                  "none")

    class Config:
        def __init__(self, name, type_, input_names, seq_mask=None,
                     reduction="mean_per_frame", loss_weight=1.0,
                     start_step=0, **kwargs):
            self.name = name
            self.type = type_
            self.input_names = tuple(input_names)
            self.seq_mask = seq_mask
            self.reduction = reduction
            self.loss_weight = loss_weight
            self.start_step = start_step
            self.kwargs = kwargs

        def create_loss(self):
            return NamedLoss(self)

    _FUNCTIONS = {}

    @classmethod
    def register(cls, name):
        def deco(fn):
            cls._FUNCTIONS[name] = fn
            return fn
        return deco

    def __init__(self, config):
        self.config = config
        self.name = config.name
        if config.type not in self._FUNCTIONS:
            raise NotImplementedError("Unknown loss type " + config.type)
        self.fn = self._FUNCTIONS[config.type]
        self._wants_step = "step" in inspect.signature(self.fn).parameters

    def __call__(self, data_dict, step=0):
        cfg = self.config
        pred = _as_tensor(data_dict[cfg.input_names[0]])
        target = _as_tensor(data_dict[cfg.input_names[1]], pred) \
            if len(cfg.input_names) > 1 else None
        extra = {"step": step} if self._wants_step else {}
        per_elem = self.fn(pred, target, data_dict, **extra, **cfg.kwargs)
        mask = None
        if cfg.seq_mask is not None:
            mask = _as_tensor(data_dict[cfg.seq_mask], per_elem).to(
                per_elem.dtype)
            while mask.dim() < per_elem.dim():
                mask = mask[..., None]
            if mask.shape[-1] != per_elem.shape[-1] and mask.shape[-1] == 1:
                mask = mask[..., :1]
            mask = mask.expand(per_elem.shape[:mask.dim()]
                               + per_elem.shape[mask.dim():])
            per_elem = per_elem * mask
        loss = self._reduce(per_elem, mask, cfg.reduction)
        active = 1.0 if step >= cfg.start_step else 0.0
        return loss * cfg.loss_weight * active

    @staticmethod
    def _reduce(per_elem, mask, reduction):
        """mean_per_frame = (sum over batch+time / valid frames) averaged
        over features; mean_per_sample = (sum over time / sample length)
        averaged over batch and features.  Both become 'mean' without a
        seq_mask."""
        if reduction == "none":
            return per_elem
        if reduction == "sum":
            return per_elem.sum()
        if reduction in ("mean_per_frame", "mean_per_sample") \
                and mask is None:
            reduction = "mean"
        if reduction == "mean":
            if mask is None:
                return per_elem.mean()
            return per_elem.sum() / torch.clamp(mask.sum(), min=1.0)
        if reduction == "mean_per_frame":
            frame_loss = per_elem.mean(dim=-1)
            frame_mask = mask.amax(dim=-1)
            return frame_loss.sum() / torch.clamp(frame_mask.sum(), min=1.0)
        if reduction == "mean_per_sample":
            inner = tuple(range(1, per_elem.dim() - 1))
            sample_loss = per_elem.sum(dim=inner).mean(dim=-1)
            sample_count = mask.amax(dim=-1).sum(
                dim=tuple(range(1, mask.dim() - 1)))
            return (sample_loss / torch.clamp(sample_count, min=1.0)).mean()
        raise NotImplementedError(reduction)


@NamedLoss.register("MSELoss")
def _mse(pred, target, data_dict):
    return (pred - target) ** 2


@NamedLoss.register("L1Loss")
def _l1(pred, target, data_dict):
    return torch.abs(pred - target)


@NamedLoss.register("CrossEntropyLoss")
def _ce(pred, target, data_dict):
    """pred: (..., C) logits; target: (...,) class ids or (..., 1)."""
    if target.dim() == pred.dim():
        target = target[..., 0]
    log_probs = F.log_softmax(pred, dim=-1)
    return -torch.gather(log_probs, -1, target.long()[..., None])


@NamedLoss.register("BCELoss")
def _bce(pred, target, data_dict, from_logits=False):
    if from_logits:
        pred = torch.sigmoid(pred)
    eps = 1e-7
    pred = torch.clamp(pred, eps, 1 - eps)
    return -(target * torch.log(pred) + (1 - target) * torch.log(1 - pred))


@NamedLoss.register("WMSELoss")
def _wmse(pred, target, data_dict, weights=None, weight=1.0,
          weighted_indices=None, decision_index_weight=None):
    """MSE with per-feature-index weighting."""
    err = (pred - target) ** 2
    if weights is not None:
        err = err * _as_tensor(weights, err).to(err.dtype)
    elif weighted_indices is not None:
        w = np.ones(pred.shape[-1], np.float32)
        for idx in np.atleast_1d(weighted_indices):
            w[int(idx)] = weight
        err = err * _as_tensor(w, err)
    return err


@NamedLoss.register("L1WeightedVUVMSELoss")
def _l1_weighted_vuv(pred, target, data_dict, weight_unvoiced=0.5,
                     vuv_index=1, decision_index_weight=1.0):
    """L1 on lf0 weighted by the target's voicing, plus MSE on the VUV
    decision; pred/target are [lf0, vuv]."""
    lf0_err = torch.abs(pred[..., :vuv_index] - target[..., :vuv_index])
    vuv_target = target[..., vuv_index:vuv_index + 1]
    lf0_err = lf0_err * (vuv_target + (1 - vuv_target) * weight_unvoiced)
    vuv_err = (pred[..., vuv_index:vuv_index + 1] - vuv_target) ** 2 \
        * decision_index_weight
    return torch.cat([lf0_err, vuv_err], dim=-1)


@NamedLoss.register("WeightedNonzeroMSELoss")
def _weighted_nonzero_mse(pred, target, data_dict, weight_zero=0.1,
                          weight_non_zero=1.0):
    """Class-imbalance weighting for sparse spike targets."""
    err = (pred - target) ** 2
    is_nonzero = (torch.abs(target) > 1e-8).to(err.dtype)
    return err * (is_nonzero * weight_non_zero
                  + (1 - is_nonzero) * weight_zero)


@NamedLoss.register("VAEKLDLoss")
def _vae_kld(pred, target, data_dict, step=0, annealing_steps=0,
             annealing_start=0):
    """KLD of the VAE posterior (dict entries ``vae_mu``, ``vae_logvar``)
    against N(0, I), with linear annealing."""
    mu = _as_tensor(data_dict["vae_mu"], pred)
    logvar = _as_tensor(data_dict["vae_logvar"], pred)
    kld = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar))
    if annealing_steps:
        anneal = min(max((float(step) - annealing_start)
                         / float(annealing_steps), 0.0), 1.0)
        kld = kld * anneal
    return kld


@NamedLoss.register("OneHotCrossEntropyLoss")
def _one_hot_ce(pred, target, data_dict, shift=0):
    """CE with one-hot targets and an optional target shift, zero-padded
    (a wrapped-around one-hot would score the tail against the start)."""
    if shift:
        target = torch.cat([target[..., shift:, :],
                            torch.zeros_like(target[..., :shift, :])],
                           dim=-2)
    log_probs = F.log_softmax(pred, dim=-1)
    return -(target * log_probs).sum(dim=-1, keepdim=True)


@NamedLoss.register("DiscretizedMixtureLogisticLoss")
def _dmol(pred, target, data_dict, num_classes=256, log_scale_min=-7.0):
    """Mixture-of-logistics NLL for raw waveforms.  pred: (..., 3*K)
    [logit_probs, means, log_scales]; target in [-1, 1] (..., 1)."""
    K = pred.shape[-1] // 3
    logit_probs = pred[..., :K]
    means = pred[..., K:2 * K]
    log_scales = torch.clamp(pred[..., 2 * K:], min=log_scale_min)
    t = target.expand(means.shape)
    inv_s = torch.exp(-log_scales)
    half = 1.0 / (num_classes - 1)
    plus = torch.sigmoid(inv_s * (t - means + half))
    minus = torch.sigmoid(inv_s * (t - means - half))
    log_prob = torch.log(torch.clamp(plus - minus, 1e-12, 1.0))
    log_cdf_plus = F.logsigmoid(inv_s * (t - means + half))
    log_one_minus_cdf = F.logsigmoid(-inv_s * (t - means - half))
    log_prob = torch.where(t < -0.999, log_cdf_plus,
                           torch.where(t > 0.999, log_one_minus_cdf,
                                       log_prob))
    log_prob = log_prob + F.log_softmax(logit_probs, dim=-1)
    return -torch.logsumexp(log_prob, dim=-1, keepdim=True)


@NamedLoss.register("UnWeightedAccuracy")
def _unweighted_accuracy(pred, target, data_dict, num_classes=None):
    """Class-balanced error rate as a 'loss': the mean over classes of
    per-class error rates, padded frames excluded via ``_seq_mask``.  A
    constant per-element field: use a mean-family reduction."""
    if target.dim() == pred.dim():
        target = target[..., 0]
    pred_cls = torch.argmax(pred, dim=-1)
    valid = data_dict.get("_seq_mask")
    if valid is not None:
        valid = (_as_tensor(valid, pred)[..., 0] > 0.5).expand(target.shape)
    else:
        valid = torch.ones(target.shape, dtype=torch.bool,
                           device=target.device)
    C = num_classes or pred.shape[-1]
    errs = []
    for c in range(C):
        in_class = ((target == c) & valid).to(torch.float32)
        wrong = ((pred_cls != c) & (target == c) & valid).to(torch.float32)
        errs.append(wrong.sum() / torch.clamp(in_class.sum(), min=1.0))
    err = torch.stack(errs).mean()
    return err.expand(target.shape + (1,))


def _gamma_kernel(theta, k=6, frame_rate=200, length=100):
    t = np.arange(1, length + 1) / frame_rate
    g = t ** (k - 1) * np.exp(-t / theta) / (theta ** k * math.gamma(k))
    norm = np.linalg.norm(g)
    return (g / norm if norm > 0 else g).astype(np.float32)


@NamedLoss.register("AtomLoss")
def _atom_loss(pred, target, data_dict, thetas=(0.03, 0.06, 0.09, 0.12,
                                                0.15), k=6, frame_rate=200,
               kernel_length=100):
    """Spike loss convolved with gamma atom envelopes (a causal depthwise
    convolution per theta track) before the MSE."""
    kernels = np.stack([_gamma_kernel(t, k, frame_rate, kernel_length)
                        for t in thetas])                # (Th, L)
    num = len(thetas)
    kern = _as_tensor(kernels, pred).to(pred.dtype).flip(-1)[:, None, :]
    L = kernel_length

    def envelope(x):
        xt = F.pad(x.transpose(-1, -2), (L - 1, 0))      # (B, Th, T+L-1)
        return F.conv1d(xt, kern, groups=num).transpose(-1, -2)

    diff = envelope(pred[..., :num]) - envelope(target[..., :num])
    return diff ** 2


@NamedLoss.register("WeightedNonzeroWMSEAtomLoss")
def _weighted_nonzero_wmse_atom(pred, target, data_dict, weight_zero=0.1,
                                weight_non_zero=1.0, weight_vuv=1.0,
                                vuv_index=-1):
    """Sparse-spike weighting on the amplitude tracks plus a weight_vuv
    error on the VUV flag column."""
    err = (pred - target) ** 2
    is_nonzero = (torch.abs(target) > 1e-8).to(err.dtype)
    spike_w = is_nonzero * weight_non_zero + (1 - is_nonzero) * weight_zero
    is_vuv = torch.zeros(pred.shape[-1], dtype=err.dtype, device=err.device)
    is_vuv[vuv_index] = 1.0
    return err * (spike_w * (1.0 - is_vuv) + weight_vuv * is_vuv)
