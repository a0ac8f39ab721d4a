"""Training steps of the reference: the masked per-frame MSE, autograd,
then Adam (lr, b1 0.9, b2 0.999, eps 1e-8, bias-corrected), all float32.

The loss of a batch is the mean over the output columns of the squared
error, summed over the frames inside each utterance's length and
divided by their number.  Under data parallelism the program's global
step is this step on the global batch (each rank's gradient is its
rows' part of the global loss's, summed over the ranks), so the
reference takes the global batch whole.
"""

import torch

from reference.model import Model, pad


def masked_mse(pred, target, lengths, rows=None):
    """The loss; with ``rows`` (a boolean (B,) mask) only those rows'
    frames enter the sum, over every row's frames."""
    T = pred.shape[1]
    mask = (torch.arange(T, device=pred.device)[None, :]
            < lengths.to(pred.device)[:, None]).to(pred.dtype)
    frame = ((pred - target) ** 2).mean(dim=-1)
    kept = mask if rows is None else mask * rows.to(mask)[:, None]
    return (frame * kept).sum() / mask.sum().clamp(min=1.0)


class Trainer:
    """The reference's parameters and Adam state, stepped on batches of
    utterance rows."""

    def __init__(self, config, weights, lr, device, precision="float32",
                 betas=(0.9, 0.999), eps=1e-8):
        self.params = {k: v.detach().clone().to(device).requires_grad_(True)
                       for k, v in weights.items()}
        self.model = Model(config, self.params, precision)
        self.lr, self.betas, self.eps = float(lr), betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.device = device

    def losses(self, questions, targets, part=None):
        """(loss, loss to differentiate) of a batch given as lists of
        (T_i, D) arrays.  ``part`` plants a fault: ``("half", n)`` keeps
        the first n rows and takes the mean over them; ``("rows", n)``
        keeps the whole loss but differentiates only the first n rows'
        part of it (a rank's gradient without the exchange)."""
        if part is not None and part[0] == "half":
            questions, targets = questions[:part[1]], targets[:part[1]]
        x, lengths = pad(questions)
        y, _ = pad(targets)
        x, y = x.to(self.device), y.to(self.device)
        lengths = lengths.to(self.device)
        pred = self.model(x, lengths)
        loss = masked_mse(pred, y, lengths)
        if part is None or part[0] == "half":
            return loss, loss
        rows = torch.arange(len(questions), device=self.device) < part[1]
        return loss, masked_mse(pred, y, lengths, rows)

    def step(self, questions, targets, part=None):
        """One step; returns (loss, {name: gradient})."""
        loss, differentiated = self.losses(questions, targets, part)
        names = list(self.params)
        grads = torch.autograd.grad(differentiated,
                                    [self.params[k] for k in names])
        grads = dict(zip(names, grads))
        self.t += 1
        b1, b2 = self.betas
        with torch.no_grad():
            for k in names:
                g = grads[k]
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m_hat = self.m[k] / (1.0 - b1 ** self.t)
                v_hat = self.v[k] / (1.0 - b2 ** self.t)
                self.params[k].sub_(self.lr * m_hat
                                    / (v_hat.sqrt() + self.eps))
        return float(loss.detach()), grads
