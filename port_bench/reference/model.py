"""The acoustic models of the configurations, plain float32 PyTorch.

Layers as the IdiapTTS RNNDyn presets define them: Dense (x W + b, then
the group's nonlinearity), bidirectional LSTM (gates [i, f, g, o], the
forget gate's bias +1) and bidirectional GRU (flax's ``GRUCell``:
r = s(x Wir + bir + h Whr), z = s(x Wiz + biz + h Whz),
n = tanh(x Win + bin + r (h Whn + bhn)), h' = (1 - z) n + z h), the
output layer without nonlinearity.  A backward direction reads each
sequence reversed within its length: the LSTM keeps the padding at the
tail (packed-sequence reversal), the GRU reverses the padding after it
(``flax.linen.recurrent.flip_sequences``); frames inside the length get
the same outputs either way, and the padded ones are what the model's
definition gives them.

``precision="fp8"`` is the control, the precision step below the
configuration's bf16: every value the program rounds to bf16 is rounded
to float8 instead (e4m3, one scale a tensor that puts its largest
magnitude at 448): the matrix products' operands, each Dense layer's
output, and the GRU's products, gates and candidate (the program runs
the GRU cell in bf16 throughout; the LSTM keeps its gates and cells in
float32).  In training the gradient reaching each rounded value is
rounded too (e5m2, its largest magnitude at 57344), as float8 training
does; a plain cast would flush the gradients to zero.
"""

import torch

FP8 = ((torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0))


def _round(x, kind):
    dtype, top = FP8[kind]
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, 0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, 1)


def _fp8(x):
    return _Fp8.apply(x)


def masked_flip(x, lengths):
    """Each (B, T, ...) sequence reversed within its length, the padding
    left in place."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(x.device)[:, None]
    idx = torch.where(t < L, L - 1 - t, t)
    return _gather(x, idx)


def flip_sequences(x, lengths):
    """Each sequence reversed within its length and the padding reversed
    after it: index (T - 1 - t + L) mod T.  Its own inverse."""
    T = x.shape[1]
    t = torch.arange(T - 1, -1, -1, device=x.device)[None, :]
    return _gather(x, (t + lengths.to(x.device)[:, None]) % T)


def _gather(x, idx):
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


class Model:
    """forward(questions (B, T, D_in) float32, lengths (B,)) ->
    (B, T, D_out) float32, from ``weights`` named as ``pb.weights``
    lays them out."""

    def __init__(self, config, weights, precision="float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.config = config
        self.w = weights
        self.q = _fp8 if precision == "fp8" else (lambda x: x)
        # Values the program rounds to bf16 beyond the products' operands.
        self.r = self.q

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def __call__(self, x, lengths):
        for g, layer in enumerate(self.config["layers"]):
            for j in range(int(layer.get("count", 1))):
                kind = layer["kind"]
                if kind == "dense":
                    pre = "g{}_Linear_{}".format(g, j)
                    x = self.r(self.mm(x, self.w[pre + ".kernel"])
                               + self.w[pre + ".bias"])
                    if layer.get("nonlin") == "relu":
                        x = torch.relu(x)
                    elif layer.get("nonlin") not in (None, "none"):
                        raise ValueError(layer["nonlin"])
                elif kind == "bilstm":
                    x = self.bilstm(x, lengths, "g{}_LSTM.bi{}".format(g, j))
                elif kind == "bigru":
                    x = self.bigru(x, lengths, "g{}_GRU".format(g), j)
                else:
                    raise ValueError(kind)
        return x

    def bilstm(self, x, lengths, pre):
        wx, wh, b = (self.w[pre + k] for k in (".Wx", ".Wh", ".b"))
        F = wh.shape[1]
        xp = torch.stack([self.r(self.mm(x, wx[0])) + b[0],
                          self.r(self.mm(masked_flip(x, lengths), wx[1]))
                          + b[1]])
        B = x.shape[0]
        h = x.new_zeros(2, B, F)
        c = x.new_zeros(2, B, F)
        whq = self.q(wh)
        hs = []
        for xp_t in xp.unbind(2):
            gates = xp_t + torch.bmm(self.q(h), whq)
            i, f, g, o = gates.split(F, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs, dim=2)
        return torch.cat([out[0], masked_flip(out[1], lengths)], dim=-1)

    def bigru(self, x, lengths, group, j):
        dirs = ["{}.{}{}".format(group, d, j) for d in ("fwd", "bwd")]
        wi = torch.stack([torch.cat([self.w["{}.i{}.kernel".format(p, g)]
                                     for g in "rzn"], dim=1) for p in dirs])
        bi = torch.stack([torch.cat([self.w["{}.i{}.bias".format(p, g)]
                                     for g in "rzn"]) for p in dirs])
        wh = torch.stack([torch.cat([self.w["{}.h{}.kernel".format(p, g)]
                                     for g in "rzn"], dim=1) for p in dirs])
        bhn = torch.stack([self.w[p + ".hn.bias"] for p in dirs])
        F = wh.shape[1]
        xs = torch.stack([x, flip_sequences(x, lengths)])
        xi = self.r(self.mm(xs, wi[:, None]) + bi[:, None, None])
        h = x.new_zeros(2, x.shape[0], F)
        whq = self.q(wh)
        hs = []
        for x_t in xi.unbind(2):
            hh = self.r(torch.bmm(self.q(h), whq))
            r = self.r(torch.sigmoid(x_t[..., :F] + hh[..., :F]))
            z = self.r(torch.sigmoid(x_t[..., F:2 * F] + hh[..., F:2 * F]))
            n = self.r(torch.tanh(x_t[..., 2 * F:]
                                  + r * (hh[..., 2 * F:] + bhn[:, None])))
            h = (1.0 - z) * n + z * h
            hs.append(h)
        out = torch.stack(hs, dim=2)
        return torch.cat([out[0], flip_sequences(out[1], lengths)], dim=-1)


def pad(rows, T=None):
    """(B, T, D) float32 zero-padded batch and (B,) lengths of a list of
    (T_i, D) arrays, padded to ``T`` or the longest."""
    lengths = [len(r) for r in rows]
    T = max(lengths) if T is None else int(T)
    out = torch.zeros(len(rows), T, rows[0].shape[1])
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.as_tensor(r)
    return out, torch.tensor(lengths, dtype=torch.int64)
