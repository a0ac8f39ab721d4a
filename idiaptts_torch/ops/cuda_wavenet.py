"""WaveNet autoregressive sampler: the CUDA kernel
``csrc/wavenet_sampler.cu`` and its plain PyTorch version.

Replaces ``idiaptts_tpu/ops/pallas_wavenet.py:_make_kernel`` (launched
by ``_generate_pallas``, front door ``PackedSampler``): the whole sampling
loop over T audio samples in one launch.  Per sample t and batch row:

- ``x = embed[prev]`` (bf16 table; ``prev`` starts at
  ``out_channels // 2``);
- per layer j with dilation d: ``past`` = ring_j[(t + 1) mod (d + 1)],
  read before ring_j[t mod (d + 1)] is written with bf16(x);
  ``pre = [past | bf16(x) | bf16(cond_t)] . [K0; K1; Wc] + b`` (bf16
  operands, float32 sums); ``z = bf16(tanh(pre[:Ca]) sigmoid(pre[Ca:]))``;
  ``skip += z . Wskip + b``; ``x = (x + z . Wres + b) / sqrt(2)``, x
  carried in float32;
- ReLU -> post1 (bf16 operands) -> ReLU -> post2 in float32 -> 256
  logits; classes >= out_channels carry a bias of -1e30;
- the draw: inverse CDF of one streamed uniform U at temperature > 0
  (``p = exp(logits / temperature - max)``, ``c = cumsum(p)``,
  ``sample = #(c < U * c[-1])``, clamped to ``out_channels - 1``),
  first-index argmax at temperature 0, or the teacher's sample in
  forced mode, where the logits are the output.

This is the *unlifted* form of the layer: the gate operand holds the
layer's own input x.  The JAX kernel lifts layer j-1's residual update
into layer j's gate weights (``pack_weights`` there), a TPU latency trick
that moves the bf16 rounding; the unlifted form is what the training
forward computes (``idiaptts_tpu/models/wavenet.py:44-50``).  The kernel
and :func:`sample_plain` compute the same form.

Left behind from the JAX sampler: the ``groups`` interleave (a TPU
issue-order trick, numerically the same as one group), ``_TIME_BLOCK``,
``generate_viable`` and the batch gate (the kernel serves any batch).
The uniforms are an input drawn by the caller from a
``torch.Generator``, so tests can feed the JAX package's draw.

The kernel is built for the production widths (residual = skip = gate/2
= 64 channels, kernel size 2, 256 classes); any conditioning width up to
64, any dilations, and up to ``MAX_LAYERS`` (45) layers: the weights
stay in the shared memory of one thread-block cluster, at most 3 layers
a CTA (:class:`ClusterPlan`).  Beyond, a CUDA launch raises
:class:`~idiaptts_torch.ops.dispatch.KernelError`.  The plain version
takes any widths and depth.
"""

import ctypes

import numpy as np
import torch

from idiaptts_torch.ops import dispatch

CLASSES = 256
# Batch rows of one row group of the kernel (one m16 tensor-core tile).
ROWS = 16
# The widths the kernel is built for (residual, gate half, skip).
KERNEL_WIDTH = 64
KERNEL_MAX_COND = 64
# The kernel's thread-block cluster: CTAs 0..NC-2 hold at most
# LAYERS_PER_CTA layers' weights each, CTA NC-1 the output layers.
CLUSTER_SIZES = (2, 4, 8, 16)
LAYERS_PER_CTA = 3
MAX_LAYERS = (CLUSTER_SIZES[-1] - 1) * LAYERS_PER_CTA
# Shared memory a CTA may use on the card (227 KB).
SMEM_LIMIT = 232448
INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))
_NEG = -1e30
MODE_SAMPLE, MODE_GREEDY, MODE_FORCED = 0, 1, 2

SAMPLER = dispatch.Kernel(
    "wavenet_sampler", "idt_wavenet_sampler",
    [ctypes.c_void_p] * 11 + [ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_int] * 10 + [ctypes.c_float])


class SamplerWeights:
    """The sampler's weights in the port's layout, on one device:

    - ``embed`` (256, R) bf16, rows >= out_channels zero;
    - ``w1`` (L, 2R + C, 2Ca) bf16 = [K0; K1; Wc] per layer, ``b1``
      (L, 2Ca) float32 = dilated bias + cond bias;
    - ``w2`` (L, Ca, S + R) bf16 = [Wskip | Wres], ``b2`` (L, S + R);
    - ``p1`` (S, S) bf16, ``p1b`` (S,); ``p2`` (S, 256) float32 and
      ``p2b`` (256,), classes >= out_channels padded with a -1e30 bias.

    The kernel's fragment-ordered blobs are made from these at its first
    launch (:meth:`kernel_args`)."""

    def __init__(self, dilations, out_channels, embed, w1, b1, w2, b2, p1,
                 p1b, p2, p2b):
        self.dilations = tuple(int(d) for d in dilations)
        self.out_channels = int(out_channels)
        self.embed, self.w1, self.b1, self.w2, self.b2 = embed, w1, b1, w2, b2
        self.p1, self.p1b, self.p2, self.p2b = p1, p1b, p2, p2b
        self.R = embed.shape[1]
        self.Ca = w2.shape[1]
        self.S = p1.shape[0]
        self.C = w1.shape[1] - 2 * self.R
        sizes = [d + 1 for d in self.dilations]
        self.offsets = tuple(int(o) for o in
                             np.concatenate([[0], np.cumsum(sizes)[:-1]]))
        self.slots = int(sum(sizes))
        self._kernel_args = None

    @property
    def device(self):
        return self.embed.device

    def kernel_args(self):
        """(layer blob, post blob, dilations, offsets, padded cond width,
        :class:`ClusterPlan`) on the weights' device, made once."""
        if self._kernel_args is None:
            self._kernel_args = _pack_kernel_blobs(self)
        return self._kernel_args


def pack_weights(state, dilations, out_channels, device=None):
    """WaveNet parameters -> :class:`SamplerWeights`.

    ``state``: the teacher-forced network's parameters by flax name
    (``input_embed.embedding`` (out, R), ``block_{i}.dilated.kernel``
    (2, R, 2Ca), ``block_{i}.{cond,skip,res}.kernel`` (in, out),
    ``post1``/``post2``, each with its ``bias``), as
    ``WaveNet.state_dict()`` gives them."""
    def f32(name):
        return state[name].detach().to(device=device, dtype=torch.float32)

    L = len(dilations)
    if min(dilations) < 1:
        raise ValueError("dilations must be >= 1, got {}".format(dilations))
    kern = [f32("block_{}.dilated.kernel".format(i)) for i in range(L)]
    if any(k.shape[0] != 2 for k in kern):
        raise ValueError("the sampler needs kernel_size 2")
    w1 = torch.stack([torch.cat([kern[i][0], kern[i][1],
                                 f32("block_{}.cond.kernel".format(i))], 0)
                      for i in range(L)])
    b1 = torch.stack([f32("block_{}.dilated.bias".format(i))
                      + f32("block_{}.cond.bias".format(i))
                      for i in range(L)])
    w2 = torch.stack([torch.cat([f32("block_{}.skip.kernel".format(i)),
                                 f32("block_{}.res.kernel".format(i))], 1)
                      for i in range(L)])
    b2 = torch.stack([torch.cat([f32("block_{}.skip.bias".format(i)),
                                 f32("block_{}.res.bias".format(i))])
                      for i in range(L)])
    table = f32("input_embed.embedding")
    if table.shape[0] > CLASSES or out_channels > CLASSES:
        raise ValueError("at most {} classes".format(CLASSES))
    embed = torch.zeros(CLASSES, table.shape[1], device=table.device)
    embed[:table.shape[0]] = table
    p2k = f32("post2.kernel")
    p2 = torch.zeros(p2k.shape[0], CLASSES, device=p2k.device)
    p2[:, :out_channels] = p2k
    p2b = torch.full((CLASSES,), _NEG, device=p2k.device)
    p2b[:out_channels] = f32("post2.bias")
    bf16 = torch.bfloat16
    return SamplerWeights(dilations, out_channels, embed.to(bf16),
                          w1.to(bf16), b1, w2.to(bf16), b2,
                          f32("post1.kernel").to(bf16), f32("post1.bias"),
                          p2, p2b)


def _bf(x):
    """Round float32 to bf16 and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def draw(logits, uniforms, temperature, out_channels):
    """Inverse-CDF draw per row of (B, 256) logits from one uniform each:
    the number of cumulative probabilities below ``U * total``, where the
    total is the cumulative sum's last entry, so ``U < 1`` never reaches a
    class whose probability is 0; clamped to ``out_channels - 1``."""
    z = logits / temperature
    z = z - z.max(dim=1, keepdim=True).values
    c = torch.cumsum(torch.exp(z), dim=1)
    u = uniforms[:, None] * c[:, -1:]
    count = (c < u).sum(dim=1)
    return count.clamp(max=out_channels - 1).to(torch.int32)


def cdf_margin(logits, uniforms, temperature=1.0):
    """Per row of (B, 256) logits: the distance, in probability, from the
    row's uniform U to the nearest class boundary of the inverse-CDF draw,
    ``min_k |U - c_k / c[-1]|``.  Two samplers whose logits differ by
    rounding can draw different classes only where this is small."""
    z = logits.to(torch.float32) / temperature
    z = z - z.max(dim=1, keepdim=True).values
    c = torch.cumsum(torch.exp(z), dim=1)
    cdf = c / c[:, -1:]
    return (cdf[:, :-1] - uniforms[:, None]).abs().min(dim=1).values


def sample_plain(w, cond, uniforms=None, forced=None, temperature=1.0,
                 want_logits=False):
    """The plain PyTorch sampler, step by step (the CPU path and the
    kernel's oracle).

    w: :class:`SamplerWeights`; cond: (T, B, C) float32; uniforms: (T, B)
    float32 in [0, 1) (used when sampling at temperature > 0); forced:
    (T, B) int teacher samples or None.  Returns (samples (T, B) int32,
    logits (T, B, 256) float32 or None)."""
    T, B, _ = cond.shape
    dev = cond.device
    f32 = torch.float32
    R, Ca, S = w.R, w.Ca, w.S
    embed, w1, w2 = w.embed.to(f32), w.w1.to(f32), w.w2.to(f32)
    p1 = w.p1.to(f32)
    cond_b = _bf(cond)
    ring = torch.zeros(w.slots, B, R, device=dev)
    prev = torch.full((B,), w.out_channels // 2, dtype=torch.long,
                      device=dev)
    samples = torch.empty(T, B, dtype=torch.int32, device=dev)
    logits_out = (torch.empty(T, B, CLASSES, device=dev) if want_logits
                  else None)
    for t in range(T):
        x = embed[prev]
        skip = torch.zeros(B, S, device=dev)
        for j, (d, off) in enumerate(zip(w.dilations, w.offsets)):
            size = d + 1
            past = ring[off + (t + 1) % size]
            xb = _bf(x)
            ring[off + t % size] = xb
            pre = torch.cat([past, xb, cond_b[t]], 1) @ w1[j] + w.b1[j]
            z = _bf(torch.tanh(pre[:, :Ca]) * torch.sigmoid(pre[:, Ca:]))
            so = z @ w2[j] + w.b2[j]
            skip = skip + so[:, :S]
            x = (x + so[:, S:]) * INV_SQRT2
        hh = torch.relu(_bf(torch.relu(skip)) @ p1 + w.p1b)
        logits = hh @ w.p2 + w.p2b
        if want_logits:
            logits_out[t] = logits
        if forced is not None:
            s = forced[t].to(torch.int32)
        elif temperature > 0.0:
            s = draw(logits, uniforms[t], temperature, w.out_channels)
        else:
            s = torch.argmax(logits, dim=1).to(torch.int32)
        samples[t] = s
        prev = s.long()
    return samples, logits_out


def _fragments(w):
    """(K, N) bf16 with K % 16 == 0, N % 8 == 0 -> flat bf16 in the
    kernel's mma.m16n8k16 B-fragment order: [n-tile][k-tile][lane][4],
    lane = 4 * (n % 8) + (k % 8) // 2, element = 2 * ((k % 16) // 8) +
    k % 2."""
    K, N = w.shape
    return w.reshape(K // 16, 2, 4, 2, N // 8, 8).permute(
        4, 0, 5, 2, 1, 3).reshape(-1)


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


# Shared-memory sizes of csrc/wavenet_sampler.cu (bytes): a padded
# 16 x 72 bf16 tile, the float32 x/skip inbox, the post blob and the
# embedding table.
_TILE = ROWS * (KERNEL_WIDTH + 8) * 2
_INBOX = 2 * ROWS * (KERNEL_WIDTH + 8) * 4
_POST = (KERNEL_WIDTH * KERNEL_WIDTH * 2 + 2 * KERNEL_WIDTH * CLASSES * 2
         + KERNEL_WIDTH * 4 + CLASSES * 4)
_EMBED = CLASSES * KERNEL_WIDTH * 2
_BARRIERS = 32


def layer_blob_bytes(Cp):
    """Bytes of one layer's blob: the gate and [skip | res] fragments and
    both biases."""
    R = KERNEL_WIDTH
    return (2 * R + Cp) * 2 * R * 2 + R * 2 * R * 2 + 2 * R * 4 + 2 * R * 4


class ClusterPlan:
    """How the kernel spreads L layers over a thread-block cluster of
    ``NC`` CTAs: CTA k < NC - 1 holds layers ``part[k]`` to
    ``part[k + 1] - 1`` (their blob starts at byte ``offsets[k]`` of the
    layer blob), CTA NC - 1 the output layers and the embedding;
    ``cta_bytes[k]`` is CTA k's shared memory."""

    def __init__(self, L, Cp):
        if not 1 <= L <= MAX_LAYERS:
            raise dispatch.KernelError(
                "the wavenet_sampler kernel holds at most {} layers ({} "
                "CTAs of a {}-CTA cluster x {} layers), got {}".format(
                    MAX_LAYERS, CLUSTER_SIZES[-1] - 1, CLUSTER_SIZES[-1],
                    LAYERS_PER_CTA, L))
        self.NC = next(n for n in CLUSTER_SIZES
                       if L <= (n - 1) * LAYERS_PER_CTA)
        base, extra = divmod(L, self.NC - 1)
        counts = [base + (k < extra) for k in range(self.NC - 1)]
        self.part = tuple(int(v) for v in np.cumsum([0] + counts))
        self.counts = tuple(counts)
        self.offsets = tuple(p * layer_blob_bytes(Cp)
                             for p in self.part[:-1])
        self.cta_bytes = tuple(
            [n * (layer_blob_bytes(Cp) + 3 * _TILE) + _INBOX
             + ROWS * (Cp + 8) * 2 + _BARRIERS for n in counts]
            + [_POST + _EMBED + _INBOX + 3 * _TILE
               + ROWS * (CLASSES + 8) * 4 + ROWS * 4 + _BARRIERS])


def _pack_kernel_blobs(w):
    if not (w.R == w.Ca == w.S == KERNEL_WIDTH):
        raise ValueError(
            "the wavenet_sampler kernel is built for residual = skip = "
            "gate/2 = {} channels, got R={} Ca={} S={}".format(
                KERNEL_WIDTH, w.R, w.Ca, w.S))
    if not 1 <= w.C <= KERNEL_MAX_COND:
        raise ValueError("the wavenet_sampler kernel takes 1 to {} "
                         "conditioning channels, got {}".format(
                             KERNEL_MAX_COND, w.C))
    L = len(w.dilations)
    Cp = -(-w.C // 16) * 16
    plan = ClusterPlan(L, Cp)
    w1 = torch.zeros(L, 2 * w.R + Cp, 2 * w.Ca, dtype=torch.bfloat16,
                     device=w.device)
    w1[:, :2 * w.R + w.C] = w.w1
    layers = torch.stack([torch.cat([
        _bytes(_fragments(w1[j])), _bytes(_fragments(w.w2[j])),
        _bytes(w.b1[j]), _bytes(w.b2[j])]) for j in range(L)])
    # post2 in float32 as two bf16 parts: P2 = hi + lo to ~2^-16.
    p2hi = w.p2.to(torch.bfloat16)
    p2lo = (w.p2 - p2hi.to(torch.float32)).to(torch.bfloat16)
    post = torch.cat([_bytes(_fragments(w.p1)), _bytes(_fragments(p2hi)),
                      _bytes(_fragments(p2lo)), _bytes(w.p1b),
                      _bytes(w.p2b)])
    dil = torch.tensor(w.dilations, dtype=torch.int32, device=w.device)
    offs = torch.tensor(w.offsets, dtype=torch.int32, device=w.device)
    return layers.contiguous(), post.contiguous(), dil, offs, Cp, plan


_plans = {}


def launch_plan(w, B):
    """The kernel's launch for B rows with weights ``w`` (on the card):
    {"cluster": CTAs a cluster, "G": row groups a cluster carries,
    "active_clusters": clusters that can be resident at once,
    "clusters": clusters launched}."""
    _, _, _, _, Cp, plan = w.kernel_args()
    Bp = -(-B // ROWS) * ROWS
    key = (w.device, Bp, Cp, plan.NC, max(plan.counts))
    if key not in _plans:
        fn = dispatch.library().idt_wavenet_sampler_plan
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(w.device):
            err = fn(Bp, Cp, plan.NC, max(plan.counts), out)
        if err:
            raise dispatch.KernelError(
                "wavenet_sampler: no launch plan for Bp={} on clusters of "
                "{}: {} (cuda error {})".format(
                    Bp, plan.NC,
                    dispatch.library().idt_error_string(err).decode(), err))
        _plans[key] = {"cluster": plan.NC, "G": out[1],
                       "active_clusters": out[0], "clusters": out[2]}
    return _plans[key]


def sample(w, cond, uniforms=None, forced=None, temperature=1.0,
           want_logits=False):
    """The sampler: :func:`sample_plain`'s arguments and results.  CPU
    tensors take the plain version; CUDA tensors launch the hand kernel
    once for all T steps (batch padded to a multiple of 16 rows, G row
    groups a cluster from :func:`launch_plan`)."""
    tensors = [cond, w.embed] + [t for t in (uniforms, forced)
                                 if t is not None]
    if not dispatch.use_kernel(*tensors):
        return sample_plain(w, cond, uniforms, forced, temperature,
                            want_logits)
    T, B, C = cond.shape
    if C != w.C:
        raise ValueError("cond has {} channels, the weights {}".format(
            C, w.C))
    if forced is not None:
        mode = MODE_FORCED
    elif temperature > 0.0:
        if uniforms is None:
            raise ValueError("sampling at temperature > 0 needs uniforms")
        mode = MODE_SAMPLE
    else:
        mode = MODE_GREEDY
    layers, post, dil, offs, Cp, plan = w.kernel_args()
    dev = cond.device
    Bp = -(-B // ROWS) * ROWS
    samples = torch.empty(T, Bp, dtype=torch.int32, device=dev)
    logits = (torch.empty(T, Bp, CLASSES, device=dev) if want_logits
              else None)
    if T == 0:
        return samples[:, :B], None if logits is None else logits[:, :B]
    G = launch_plan(w, B)["G"]
    cond_k = torch.zeros(T, Bp, Cp, dtype=torch.bfloat16, device=dev)
    cond_k[:, :B, :C] = cond
    u_k = torch.zeros(T, Bp, device=dev)
    if mode == MODE_SAMPLE:
        dispatch.check(uniforms, "uniforms", torch.float32, (T, B))
        u_k[:, :B] = uniforms
    f_k = None
    if mode == MODE_FORCED:
        if tuple(forced.shape) != (T, B):
            raise ValueError("forced must have shape {}, got {}".format(
                (T, B), tuple(forced.shape)))
        if int(forced.min()) < 0 or int(forced.max()) >= CLASSES:
            raise ValueError("forced samples must lie in [0, {})".format(
                CLASSES))
        f_k = torch.zeros(T, Bp, dtype=torch.int32, device=dev)
        f_k[:, :B] = forced
    ring = torch.zeros(w.slots, Bp, w.R, dtype=torch.bfloat16, device=dev)
    SAMPLER(dev, cond_k.data_ptr(), u_k.data_ptr(),
            0 if f_k is None else f_k.data_ptr(), w.embed.data_ptr(),
            layers.data_ptr(), post.data_ptr(), dil.data_ptr(),
            offs.data_ptr(), ring.data_ptr(), samples.data_ptr(),
            0 if logits is None else logits.data_ptr(),
            (ctypes.c_int * plan.NC)(*plan.part),
            T, B, Bp, Cp, len(w.dilations), plan.NC, G, w.out_channels, mode,
            int(want_logits), float(temperature))
    return samples[:, :B], None if logits is None else logits[:, :B]


class PackedSampler:
    """Pack-once front door for repeated generation from one set of
    weights (the JAX package's ``PackedSampler``).  The owner (the model)
    makes a new one when its weights change."""

    def __init__(self, weights):
        self.weights = weights

    def __call__(self, cond, generator=None, uniforms=None,
                 temperature=1.0, forced=None, want_logits=None):
        """cond: (B, T, C) float32 on the weights' device.  ``uniforms``:
        optional (T, B) float32 draw (default: ``torch.rand`` from
        ``generator``, a fresh generator seeded 0 when None); ``forced``:
        optional (B, T) teacher samples.  Returns (samples (B, T) int32,
        logits (B, T, out_channels) or None); logits are made in forced
        mode or with ``want_logits=True``."""
        w = self.weights
        dev = w.device
        cond_t = cond.to(device=dev, dtype=torch.float32).transpose(
            0, 1).contiguous()
        T, B, _ = cond_t.shape
        if forced is None and temperature > 0.0 and uniforms is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            uniforms = torch.rand(T, B, generator=generator, device=dev)
        forced_t = None
        if forced is not None:
            forced_t = torch.as_tensor(forced, device=dev).to(
                torch.int32).transpose(0, 1).contiguous()
        if want_logits is None:
            want_logits = forced is not None
        samples, logits = sample(
            w, cond_t, None if uniforms is None else uniforms.to(dev),
            forced_t, temperature, want_logits)
        samples = samples.transpose(0, 1)
        if logits is not None:
            logits = logits.transpose(0, 1)[..., :w.out_channels]
        return samples, logits
