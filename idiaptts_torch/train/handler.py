"""Model handler: the port's training and inference engine, the PyTorch
counterpart of ``idiaptts_tpu/train/handler.py``.

One train step is: forward in training mode (dropout masks from the
handler's generator; every BiLSTM layer through its training kernels),
the named losses (only ``backprop_loss_names`` enter the optimised
total), backward, then the JAX handler's optax chain in its order:

1. inf/NaN gradients to zero (``replace_inf_grads_by_zero``); the step's
   gradient norm is taken here;
2. gradients of ``frozen_layers`` (regexes over ``/``-joined parameter
   names) to zero, so they count in no norm and move nothing;
3. ``clip_by_global_norm``: g <- g / norm * max_norm when norm >=
   max_norm (optax's formula, not ``clip_grad_norm_``'s);
4. ``clip`` by value (``grad_clip_thresh``);
5. Adam or SGD at the scheduler's learning rate for this step;
6. the EMA of the parameters, when configured.

The forward's intermediates (the VAE's ``vae_mu`` and ``vae_logvar``)
join the output dict under their group path and, where the leaf name is
free, under the bare leaf name, so losses such as ``VAEKLDLoss`` read
them.  BatchNorm's running averages are module buffers: the training
forward updates them, inference reads them, checkpoints save them.

Residual precision of the BiLSTM training kernels follows the JAX
handler's rule by default (``residuals_bf16 = None``): bf16 residual
streams when a rank's batch has more than 32 rows, float32 otherwise.
True or False overrides the rule.  Under tensor parallelism the rows are
those of the rank's recurrence launch (its row block of the BiLSTM):
the JAX tensor-parallel step never reaches its kernels (GSPMD has no
rule for ``pallas_call``), so the JAX rule has no counterpart there.

Data parallelism (``setup_mesh``, the counterpart of the JAX handler's
``shard_map`` step): every rank of a ``torch.distributed`` group holds
the whole batch and the same parameters.  A batch whose leaves all
divide by the world size is sharded on its leading dimension: each rank
runs the forward on its rows (dropout from its own generator, seeded
with the rank), the model's outputs are gathered over the ranks before
the losses run, so masked means keep their global denominators, and the
gradients are summed over the ranks, which makes them the global
gradient; the chain above then runs on every rank alike.  BatchNorm's
running averages become the mean of the ranks' updates.  A batch that
does not divide runs whole on every rank, with rank 0's gradients and
running averages copied to the others.

Tensor parallelism (``setup_mesh(model_parallel=M)``, the JAX handler's
``(data, model)`` mesh and ``_apply_param_shardings``): the ranks form a
grid of ``D x M`` (``parallel/mesh.py``'s ``TensorMesh``), the model is
sharded over each row of M ranks (column-parallel Dense kernels, the
BiLSTM split by direction; ``make_param_shardings``), and the batch over
the D ranks of each column, as data parallelism above does over the
world, except that BatchNorm's batch statistics cover the data group's
rows (the JAX GSPMD step's), which leaves the running averages equal on
every rank.  The ranks of a model group draw one dropout mask (the
generator is seeded with the data rank).  The gradients of BiLSTM pieces that
several ranks of a row hold (M >= 4) are summed over them, then every
gradient over the data group; the norm of ``grad_clip_max_norm`` and
``last_grad_norm`` is the whole model's.  Every rank must run every
step, evaluation and inference, as the sharded forward needs its whole
model group.  Checkpoints hold the one-device state dict and optimiser
moments, gathered (every rank calls ``save_checkpoint``, rank 0
writes), and every rank loads one and shards it, so a one-process
handler and a tensor-parallel one read each other's checkpoints.

Checkpoints keep the JAX handler's directory layout
(``<dir>/<model_name>/<networks_dir>/config.json``, ``params_<suffix>``,
``optimiser_<suffix>``, ``scheduler_<suffix>`` with suffix ``e<N>``,
``s<N>``, ``best`` or ``last``) in the port's own format: ``torch.save``
of the state dicts, and the scheduler state as JSON.
"""

import contextlib
import glob
import json
import logging
import math
import os
import re

import numpy as np
import torch

from idiaptts_torch.data.dataset import batch_shape
from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.rnn_dyn import _BatchNorm
from idiaptts_torch.ops.dispatch import resolve_device
from idiaptts_torch.parallel import mesh as mesh_lib
from idiaptts_torch.train.model_handler_base import ModelHandler
from idiaptts_torch.train.schedulers import create_scheduler
from idiaptts_torch.utils import tracing

logger = logging.getLogger(__name__)

# Batch rows above which the BiLSTM training residuals default to bf16
# (the JAX handler's rule, idiaptts_tpu/train/handler.py).
BF16_RESIDUAL_ROWS = 32


def param_path(name):
    """State-dict name -> the ``/``-joined path that ``frozen_layers``,
    ``ignore_layers`` and ``layer_map`` patterns match."""
    return name.replace(".", "/")


class ExponentialMovingAverage:
    """Shadow parameter EMA: shadow <- decay * shadow + (1 - decay) * p."""

    def __init__(self, model, decay=0.9999):
        self.decay = decay
        self.shadow = {k: p.detach().clone()
                       for k, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model):
        for k, p in model.named_parameters():
            self.shadow[k].mul_(self.decay).add_(p.detach(),
                                                 alpha=1.0 - self.decay)


class ModularModelHandler(ModelHandler):
    """Backend engine for one model on one device (the card unless
    ``device="cpu"``; raises without CUDA)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.model = None
        self.model_config = None
        self.optimiser = None
        self.scheduler = None
        self.losses = []
        self.ema = None
        self.total_steps = 0
        self.base_lr = None
        self.frozen_layers = ()
        self.grad_clip_max_norm = None
        self.grad_clip_thresh = None
        self.replace_inf_grads_by_zero = False
        self.backprop_loss_names = None
        self.iterations_per_scheduler_step = None
        self.epochs_per_scheduler_step = None
        self.residuals_bf16 = None
        self.last_grad_norm = None
        self.mesh = None
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        self._copy_stream = None
        self._uploads = {"ahead": 0, "inline": 0, "ready": 0}

    # -- data and tensor parallelism -----------------------------------------
    def setup_mesh(self, num_devices=None, axis_name="data",
                   model_parallel=1, use_shard_map="auto"):
        """Train over the joined ``torch.distributed`` group
        (``num_devices``, when given, must equal its size): data-parallel,
        or with ``model_parallel=M`` over a ``(data, model)`` grid whose
        rows shard the model (M must divide the world size, else
        ``ValueError``).  The handler moves to the rank's device, its
        generator is seeded with the (data) rank, rank 0's parameters
        and buffers are copied to every rank, and under tensor
        parallelism each rank keeps its shards, with the optimiser (its
        state fresh, as the JAX handler's ``init``) and EMA shadows
        rebuilt on them.  ``use_shard_map`` is accepted for the JAX
        signature and has no effect."""
        self.mesh = mesh_lib.make_2d_mesh(
            num_devices, model_parallel, (axis_name, "model"), self.device)
        self.device = self.mesh.device
        self._copy_stream = None
        self.generator = torch.Generator(device=self.device).manual_seed(
            42 + self.mesh.data.rank)
        if self.model is not None:
            self.model.to(self.device)
            mesh_lib.replicate(self.model, self.mesh)
            self._shard_model()
        return self.mesh

    @property
    def tensor_parallel(self):
        """Whether the model is sharded over a model group."""
        return isinstance(self.mesh, mesh_lib.TensorMesh)

    def _shard_model(self):
        """Shard the model over the mesh's model group and rebuild what
        holds its parameters (the JAX ``_apply_param_shardings``)."""
        if not self.tensor_parallel:
            return
        mesh_lib.shard_module(self.model, self.mesh)
        if self.optimiser is not None:
            self.optimiser = type(self.optimiser)(
                list(self.model.parameters()), **self.optimiser.defaults)
        if self.ema is not None:
            self.ema = ExponentialMovingAverage(self.model, self.ema.decay)

    def full_state_dict(self, state=None):
        """The model's one-device state dict (or that of ``state``, named
        as it, such as EMA shadows): gathered from the shards under
        tensor parallelism, a collective every rank must call."""
        if not self.tensor_parallel:
            return self.model.state_dict() if state is None else state
        return mesh_lib.gather_state_dict(self.model, self.mesh, state)

    def _local_state(self, state):
        """A one-device state dict cut to this rank's shards."""
        if not self.tensor_parallel:
            return state
        return mesh_lib.shard_state_dict(state, self.model, self.mesh)

    def _optimiser_state(self, blob, gather):
        """The optimiser's state dict with each moment shaped as its
        parameter gathered to the one-device layout (``gather``) or cut
        to this rank's piece; others as they are."""
        if not self.tensor_parallel:
            return blob
        params = [p for g in self.optimiser.param_groups
                  for p in g["params"]]
        indices = [i for g in blob["param_groups"] for i in g["params"]]
        state = {}
        for idx, entry in blob["state"].items():
            shard = mesh_lib.shard_of(params[indices.index(idx)])
            state[idx] = {
                k: v if shard is None or not torch.is_tensor(v)
                or v.dim() == 0
                else mesh_lib.gather_tensor(v, shard, self.mesh) if gather
                else shard.piece(v, self.mesh).clone()
                for k, v in entry.items()}
        return {**blob, "state": state}

    def one_device_model(self):
        """``(model, ema_params)`` for a path that runs the model on one
        rank alone (serving): under tensor parallelism a one-device copy
        built from the gathered weights (a collective every rank must
        call), else the handler's own model and EMA shadows."""
        ema = self.ema.shadow if self.ema is not None else None
        if not self.tensor_parallel:
            return self.model, ema
        model = self.model_config.create_model().to(self.device)
        model.load_state_dict(self.full_state_dict())
        if ema is not None:
            ema = self.full_state_dict(ema)
        return model, ema

    def _shards(self, data, lengths):
        """True when every leaf of the batch divides by the data group's
        size, so the batch shards (the JAX ``_get_shmap_step`` rule)."""
        leaves = list(data.values()) + (
            [] if lengths is None else list(lengths.values())
            if isinstance(lengths, dict) else [lengths])
        return all(mesh_lib.divides(v, self.mesh.data) for v in leaves)

    @contextlib.contextmanager
    def _synced_batch_norm(self, sharded):
        """Under tensor parallelism, BatchNorm's batch statistics over the
        data group's rows while a data-sharded step runs (its backward
        and any recompute included), as the JAX GSPMD step takes them."""
        layers = [m for m in self.model.modules()
                  if isinstance(m, _BatchNorm)] \
            if sharded and self.tensor_parallel else []
        for m in layers:
            m.data_mesh = self.mesh.data
        try:
            yield
        finally:
            for m in layers:
                m.data_mesh = None

    def _batch_stats(self):
        """BatchNorm's running averages (the JAX ``batch_stats``)."""
        return [b for m in self.model.modules() if isinstance(m, _BatchNorm)
                for b in (m.mean, m.var)]

    # -- model creation ---------------------------------------------------
    def create_model(self, model_config, hparams=None, dim_in=None,
                     dim_out=None, example_batch=None, seed=1234):
        """Build the model with weights from a generator seeded with
        ``seed`` and move it to the handler's device.  (The port's modules
        know their shapes from the config; ``example_batch`` is accepted
        for the JAX handler's signature.)"""
        self.model_config = model_config
        self.init_params(example_batch, seed)
        return self.model

    def init_params(self, example_batch=None, seed=1234):
        """Fresh weights from a generator seeded with ``seed`` (the JAX
        handler's flax ``init``; the port's modules know their shapes, so
        ``example_batch`` is accepted for the signature), sharded under
        tensor parallelism; returns the named parameters."""
        self.model = self.model_config.create_model(
            torch.Generator().manual_seed(seed)).to(self.device)
        self._shard_model()
        return dict(self.model.named_parameters())

    def _batch_to_model_input(self, batch, move=None):
        """``(data, lengths)`` of a collated batch, each array through
        ``move`` (default: ``torch.as_tensor`` on the handler's device,
        zero-copy on the CPU)."""
        move = move or (lambda v: torch.as_tensor(v, device=self.device))
        data = {k: move(v) for k, v in batch.items()
                if not k.startswith("_") or k.startswith("_seq_mask")}
        lengths = None
        lengths_dict = batch.get("_lengths")
        if lengths_dict:
            arrays = {k: move(np.asarray(v, np.int64))
                      for k, v in lengths_dict.items()}
            # Multi-rate batches keep per-feature lengths; modules select
            # their own via ``select_lengths``.
            lengths = next(iter(arrays.values())) if len(arrays) == 1 \
                else arrays
        return data, lengths

    def _stage(self, batch, ahead):
        """Start the batch's upload; ``(model input, pending)`` for
        :meth:`_receive`.  On a CUDA device every host array is copied
        into page-locked memory (the caching host allocator reuses a
        block only once the copy recorded on it has finished) and from
        there, without blocking, on the handler's copy stream; pending
        is the event recorded after the copies and the device tensors.
        Tensors already on a device, made there on the compute stream,
        are used as they are.  Elsewhere the input is the arrays
        themselves and pending is None.  ``ahead``: issued while the
        previous step runs (counted in :meth:`upload_counts`)."""
        self._uploads["ahead" if ahead else "inline"] += 1
        if self.device.type != "cuda":
            return self._batch_to_model_input(batch), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        uploaded = []

        def move(v):
            if torch.is_tensor(v) and v.device.type != "cpu":
                return v.to(self.device)
            host = torch.as_tensor(v).pin_memory()
            with torch.cuda.stream(self._copy_stream):
                uploaded.append(host.to(self.device, non_blocking=True))
            return uploaded[-1]

        inputs = self._batch_to_model_input(batch, move)
        return inputs, (self._copy_stream.record_event(), uploaded)

    def _receive(self, staged):
        """``(model input, ready)`` of :meth:`_stage`: the current stream
        made to wait for the copies, each tensor marked as used there (so
        the caching allocator keeps its memory until that stream's work
        on it has run); ready: the copies had already finished (none
        pending counts as finished)."""
        inputs, pending = staged
        ready = True
        if pending is not None:
            event, uploaded = pending
            ready = event.query()
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in uploaded:
                t.record_stream(stream)
        self._uploads["ready"] += ready
        return inputs, ready

    def upload_counts(self):
        """{"ahead": batch uploads issued while the previous step ran,
        "inline": those issued at the step itself (the first batch of
        each :meth:`process_batches` call), "ready": those whose copies
        had finished when their step came to wait for them}, over the
        handler's life."""
        return dict(self._uploads)

    # -- optimiser / scheduler / losses -----------------------------------
    def set_optimiser(self, hparams):
        name = hparams.get("optimiser_type", "Adam")
        args = dict(hparams.get("optimiser_args", {}) or {})
        lr = hparams.get("learning_rate")
        if lr is None:
            lr = args.pop("lr", 1e-3)
        else:
            args.pop("lr", None)
        self.base_lr = lr
        self.frozen_layers = tuple(hparams.get("frozen_layers") or ())
        self.grad_clip_max_norm = None
        if hparams.get("grad_clip_norm_type") is not None \
                and hparams.get("grad_clip_max_norm") is not None:
            self.grad_clip_max_norm = float(hparams.grad_clip_max_norm)
        self.grad_clip_thresh = hparams.get("grad_clip_thresh")
        params = list(self.model.parameters())
        if name == "Adam":
            # optax.adam's arguments and defaults.
            betas = (args.pop("b1", 0.9), args.pop("b2", 0.999))
            eps = args.pop("eps", 1e-8)
            if args:
                raise TypeError("Adam arguments not supported: {}".format(
                    sorted(args)))
            self.optimiser = torch.optim.Adam(params, lr=lr, betas=betas,
                                              eps=eps)
        elif name == "SGD":
            momentum = args.pop("momentum", None) or 0.0
            nesterov = args.pop("nesterov", False)
            if args:
                raise TypeError("SGD arguments not supported: {}".format(
                    sorted(args)))
            self.optimiser = torch.optim.SGD(params, lr=lr,
                                             momentum=momentum,
                                             nesterov=nesterov)
        elif callable(name):
            self.optimiser = name(params, lr)
        else:
            raise NotImplementedError("Unknown optimiser " + str(name))
        self.replace_inf_grads_by_zero = hparams.get(
            "replace_inf_grads_by_zero", False)

    def set_scheduler(self, hparams):
        self.scheduler = create_scheduler(
            hparams.get("scheduler_type", "default"), self.base_lr,
            hparams.get("scheduler_args", {}))
        self.iterations_per_scheduler_step = hparams.get(
            "iterations_per_scheduler_step")
        self.epochs_per_scheduler_step = hparams.get(
            "epochs_per_scheduler_step")

    def _current_lr(self):
        """LR for the upcoming train step.  With
        ``iterations_per_scheduler_step=N`` the scheduler advances once
        every N iterations, so step-indexed schedules are indexed by the
        number of scheduler steps taken."""
        if self.scheduler is None:
            return self.base_lr
        if self.iterations_per_scheduler_step:
            t = (self.total_steps + 1) // self.iterations_per_scheduler_step
            self.scheduler.on_epoch(t)
            return self.scheduler.lr(t)
        return self.scheduler.lr(self.total_steps + 1)

    def set_losses(self, loss_configs):
        self.losses = [c.create_loss() for c in loss_configs]

    def set_ema(self, hparams):
        decay = hparams.get("ema_decay")
        if decay is None and hparams.get("exponential_moving_average"):
            decay = hparams.get("exponential_moving_average_decay", 0.9999)
        self.ema = ExponentialMovingAverage(self.model, decay) \
            if decay else None

    # -- steps ------------------------------------------------------------
    def _losses_total(self, out, step):
        total = 0.0
        loss_values = {}
        for loss in self.losses:
            value = loss(out, step)
            loss_values[loss.name] = value
            # Losses outside backprop_loss_names are logged only.
            if self.backprop_loss_names is None \
                    or loss.name in self.backprop_loss_names:
                total = total + value
        return torch.as_tensor(total, dtype=torch.float32,
                               device=self.device), loss_values

    def residuals_bf16_for(self, rows):
        """The BiLSTM training residuals' type for a recurrence launch of
        ``rows`` batch rows: the explicit ``residuals_bf16`` flag, or
        without one the JAX handler's rule, bf16 above 32 rows a
        device."""
        if self.residuals_bf16 is None:
            return rows > BF16_RESIDUAL_ROWS
        return bool(self.residuals_bf16)

    def _apply_model(self, data, lengths, training):
        """Forward; returns the output dict with the intermediates merged
        in (group path, and the bare leaf name where it is free)."""
        rows = next((v.shape[0] for v in data.values()
                     if torch.is_tensor(v) and v.dim() >= 1), 0)
        if self.tensor_parallel and self.mesh.model.size % 2 == 0:
            _, start, stop, _ = mesh_lib.direction_rows(rows, self.mesh)
            rows = stop - start
        intermediates = {}
        out = self.model(data, lengths=lengths, training=training,
                         generator=self.generator,
                         residuals_bf16=self.residuals_bf16_for(rows),
                         intermediates=intermediates)
        flat = dict(out)
        for key, value in intermediates.items():
            flat[key] = value
            flat.setdefault(key.rsplit("/", 1)[-1], value)
        return flat

    def _global_norm(self, params):
        """The gradients' L2 norm over the whole model."""
        if self.tensor_parallel:
            return mesh_lib.global_norm(params, self.mesh)
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad.to(torch.float32))
             for p in params]))

    def _sharded_forward(self, data, lengths):
        """This rank's forward on its rows, its outputs gathered over the
        data group (the batch's own tensors taken whole)."""
        mesh = self.mesh.data
        shard = mesh_lib.shard_batch(data, mesh)
        out = self._apply_model(shard, mesh_lib.shard_batch(lengths, mesh),
                                training=True)
        return {k: (data[k] if k in shard and v is shard[k]
                    else mesh_lib.gather_rows(v, mesh)
                    if torch.is_tensor(v) and v.dim() >= 1 else v)
                for k, v in out.items()}

    def _train_step(self, data, lengths, lr):
        """One optimiser step; returns (total, {name: loss}, grad norm)
        as device scalars."""
        for group in self.optimiser.param_groups:
            group["lr"] = lr
        self.optimiser.zero_grad(set_to_none=False)
        data_mesh = self.mesh.data if self.mesh is not None else None
        sharded = data_mesh is not None and data_mesh.distributed \
            and self._shards(data, lengths)
        with self._synced_batch_norm(sharded):
            with tracing.span("train.forward", device=self.device):
                if sharded:
                    out = self._sharded_forward(data, lengths)
                else:
                    out = self._apply_model(data, lengths, training=True)
                total, loss_values = self._losses_total(out,
                                                        self.total_steps)
            with tracing.span("train.backward", device=self.device):
                total.backward()
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for _, p in named]
        params = [p for _, p in named]
        if data_mesh is not None:
            with tracing.span("train.reduce", device=self.device):
                if self.tensor_parallel:
                    mesh_lib.reduce_gradients(params, self.mesh, sharded)
                elif sharded:
                    # Each rank's gradient is its rows' part of the
                    # global one.
                    mesh_lib.all_reduce_gradients(params, data_mesh)
                elif data_mesh.distributed:
                    mesh_lib.broadcast_flat(grads, data_mesh)
        with tracing.span("train.optimiser", device=self.device):
            grad_norm = self._update(named, grads, params, sharded,
                                     data_mesh)
        return total.detach(), loss_values, grad_norm

    def _update(self, named, grads, params, sharded, data_mesh):
        """The optax chain's gradient transforms, the optimiser step, the
        batch statistics' exchange and the EMA; returns the gradient
        norm."""
        with torch.no_grad():
            if self.replace_inf_grads_by_zero:
                for g in grads:
                    g.copy_(torch.where(torch.isfinite(g), g,
                                        torch.zeros_like(g)))
            grad_norm = self._global_norm(params)
            for n, p in named:
                if any(re.search(pat, param_path(n))
                       for pat in self.frozen_layers):
                    p.grad.zero_()
            if self.grad_clip_max_norm is not None:
                norm = self._global_norm(params)
                max_norm = self.grad_clip_max_norm
                for g in grads:
                    g.copy_(torch.where(norm < max_norm, g,
                                        g / norm * max_norm))
            if self.grad_clip_thresh is not None:
                for g in grads:
                    g.clamp_(-self.grad_clip_thresh, self.grad_clip_thresh)
        self.optimiser.step()
        # Synced statistics leave the running averages equal already.
        stats = self._batch_stats() if data_mesh is not None \
            and data_mesh.distributed \
            and not (sharded and self.tensor_parallel) else []
        if sharded and stats:
            with torch.no_grad():
                mesh_lib.all_reduce_flat(stats, data_mesh.group)
                for b in stats:
                    b.div_(data_mesh.size)
        elif stats:
            mesh_lib.broadcast_flat(stats, data_mesh)
        if self.ema is not None:
            self.ema.update(self.model)
        return grad_norm

    def process_batches(self, batches, training=True, step_offset=None,
                        current_epoch=None):
        """One pass over collated batches; returns the mean total loss and
        the per-loss means.  Training updates the parameters per batch.

        The batches are read one ahead: once a step is launched, the next
        batch is fetched and its upload issued (:meth:`_stage`) before
        the step's one read back, so on a CUDA device its copy runs on
        the copy stream beside the step's kernels.  Every batch is
        stepped once, in order; an exception from the iterator is raised
        after the step already launched has been read back."""
        self.model.train(training)
        totals, counts = {}, 0
        total_sum = 0.0
        # Training steps are traced (``train.*``); evaluation is not.
        span = tracing.span if training else _untraced
        batches = iter(batches)
        with span("train.fetch"):
            batch = next(batches, None)
        staged = None if batch is None else self._stage(batch, ahead=False)
        ahead = False
        while batch is not None:
            with span("train.step") as step:
                if tracing.enabled():
                    step.set(**batch_shape(batch))
                with span("train.upload", device=self.device,
                          ahead=ahead) as upload:
                    (data, lengths), ready = self._receive(staged)
                    if tracing.enabled():
                        upload.set(ready=ready)
                if training:
                    lr = self._current_lr()
                    total, loss_values, grad_norm = self._train_step(
                        data, lengths, lr)
                    self.total_steps += 1
                else:
                    with torch.no_grad():
                        out = self._apply_model(data, lengths,
                                                training=False)
                        total, loss_values = self._losses_total(
                            out, self.total_steps)
                    grad_norm = torch.zeros((), device=self.device)
                error = None
                with span("train.fetch"):
                    try:
                        batch = next(batches, None)
                    except Exception as e:  # raised after the read back
                        error, batch = e, None
                if batch is not None:
                    with span("train.stage") as stage:
                        if tracing.enabled():
                            stage.set(**batch_shape(batch))
                        staged = self._stage(batch, ahead=True)
                # One device-to-host transfer per batch.
                names = list(loss_values)
                with span("train.sync"):
                    host = torch.stack(
                        [total.to(torch.float32),
                         grad_norm.to(torch.float32)]
                        + [torch.as_tensor(loss_values[n],
                                           dtype=torch.float32,
                                           device=self.device).detach()
                           for n in names]).tolist()
                total = host[0]
                if training:
                    self.last_grad_norm = host[1]
                if math.isnan(total):
                    if training:
                        raise ValueError("Loss is NaN.")
                    logger.warning("NaN loss in evaluation.")
                total_sum += total
                for name, value in zip(names, host[2:]):
                    totals[name] = totals.get(name, 0.0) + value
                counts += 1
                if error is not None:
                    raise error
            ahead = True
        if counts == 0:
            return np.nan, {}
        return total_sum / counts, {k: v / counts for k, v in totals.items()}

    @torch.no_grad()
    def inference(self, batch):
        """Forward without training (the EMA parameters when configured);
        returns the output dict as numpy arrays."""
        data, lengths = self._batch_to_model_input(batch)
        self.model.eval()
        if self.ema is not None:
            out = torch.func.functional_call(
                self.model, self.ema.shadow, (data,),
                {"lengths": lengths, "training": False,
                 "generator": self.generator})
        else:
            out = self.model(data, lengths=lengths, training=False,
                             generator=self.generator)
        return {k: v.detach().to(torch.float32).cpu().numpy()
                for k, v in out.items() if torch.is_tensor(v)}

    # -- checkpointing ----------------------------------------------------
    @staticmethod
    def _atomic(path, write):
        tmp = path + ".tmp"
        write(tmp)
        os.replace(tmp, path)

    def save_checkpoint(self, directory, model_name=None, epoch=None,
                        step=None, best=False, last=False, best_loss=None,
                        networks_dir="nn"):
        """Write config.json + params_/optimiser_/scheduler_<suffix>.
        Under tensor parallelism every rank calls it (the weights and
        moments are gathered) and rank 0 writes."""
        out_dir = os.path.join(directory, model_name or "", networks_dir)
        params = {k: v.detach().cpu()
                  for k, v in self.full_state_dict().items()}
        ema = None if self.ema is None else {
            k: v.detach().cpu()
            for k, v in self.full_state_dict(self.ema.shadow).items()}
        opt_blob = None if self.optimiser is None else \
            self._optimiser_state(self.optimiser.state_dict(), gather=True)
        if self.tensor_parallel and self.mesh.rank != 0:
            return out_dir
        os.makedirs(out_dir, exist_ok=True)
        if self.model_config is not None:
            self._atomic(os.path.join(out_dir, "config.json"),
                         lambda p: _write_text(p, self.model_config.to_json()))
        suffixes = []
        if epoch is not None:
            suffixes.append("e{}".format(epoch))
        if step is not None:
            suffixes.append("s{}".format(step))
        if best:
            suffixes.append("best")
        if last:
            suffixes.append("last")
        state = {"params": params}
        if ema is not None:
            # The EMA parameters serve inference; the raw ones resume
            # training with the optimiser moments that belong to them.
            state = {"params": {**params, **ema}, "raw_params": params}
        opt_state = None
        if opt_blob is not None:
            opt_state = {"opt_state": opt_blob,
                         "best_loss": None if best_loss is None
                         else float(best_loss),
                         "total_steps": int(self.total_steps)}
        for suffix in suffixes:
            self._atomic(os.path.join(out_dir, "params_" + suffix),
                         lambda p: torch.save(state, p))
            if opt_state is not None:
                self._atomic(os.path.join(out_dir, "optimiser_" + suffix),
                             lambda p: torch.save(opt_state, p))
            if self.scheduler is not None:
                blob = json.dumps(_jsonable(self.scheduler.state_dict()))
                self._atomic(os.path.join(out_dir, "scheduler_" + suffix),
                             lambda p: _write_text(p, blob))
        return out_dir

    def load_checkpoint(self, directory, model_name=None, epoch=None,
                        step=None, best=False, last=False,
                        load_optimiser=True, load_scheduler=True,
                        ignore_layers=(), layer_map=(), networks_dir="nn"):
        """Load params (+ optimiser and scheduler); returns (best_loss,
        epoch, total_steps).  A one-device checkpoint: under tensor
        parallelism every rank loads it and keeps its shards."""
        out_dir = os.path.join(directory, model_name or "", networks_dir)
        if epoch is not None:
            suffix = "e{}".format(epoch)
        elif step is not None:
            suffix = "s{}".format(step)
        elif best:
            suffix = "best"
        elif last:
            suffix = "last"
        else:
            suffix = self._newest_suffix(out_dir)
        path = os.path.join(out_dir, "params_" + suffix)
        if self.model is None:
            with open(os.path.join(out_dir, "config.json")) as f:
                self.model_config = ModelConfig.from_json(f.read())
            self.model = self.model_config.create_model().to(self.device)
            self._shard_model()
        state = torch.load(path, map_location="cpu", weights_only=True)
        new_params = state["params"]
        raw_params = state.get("raw_params")
        if raw_params is not None and load_optimiser:
            if self.ema is not None:
                self.ema.shadow = {k: v.to(self.device)
                                   for k, v in self._local_state(
                                       new_params).items()}
            new_params = raw_params
        if layer_map:
            new_params = _apply_layer_map(new_params, layer_map)
        new_params = self._local_state(new_params)
        if ignore_layers:
            new_params = _merge_ignored(new_params, self.model.state_dict(),
                                        ignore_layers)
        self.model.load_state_dict(new_params, strict=True)
        best_loss, total_epoch = None, None
        opt_path = os.path.join(out_dir, "optimiser_" + suffix)
        if os.path.isfile(opt_path):
            # best_loss/total_steps live beside the optimiser state; read
            # them even when the optimiser state is not wanted.
            blob = torch.load(opt_path, map_location="cpu",
                              weights_only=True)
            best_loss = blob.get("best_loss")
            self.total_steps = int(blob.get("total_steps", 0) or 0)
            if load_optimiser and self.optimiser is not None:
                try:
                    self.optimiser.load_state_dict(self._optimiser_state(
                        blob["opt_state"], gather=False))
                except (KeyError, ValueError) as e:
                    logger.warning("Optimiser state mismatch, kept the "
                                   "fresh state: %s", e)
        sched_path = os.path.join(out_dir, "scheduler_" + suffix)
        if load_scheduler and os.path.isfile(sched_path) \
                and self.scheduler is not None:
            with open(sched_path) as f:
                self.scheduler.load_state_dict(json.load(f))
        match = re.match(r"e(\d+)", suffix)
        if match:
            total_epoch = int(match.group(1))
        return best_loss, total_epoch, self.total_steps

    @staticmethod
    def _newest_suffix(out_dir):
        candidates = [p for p in glob.glob(os.path.join(out_dir, "params_*"))
                      if not p.endswith(".tmp")]
        if not candidates:
            raise FileNotFoundError("No checkpoint in " + out_dir)
        newest = max(candidates, key=os.path.getctime)
        return os.path.basename(newest)[len("params_"):]


def _untraced(name, device=False, **attrs):
    return tracing.NOOP


def _write_text(path, text):
    with open(path, "w") as f:
        f.write(text)


def _apply_layer_map(params, layer_map):
    """Regex rename of ``/``-joined parameter paths."""
    renamed = {}
    for name, value in params.items():
        path = param_path(name)
        for pattern, replacement in layer_map:
            path = re.sub(pattern, replacement, path)
        renamed[path.replace("/", ".")] = value
    return renamed


def _merge_ignored(new_params, current_params, ignore_layers):
    """Keep the current values of parameters that match an ignore
    pattern or are missing from the checkpoint."""
    merged = {}
    for name, value in current_params.items():
        ignored = any(re.search(p, param_path(name)) for p in ignore_layers)
        merged[name] = value if ignored or name not in new_params \
            else new_params[name]
    return merged


def _jsonable(d):
    out = {}
    for key, value in d.items():
        if isinstance(value, (np.floating, np.integer)):
            value = value.item()
        if isinstance(value, (int, float, str, bool, type(None), list)):
            out[key] = value
    return out
