"""Data and tensor parallelism over ``torch.distributed``: the port of
``idiaptts_tpu/parallel/mesh.py``.

The JAX package trains over a 1-D device mesh: the batch sharded on its
leading dimension, the parameters replicated, the gradients all-reduced.
Here the mesh is the process group, one process a rank:

- :func:`initialise_multihost` joins the group (torchrun's environment,
  or an explicit address, world size and rank);
- :func:`make_data_mesh` describes this process's place in it
  (:class:`DataMesh`: world size, rank, the rank's device);
- :func:`shard_batch` gives rank r the rows ``[r B/n, (r+1) B/n)`` of
  every leaf whose leading dimension divides by the world size, and the
  whole leaf otherwise;
- :func:`replicate` copies rank 0's parameters and buffers to every
  rank;
- :func:`make_sharded_train_step` is the generic data-parallel step.

Tensor parallelism trains over a 2-D ``(data, model)`` grid of ranks
(:func:`make_2d_mesh`, :class:`TensorMesh`): the batch shards over
``data``, the weights over ``model`` (:func:`make_param_shardings`,
:func:`shard_module`), and :func:`make_tp_train_step` is the generic
step.  The sharded layers (``models/rnn_dyn.py``'s ``_Dense`` and
``_BiFastLSTM``) meet their model group through two autograd collectives,
:func:`copy_to_model` and :func:`gather_from_model`;
:func:`shard_state_dict` and :func:`gather_state_dict` carry a one-device
state dict to this rank's shards and back.

Every collective is an ``all_reduce``, which both back ends take on CUDA
tensors (gloo copies through the host): a broadcast is a sum in which
every other rank gives zeros, a gather of rows (or of a model group's
shards) a sum of zero-padded global buffers.  Both sums are exact.  NCCL
needs one card a rank; ranks that share a card use gloo.
"""

import os
import re

import torch
import torch.distributed as dist


class DataMesh:
    """One rank's view of the data-parallel group: ``size`` ranks, this
    one ``rank``, its ``device``; ``axis_name`` is the JAX mesh axis's
    name.  ``group`` is the ``torch.distributed`` group of the ranks (None:
    the whole world)."""

    def __init__(self, size, rank, device, axis_name="data", group=None):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.axis_name = axis_name
        self.group = group

    @property
    def data(self):
        """The mesh the batch shards over: this one."""
        return self

    @property
    def distributed(self):
        return self.size > 1

    def __repr__(self):
        return "DataMesh(size={}, rank={}, device={})".format(
            self.size, self.rank, self.device)


def default_backend(device="cuda"):
    """NCCL for ranks on CUDA cards, one card a rank; gloo on the CPU and
    where this host's ranks (torchrun's ``LOCAL_WORLD_SIZE``) outnumber
    its cards, as NCCL takes no two ranks on one card."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def initialise_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, backend=None, device="cuda"):
    """Join the process group; a no-op when it is joined already.

    Without ``coordinator_address`` the group comes from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  Otherwise ``coordinator_address`` is ``host:port``
    (TCP) or a URL (``tcp://...``, ``file://...``), with
    ``num_processes`` and ``process_id``.  ``backend`` defaults to
    :func:`default_backend` of ``device``, where the ranks train.
    Returns :func:`make_data_mesh` of the group."""
    if not dist.is_initialized():
        kwargs = {"backend": backend or default_backend(device)}
        if coordinator_address is None:
            kwargs["init_method"] = "env://"
        else:
            url = coordinator_address if "://" in coordinator_address \
                else "tcp://" + coordinator_address
            kwargs.update(init_method=url, world_size=int(num_processes),
                          rank=int(process_id))
        dist.init_process_group(**kwargs)
    return make_data_mesh(device=device)


def rank_device(device="cuda"):
    """The device of this rank: ``device`` as given when it names an
    index or the CPU, else the card ``LOCAL_RANK`` (torchrun's; the
    group rank without it) modulo the visible cards, so ranks that share
    one card all get it."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(local) % max(
        torch.cuda.device_count(), 1))


def make_data_mesh(num_devices=None, axis_name="data", device="cuda"):
    """This process's :class:`DataMesh`: the process group's size and
    rank (a world of one without a group) and :func:`rank_device` of
    ``device``.  ``num_devices``, when given, must equal the world
    size."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if num_devices is not None and int(num_devices) != size:
        raise ValueError(
            "num_devices={} but the process group has {} rank(s); launch "
            "one process a rank (torchrun --nproc_per_node={})".format(
                num_devices, size, num_devices))
    return DataMesh(size, rank, rank_device(device), axis_name)


def divides(x, mesh):
    """True when ``x`` has a leading dimension divisible by the world
    size, so that it shards."""
    shape = getattr(x, "shape", None)
    return shape is not None and len(shape) >= 1 \
        and shape[0] % mesh.size == 0


def shard_rows(x, mesh):
    """Rank r's rows ``[r B/n, (r+1) B/n)`` of ``x``, or ``x`` whole when
    its leading dimension does not divide (or it has none)."""
    if not mesh.distributed or not divides(x, mesh):
        return x
    rows = x.shape[0] // mesh.size
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


def shard_batch(batch, mesh):
    """:func:`shard_rows` of every leaf of a nested dict, list or tuple
    of arrays or tensors."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return shard_rows(batch, mesh)


def _reduce_dtype(dtype):
    """The type a tensor is summed in: float32 for the narrow floats
    (exact: every sum adds zeros), int64 for integers and booleans."""
    if dtype.is_floating_point:
        return torch.float64 if dtype == torch.float64 else torch.float32
    return torch.int64


def _by_dtype(tensors):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_flat(tensors, group=None):
    """Sum ``tensors`` over the ranks of ``group`` (the world by default)
    in place, one flattened buffer (one collective) a type."""
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_flat(tensors, mesh):
    """Rank 0's values of ``tensors`` on every rank, in place: a sum in
    which the other ranks give zeros."""
    if not mesh.distributed or not tensors:
        return
    with torch.no_grad():
        if mesh.rank != 0:
            for t in tensors:
                t.zero_()
        work = [t.to(_reduce_dtype(t.dtype)) for t in tensors]
        all_reduce_flat(work, mesh.group)
        for t, w in zip(tensors, work):
            t.copy_(w)


def replicate(module, mesh):
    """Copy rank 0's parameters and buffers of ``module`` (an
    ``nn.Module`` or a dict of tensors) to every rank, in place; returns
    it."""
    broadcast_flat(list(module.state_dict().values())
                   if isinstance(module, torch.nn.Module)
                   else list(module.values()), mesh)
    return module


def gather_rows(x, mesh):
    """The global tensor of which every rank holds its rows
    (``shard_rows``): the other ranks' rows as constants, this rank's
    with their autograd history."""
    if not mesh.distributed:
        return x
    rows = x.shape[0]
    start = mesh.rank * rows
    with torch.no_grad():
        full = x.new_zeros((rows * mesh.size,) + tuple(x.shape[1:]),
                           dtype=_reduce_dtype(x.dtype))
        full[start:start + rows] = x.detach().to(full.dtype)
        dist.all_reduce(full, group=mesh.group)
        full = full.to(x.dtype)
    return torch.cat([full[:start], x, full[start + rows:]])


def all_reduce_gradients(parameters, mesh, mean=False):
    """Sum (or average) the gradients of ``parameters`` over the ranks."""
    if not mesh.distributed:
        return
    grads = []
    for p in parameters:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    with torch.no_grad():
        all_reduce_flat(grads, mesh.group)
        if mean:
            for g in grads:
                g.div_(mesh.size)


def make_sharded_train_step(loss_fn, optimiser, mesh):
    """A data-parallel train step: ``train_step(batch) -> loss``.

    Each rank runs ``loss_fn(shard_batch(batch, mesh))`` (a scalar, the
    mean over its rows), backpropagates, and the gradients of the
    optimiser's parameters are averaged over the ranks before
    ``optimiser.step()``; the returned loss is the ranks' mean.  For a
    loss that is a mean over rows of equal weight this is the gradient of
    the whole batch's loss, the JAX step's result.  (The model handler's
    own step gathers the outputs instead, so masked means keep their
    global denominators.)"""
    params = [p for group in optimiser.param_groups for p in group["params"]]

    def train_step(batch):
        optimiser.zero_grad(set_to_none=False)
        loss = loss_fn(shard_batch(batch, mesh))
        loss.backward()
        all_reduce_gradients(params, mesh, mean=True)
        optimiser.step()
        loss = loss.detach().clone()
        if mesh.distributed:
            dist.all_reduce(loss, group=mesh.group)
            loss = loss / mesh.size
        return loss

    return train_step


# -- tensor parallelism ------------------------------------------------------

class TensorMesh(DataMesh):
    """One rank's view of a ``(data, model)`` grid of ``data.size`` x
    ``model.size`` ranks, rank = data index * M + model index (the JAX
    ``make_2d_mesh`` grid): ``size``, ``rank`` and ``group`` are the
    world's; ``data`` is the rank's column (the ranks with its model
    index, over which the batch shards and the gradients are summed),
    ``model`` its row (M consecutive ranks, over which the weights
    shard), and for M >= 4 ``direction`` the ranks of its row that hold
    the same BiLSTM direction (model index of the same parity), else
    None."""

    def __init__(self, data, model, device, axis_names=("data", "model"),
                 direction=None):
        super().__init__(data.size * model.size,
                         data.rank * model.size + model.rank, device,
                         axis_names[0])
        self.axis_names = tuple(axis_names)
        self._data = data
        self.model = model
        self.direction = direction

    @property
    def data(self):
        return self._data

    def __repr__(self):
        return "TensorMesh(data={}/{}, model={}/{}, device={})".format(
            self.data.rank, self.data.size, self.model.rank,
            self.model.size, self.device)


def make_2d_mesh(num_devices=None, model_parallel=2,
                 axis_names=("data", "model"), device="cuda"):
    """This process's place in a ``(data, model)`` grid over the process
    group: a :class:`TensorMesh` (a :class:`DataMesh` when
    ``model_parallel`` is 1).  ``num_devices``, when given, must equal
    the world size, which ``model_parallel`` must divide; otherwise
    ``ValueError``.  Every rank creates every row, column and direction
    group, in one order, as ``torch.distributed.new_group`` requires."""
    M = int(model_parallel or 1)
    if M == 1:
        return make_data_mesh(num_devices, axis_names[0], device)
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if num_devices is not None and int(num_devices) != size:
        raise ValueError(
            "num_devices={} but the process group has {} rank(s); launch "
            "one process a rank (torchrun --nproc_per_node={})".format(
                num_devices, size, num_devices))
    if size % M:
        raise ValueError(
            "model_parallel={} does not divide {} rank(s); launch a "
            "multiple of {} processes (torchrun --nproc_per_node=N, "
            "hparams.num_devices=N)".format(M, size, M))
    D = size // M
    data_rank, model_rank = divmod(rank, M)
    device = rank_device(device)
    rows = [dist.new_group(list(range(d * M, (d + 1) * M)))
            for d in range(D)]
    cols = [dist.new_group(list(range(m, size, M))) for m in range(M)]
    direction = None
    if M >= 4 and M % 2 == 0:
        pairs = [[dist.new_group([d * M + m for m in range(p, M, 2)])
                  for p in range(2)] for d in range(D)]
        direction = DataMesh(M // 2, model_rank // 2, device, "direction",
                             pairs[data_rank][model_rank % 2])
    return TensorMesh(DataMesh(D, data_rank, device, axis_names[0],
                               cols[model_rank]),
                      DataMesh(M, model_rank, device, axis_names[1],
                               rows[data_rank]),
                      device, axis_names, direction)


def model_size(mesh):
    """M, the ranks a weight shards over (1 without a model axis)."""
    return mesh.model.size if isinstance(mesh, TensorMesh) else 1


_DENSE = re.compile(r"(^|\.)g\d+_(Linear|FC|LIN)_\d+\.kernel$")
_BILSTM = re.compile(r"(^|\.)g\d+_LSTM\.bi\d+\.(Wx|Wh|b)$")


def make_param_shardings(params, mesh, axis_name="model", min_shard_size=2):
    """For each named parameter of ``params`` (an ``nn.Module`` or a dict
    of tensors in the port's one-device layout, ``models/rnn_dyn.py``'s
    names), the dimension it shards over the ``model`` axis, or None
    (replicated).

    The JAX rule (``idiaptts_tpu/parallel/mesh.py``: the trailing
    dimension of every weight of two or more dimensions, when M divides
    it and leaves at least ``min_shard_size`` a shard) holds for the
    kernel of a Dense layer (``g<i>_Linear_<j>.kernel``): its output
    columns shard (column-parallel), its bias stays whole.  The
    departures:

    - the fused BiLSTM's ``Wx (2, D, 4F)``, ``Wh (2, F, 4F)`` and
      ``b (2, 4F)`` shard over their leading direction axis when M is
      even (model rank r holds direction r % 2), not over the gate-major
      4F columns, so that no collective runs inside the recurrence and
      each rank launches the kernels' one-direction instances.  At odd M
      the BiLSTM is replicated;
    - every other layer is replicated: the unidirectional ``_FastLSTM``,
      the GRU and simple cells (whose Dense kernels the JAX rule would
      shard), Conv1d, BatchNorm, the embeddings and the VAE.  They have
      no sharded forward in the port; the JAX step runs them through
      GSPMD's collectives.

    ``axis_name`` is accepted for the JAX signature: the model axis is
    the mesh's ``model`` group.
    """
    M = model_size(mesh)
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    out = {}
    for name, x in params.items():
        dim = None
        if M > 1 and _DENSE.search(name) and x.dim() >= 2 \
                and x.shape[-1] % M == 0 \
                and x.shape[-1] // M >= min_shard_size:
            dim = x.dim() - 1
        elif M > 1 and M % 2 == 0 and _BILSTM.search(name) \
                and x.shape[0] == 2:
            dim = 0
        out[name] = dim
    return out


class ModelShard:
    """How a parameter is split over the model group: along ``dim`` in
    ``parts`` pieces (M, or 2 for a BiLSTM's directions); model rank r
    holds piece ``r % parts``.  A parameter in fewer pieces than M is
    held by M / parts ranks of the row, each of which runs it on a block
    of the rows (the BiLSTM at M >= 4)."""

    def __init__(self, dim, parts):
        self.dim = int(dim)
        self.parts = int(parts)

    def index(self, mesh):
        return mesh.model.rank % self.parts

    def holds_first(self, mesh):
        """Whether this rank is the first holder of its piece (the one
        that gives it to a gather and counts it in a norm)."""
        return mesh.model.rank < self.parts

    def piece(self, x, mesh):
        size = x.shape[self.dim] // self.parts
        return x.narrow(self.dim, self.index(mesh) * size, size)


def shard_of(tensor):
    """The :class:`ModelShard` of a sharded parameter, else None."""
    return getattr(tensor, "model_shard", None)


def shard_module(module, mesh, shardings=None):
    """Replace each parameter of ``module`` that ``shardings`` (default
    :func:`make_param_shardings`) shards by this rank's piece, tagged
    with its :class:`ModelShard` (``param.model_shard``), and give its
    owning layer the mesh (``layer.model_mesh``), which turns on the
    layer's sharded forward.  Returns ``module``.  Optimisers built on the
    old parameters must be rebuilt."""
    M = model_size(mesh)
    if M == 1:
        return module
    if shardings is None:
        shardings = make_param_shardings(module, mesh)
    for name, dim in shardings.items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        old = getattr(owner, leaf)
        shard = ModelShard(dim, min(M, old.shape[dim]))
        new = torch.nn.Parameter(shard.piece(old.detach(), mesh).clone(),
                                 requires_grad=old.requires_grad)
        new.model_shard = shard
        setattr(owner, leaf, new)
        owner.model_mesh = mesh
    return module


def module_shards(module):
    """{state-dict name: :class:`ModelShard`} of a sharded module."""
    return {k: shard_of(v) for k, v in module.state_dict(
        keep_vars=True).items() if shard_of(v) is not None}


def shard_state_dict(state, module, mesh):
    """A one-device state dict (the port's layout, as
    ``models/convert.py`` gives it) cut to this rank's pieces of the
    sharded ``module``'s parameters; other entries pass as they are."""
    shards = module_shards(module)
    return {k: shards[k].piece(v, mesh).clone() if k in shards else v
            for k, v in state.items()}


def gather_tensor(x, shard, mesh):
    """The whole of a parameter (or a value shaped as it, such as an
    optimiser moment) of which this rank holds its ``shard`` piece
    ``x``, on every rank of the model group: a sum of zero-padded
    buffers in which only each piece's first holder gives it."""
    shape = list(x.shape)
    shape[shard.dim] *= shard.parts
    with torch.no_grad():
        full = x.new_zeros(shape, dtype=_reduce_dtype(x.dtype))
        if shard.holds_first(mesh):
            size = x.shape[shard.dim]
            full.narrow(shard.dim, shard.index(mesh) * size, size).copy_(x)
        dist.all_reduce(full, group=mesh.model.group)
        return full.to(x.dtype)


def gather_state_dict(module, mesh, state=None):
    """The one-device state dict of a sharded ``module`` (or of ``state``,
    a dict named as its state dict, such as EMA shadows) on every rank:
    a collective over the model group, which every rank must call."""
    shards = module_shards(module)
    if state is None:
        state = module.state_dict()
    return {k: gather_tensor(v, shards[k], mesh) if k in shards else v
            for k, v in state.items()}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (each rank's part of dL/dx from its shard)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        work = g.to(_reduce_dtype(g.dtype)).contiguous()
        dist.all_reduce(work, group=ctx.mesh.model.group)
        return work.to(g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """The global tensor of ``shape`` of which each rank of the model
    group gives the block ``index`` (None: gives nothing): a sum of
    zero-padded buffers; the backward takes the rank's block."""

    @staticmethod
    def forward(ctx, x, mesh, shape, index):
        ctx.index = index
        ctx.x_shape = x.shape
        full = x.new_zeros(shape, dtype=_reduce_dtype(x.dtype))
        if index is not None:
            full[index] = x.detach().to(full.dtype)
        dist.all_reduce(full, group=mesh.model.group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.index is None:
            return g.new_zeros(ctx.x_shape), None, None, None
        return g[ctx.index].contiguous(), None, None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over a group's ranks; the backward sums the
    gradient over them too (each rank's part of dL/dsum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, mesh):
    """The sum of ``x`` over the ranks of ``mesh``, differentiable."""
    return _AllReduceSum.apply(x, mesh.group)


def copy_to_model(x, mesh):
    """``x``, replicated over the model group, entering a sharded layer:
    its gradient is summed over the group."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x, mesh, shape, index):
    """The tensor of ``shape`` whose block ``index`` (a tuple of slices)
    is this rank's ``x``, on every rank of the model group; None gives
    nothing (a rank whose piece another rank gives).  The gradient of
    ``x`` is the rank's block of the output's."""
    return _GatherFromModel.apply(x, mesh, tuple(shape), index)


def direction_rows(rows, mesh):
    """The BiLSTM's work of this rank over a batch of ``rows`` rows:
    ``(direction, start, stop, gives)``.  Model rank r runs direction
    r % 2 on row block r // 2 of M / 2 blocks (as even as they divide);
    with fewer rows than blocks every rank runs all rows and only block
    0 gives its output to the gather.  At M = 2 a rank runs all rows."""
    r = mesh.model.rank
    blocks, block = mesh.model.size // 2, r // 2
    if rows < blocks:
        return r % 2, 0, rows, block == 0
    return (r % 2, block * rows // blocks, (block + 1) * rows // blocks,
            True)


def reduce_gradients(parameters, mesh, data_sharded=True, mean=False):
    """Complete the gradients of a tensor-parallel step in place: the
    pieces held by several ranks of a row (the BiLSTM at M >= 4) are
    summed over those ranks, then every gradient over the data group
    (averaged with ``mean``); a batch that did not shard over ``data``
    takes data rank 0's gradients instead."""
    grads = []
    for p in parameters:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    M = model_size(mesh)
    with torch.no_grad():
        split = [p.grad for p in parameters
                 if shard_of(p) is not None and shard_of(p).parts < M]
        if split and mesh.direction is not None:
            all_reduce_flat(split, mesh.direction.group)
        if not mesh.data.distributed:
            return
        if data_sharded:
            all_reduce_flat(grads, mesh.data.group)
            if mean:
                for g in grads:
                    g.div_(mesh.data.size)
        else:
            broadcast_flat(grads, mesh.data)


def global_norm(parameters, mesh):
    """The L2 norm of all gradients of a sharded model, the one-process
    value: squares summed over the model group, each piece counted on
    its first holder and each replicated parameter on model rank 0."""
    total = None
    for p in parameters:
        shard = shard_of(p)
        if (shard.holds_first(mesh) if shard is not None
                else mesh.model.rank == 0):
            sq = p.grad.to(torch.float32).pow(2).sum()
            total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), device=mesh.device)
    dist.all_reduce(total, group=mesh.model.group)
    return total.sqrt()


def make_tp_train_step(loss_fn, optimiser, mesh):
    """A ``(data, model)``-parallel train step: ``train_step(batch) ->
    loss``, for a model sharded with :func:`shard_module` and an
    optimiser built on its pieces.

    Each rank runs ``loss_fn(shard_batch(batch, mesh.data))`` (a scalar,
    the mean over its rows; the ranks of a model group run the same rows
    through their shards), backpropagates, and :func:`reduce_gradients`
    averages the gradients over the data group (a BiLSTM piece also
    summed over the ranks of a row that hold its direction, M >= 4)
    before ``optimiser.step()``; the returned loss is the data group's
    mean.  Sharded pieces stay shard-local, as in the JAX step."""
    params = [p for group in optimiser.param_groups for p in group["params"]]

    def train_step(batch):
        optimiser.zero_grad(set_to_none=False)
        loss = loss_fn(shard_batch(batch, mesh.data))
        loss.backward()
        reduce_gradients(params, mesh, mean=True)
        optimiser.step()
        loss = loss.detach().clone()
        if mesh.data.distributed:
            dist.all_reduce(loss, group=mesh.data.group)
            loss = loss / mesh.data.size
        return loss

    return train_step
