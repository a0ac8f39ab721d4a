"""Data parallelism over ``torch.distributed``: the port of the data
half of ``idiaptts_tpu/parallel/mesh.py``.

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

Every collective is an ``all_reduce``, which both back ends take on CUDA
tensors (gloo copies through the host): a broadcast is a sum in which
every other rank gives zeros, a gather of rows a sum of zero-padded
global buffers.  Both sums are exact.  NCCL needs one card a rank; ranks
that share a card use gloo.

Tensor parallelism (the JAX ``make_2d_mesh``, ``make_param_shardings``
and ``make_tp_train_step``) is not ported.
"""

import os

import torch
import torch.distributed as dist


class DataMesh:
    """One rank's view of the data-parallel group: ``size`` ranks, this
    one ``rank``, its ``device``; ``axis_name`` is the JAX mesh axis's
    name."""

    def __init__(self, size, rank, device, axis_name="data"):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.axis_name = axis_name

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


def all_reduce_flat(tensors):
    """Sum ``tensors`` over the ranks in place, one flattened buffer (one
    collective) a type."""
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
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
        all_reduce_flat(work)
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
        dist.all_reduce(full)
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
        all_reduce_flat(grads)
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
            dist.all_reduce(loss)
            loss = loss / mesh.size
        return loss

    return train_step
