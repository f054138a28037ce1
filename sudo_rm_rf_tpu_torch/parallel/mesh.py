"""A (data, model) grid of ranks and its sharding rules (counterpart of
``sudo_rm_rf_tpu/parallel/mesh.py``).

One process is one rank, with one explicit device. A :class:`Mesh` lays the
ranks of a ``torch.distributed`` launch out as JAX lays devices out
(``np.reshape(n_data, n_model)``): rank ``r`` of the grid sits at ``(r //
n_model, r % n_model)``. The ranks of one row (one data index) form its
*model group*: they hold the same rows of a batch and split the model
between them (storage and compute tensor parallelism). The ranks of one
column (one model index) form its *data group*: they hold different rows,
and their gradients are averaged.

Without an initialized process group the mesh is the one-process (1, 1)
grid, and nothing communicates.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the environment a torchrun (torch.distributed.run) launch sets
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether this process is a rank of a torchrun launch."""
    return all(k in os.environ for k in LAUNCH_ENV)


def rank_device(device=None, share_device: bool = False) -> torch.device:
    """The device of this rank: ``device`` if it names an index or is not
    CUDA, else ``cuda:LOCAL_RANK``. Where a host's ranks outnumber its cards
    it raises, unless ``share_device`` (then rank ``LOCAL_RANK`` takes card
    ``LOCAL_RANK % count``). Outside a launch: ``device`` (default cuda)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or device.index is not None or not launched():
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: no CUDA device is available")
    count = torch.cuda.device_count()
    local = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
    if local_world > count and not share_device:
        raise RuntimeError(
            f"{local_world} ranks on a host with {count} CUDA device(s): launch at most "
            f"{count} a host, or ask for ranks that share a card (share_device=True)")
    return torch.device("cuda", local % count)


def maybe_distributed_initialize(backend: Optional[str] = None, device=None,
                                 share_device: bool = False) -> bool:
    """Join the process group of a torchrun launch when its environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) is set, else do nothing. Returns whether it joined.

    The backend is ``nccl`` for a CUDA rank and ``gloo`` for a CPU one,
    unless ``backend`` names one; an NCCL group is created eagerly on the
    rank's card, so a failing NCCL init raises here (it never turns into
    gloo). The rank's device is :func:`rank_device` of ``device`` and
    ``share_device``; a CUDA rank makes it the current device."""
    import torch.distributed as dist

    if not launched():
        return False
    if dist.is_initialized():
        return True
    device = rank_device(device, share_device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=600), **kwargs)
    return True


@contextlib.contextmanager
def launch_group(device=None):
    """Inside: whether this process is a rank of a process group, joined by
    :func:`maybe_distributed_initialize` (``device`` as it takes it) unless
    the caller joined one already; a group joined here is left on exit."""
    import torch.distributed as dist

    joined_before = dist.is_available() and dist.is_initialized()
    joined = joined_before or maybe_distributed_initialize(device=device)
    try:
        yield joined
    finally:
        if joined and not joined_before:
            dist.destroy_process_group()


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, model) grid of ranks.

    grid: (n_data, n_model) global ranks; rank: this process's global rank;
    data_group / model_group: the process groups of this rank's column and
    row (None outside the grid, or without a process group: then nothing
    communicates). A group of one rank is kept, so its collectives still run
    through the backend (an NCCL rank alone launches NCCL's kernels).
    """

    grid: np.ndarray
    rank: int
    data_group: object = None
    model_group: object = None

    def __deepcopy__(self, memo):
        # a model that holds the mesh is deep-copied (fast_inference.cast_model);
        # the process groups are the launch's, and the mesh is immutable
        return self

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.grid.shape[0], MODEL_AXIS: self.grid.shape[1]}

    @property
    def n_data(self) -> int:
        return self.grid.shape[0]

    @property
    def n_model(self) -> int:
        return self.grid.shape[1]

    @property
    def member(self) -> bool:
        return bool((self.grid == self.rank).any())

    @property
    def coords(self) -> tuple:
        """(data index, model index) of this rank."""
        where = np.argwhere(self.grid == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh {self.grid.tolist()}")
        return int(where[0, 0]), int(where[0, 1])

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (data, model) mesh; defaults to every rank on the data axis.

    Takes the first ``n_data * n_model`` of ``ranks`` (default: every rank
    of the launch) in order, as JAX takes devices. Every rank of the launch
    must call it with the same arguments, members or not: each data and
    model group is a ``torch.distributed.new_group``."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data < 1 or n_data * n_model > len(ranks):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; "
                         f"have {len(ranks)}")
    grid = np.asarray(ranks[: n_data * n_model]).reshape(n_data, n_model)
    groups = {}
    if initialized:
        # every rank enters every new_group, in one order
        for axis, lines in (("data", grid.T), ("model", grid)):
            for line in lines:
                group = dist.new_group(line.tolist())
                if rank in line:
                    groups[axis] = group
    return Mesh(grid=grid, rank=rank, data_group=groups.get("data"),
                model_group=groups.get("model"))


def batch_rows(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch that this rank's data index owns. The
    batch must divide the data axis."""
    if batch_size % mesh.n_data:
        raise ValueError(
            f"batch size {batch_size} must be divisible by the data-parallel mesh size "
            f"{mesh.n_data}; pad the batch or build the trainer with a smaller mesh "
            f"(make_mesh(n_data=...))")
    per = batch_size // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a tensor or array, or a tuple or
    list of them, batch-major)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    return batch[batch_rows(mesh, batch.shape[0])]


def tp_param_shardings(named_params, mesh: Mesh, min_size: int = 256) -> dict:
    """Name -> ``MODEL_AXIS`` for each param stored as row shards over the
    model group, None for each param every rank holds whole.

    JAX's rule: a param of 2 or more dims whose leading (output-channel) dim
    divides ``n_model`` and that has at least ``min_size`` elements is
    sharded on dim 0 (for SuDoRM-RF the bottleneck, the blocks' 1x1 convs,
    the mask head and the decoder); every other param is replicated."""
    n_model = mesh.n_model

    def rule(p):
        shape = tuple(p.shape)
        if (len(shape) >= 2 and n_model > 1 and shape[0] % n_model == 0
                and int(np.prod(shape)) >= min_size):
            return MODEL_AXIS
        return None

    return {name: rule(p) for name, p in named_params}


@dataclass(frozen=True)
class RowShards:
    """The params a trainer stores as row shards over its model group
    (storage tensor parallelism): ``shapes`` maps each such param's name to
    its whole shape; this rank holds rows ``[index * r, (index + 1) * r)``
    of dim 0, r = shape[0] // n, and every other param whole."""

    shapes: dict
    group: object
    index: int
    n: int

    def __deepcopy__(self, memo):
        return self

    def __contains__(self, name: str) -> bool:
        return name in self.shapes

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole tensor of ``name`` (others as they are)."""
        if name not in self.shapes:
            return whole
        rows = whole.shape[0] // self.n
        return whole[self.index * rows : (self.index + 1) * rows]

    def local_state_dict(self, state_dict: dict) -> dict:
        return {k: self.local(k, v) for k, v in state_dict.items()}

    def whole(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor of ``name`` from every rank's rows (a collective
        over the model group; others as they are)."""
        from sudo_rm_rf_tpu_torch.parallel.collectives import all_gather_rows

        if name not in self.shapes:
            return part
        return all_gather_rows(part.detach(), self.group)


def shard_params(model, mesh: Mesh) -> Optional[RowShards]:
    """Store ``model``'s params chosen by :func:`tp_param_shardings` as this
    rank's row shards, in place (new ``nn.Parameter``s), and return their
    :class:`RowShards`; None (and nothing changed) on a model group of one
    or where no param qualifies."""
    specs = tp_param_shardings(model.named_parameters(), mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if specs[n]}
    if not shapes:
        return None
    shards = RowShards(shapes, mesh.model_group, mesh.model_index, mesh.n_model)
    for name in shards.shapes:
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner)
        whole = getattr(module, attr)
        setattr(module, attr, torch.nn.Parameter(
            shards.local(name, whole.detach()).clone(), requires_grad=whole.requires_grad))
    return shards
