"""Data parallelism over a torch.distributed process group (port of
`kd6d_pose_adlp_tpu/parallel/mesh.py`).

JAX jits the whole train step over a 1-D `Mesh('data')`: batch-sharded
inputs, replicated parameters, and XLA inserts the collectives, so the step
has global semantics (BatchNorm statistics and loss sums over the global
batch, the gradient of the global loss). The port runs one process per
device, PyTorch's idiom: one rank is one device of JAX's mesh, and the
collectives are explicit (`models/blocks.BatchNorm2d`,
`engine/losses.kd_ot_loss`, `engine/steps`).

- `DataMesh`: this process's rank, the group's size and its device.
  `make_mesh` reads it from the initialized default group; `init_from_env`
  initializes that group from torchrun's environment; `spawn` starts W
  ranks on this host for a single command, as torchrun would.
- `shard_batch` is this rank's rows of a global batch, `replicate`
  broadcasts rank 0's state.
- `all_reduce_sum` is an autograd all-reduce (sum) whose backward
  all-reduces the gradient: right when each rank's loss is its local part
  of the global sum. `all_reduce_` sums tensors in place, without gradient,
  in one flat buffer per dtype.
- `gather_host_objects` and `gather_eval_pytree` merge evaluation results
  across ranks, as JAX's multi-host gathers do.

Every collective is an all-reduce or a broadcast, the two that gloo takes
on CUDA tensors as well as on CPU ones (two ranks on one card need gloo:
NCCL refuses two ranks on one device). An all-gather is an all-reduce of a
zero buffer that holds each rank's part in its own slot. On a single
process every function is the identity, as JAX's are.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank of a data mesh, the default process group: `rank` of
    `size` processes, each driving one device."""
    rank: int
    size: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        return self.size > 1


def process_count() -> int:
    """The default group's size; 1 without an initialized process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DataMesh:
    """This process's rank of the data mesh: the initialized default group
    (a single process without one), on `device`. `n_devices` (None or 0:
    the group's size) must be the group's size, since a rank is a device;
    JAX's `make_mesh` takes the first n devices of its one process."""
    size, rank = process_count(), process_index()
    n = n_devices or size
    if n != size:
        raise ValueError(f"a data mesh of {n} devices needs a process group of {n} "
                         f"ranks, one a device; this process's group has {size} "
                         "(launch with torchrun, or train_kd --n_devices)")
    return DataMesh(rank=rank, size=size, device=_resolve(device))


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def init_from_env(cpu: bool = False, device=None, backend: Optional[str] = None) -> DataMesh:
    """Initializes the default process group from torchrun's variables
    (`TORCHRUN_ENV`; a missing one raises, naming it) and returns this
    rank's mesh. The device is the card of LOCAL_RANK (the CPU under
    `cpu`) unless `device` is given; the backend is NCCL on the card and
    gloo on the CPU unless `backend` is given. A failed initialization
    raises; nothing falls back."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"distributed run without torchrun's environment: "
                           f"{', '.join(missing)} not set")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device is None:
        if cpu:
            device = "cpu"
        else:
            n_cards = torch.cuda.device_count()
            if local >= n_cards:
                raise RuntimeError(f"local rank {local} needs card {local}, but "
                                   f"{n_cards} cards are visible")
            device = torch.device("cuda", local)
    device = _resolve(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=size)
    return DataMesh(rank=rank, size=size, device=device)


def _spawned(local_rank: int, fn: Callable, nprocs: int, port: int,
             num_threads: Optional[int], args: tuple, out_dir: str) -> None:
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if num_threads:
        torch.set_num_threads(num_threads)
    torch.save(fn(*args), os.path.join(out_dir, f"{local_rank}.pt"))


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          num_threads: Optional[int] = None) -> List[Any]:
    """Runs `fn(*args)` in `nprocs` new processes (the spawn start method:
    `fn` must be importable by its module path) with torchrun's variables
    set for ranks 0..nprocs-1 on a free localhost port, and `num_threads`
    intra-op threads each when given; returns their results by rank. `fn`
    initializes the group itself (`init_from_env`). A rank that raises
    stops the others and raises here."""
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, nprocs, free_port(), num_threads, args, out_dir),
            nprocs=nprocs, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(nprocs)]


def shard_batch(batch, mesh: DataMesh):
    """This rank's rows of a global host batch (a tensor, or a NamedTuple of
    tensors such as `data.batch.Batch`, with a leading batch axis), on its
    device: rank r takes the r-th of `mesh.size` equal blocks, the block
    JAX's batch sharding puts on device r."""
    leaves = [batch] if isinstance(batch, torch.Tensor) else list(batch)
    B = int(leaves[0].shape[0])
    if B % mesh.size:
        raise ValueError(f"a batch of {B} does not split over {mesh.size} ranks")
    n = B // mesh.size
    mine = [t[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device) for t in leaves]
    return mine[0] if isinstance(batch, torch.Tensor) else type(batch)(*mine)


def _flat_collective(tensors: Sequence[torch.Tensor], op: Callable) -> None:
    """Applies `op` to one flat buffer per (device, dtype) of `tensors` and
    copies the results back in place."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = _flatten_dense_tensors(ts)
        op(flat)
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


@torch.no_grad()
def replicate(state, mesh: DataMesh):
    """Rank 0's `steps.TrainState` on every rank: the network's parameters
    and buffers and the optimizer's moments broadcast in place; returns the
    state with rank 0's update count."""
    if not mesh.distributed:
        return state
    opt = state.opt_state
    _flat_collective(list(state.net.state_dict().values()) + list(opt.mu) + list(opt.nu),
                     lambda f: dist.broadcast(f, 0))
    count = torch.tensor([opt.count], dtype=torch.int64, device=_comm_device())
    dist.broadcast(count, 0)
    return state._replace(opt_state=opt._replace(count=int(count)))


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor], mesh: DataMesh) -> None:
    """Sums `tensors` over the ranks, in place, one flat all-reduce per
    dtype."""
    if mesh.distributed:
        _flat_collective(tensors, dist.all_reduce)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """sum over ranks of x, differentiable: the backward all-reduces the
    incoming gradient, which is the gradient of each rank's input when each
    rank's loss is its local part of one global sum. Every rank must call it
    in the same order, forward and backward."""
    if not mesh.distributed:
        return x
    return _AllReduceSum.apply(x)


def barrier(mesh: DataMesh) -> None:
    """Waits until every rank reaches it (an all-reduce of one element)."""
    if mesh.distributed:
        dist.all_reduce(torch.zeros(1, device=_comm_device()))


def pad_for_allgather(payload: bytes, cap: int) -> np.ndarray:
    """Fixed-shape uint8 buffer for a cross-process allgather (all processes
    must contribute identical shapes). Split out for unit testing."""
    assert len(payload) <= cap, (len(payload), cap)
    buf = np.zeros((cap,), np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    return buf


def _comm_device() -> torch.device:
    """Where host data meets the backend: the current card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every rank's x by rank, from one all-reduce (sum)
    of a zero buffer holding this rank's x in its own slot (exact: each
    entry adds zeros to one rank's value)."""
    size, rank = process_count(), process_index()
    kind = x.dtype
    if kind == torch.bool:
        x = x.to(torch.uint8)
    buf = torch.zeros((size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[rank] = x
    dist.all_reduce(buf)
    return buf.to(kind)


def gather_host_objects(obj) -> list:
    """All-gather a picklable host object across processes; returns the
    list of every process's object (this process's included). The sizes go
    first, then the pickled payloads ride one fixed-shape uint8 gather, as
    JAX's do. Identity (a 1-element list) on a single process."""
    if process_count() == 1:
        return [obj]
    dev = _comm_device()
    payload = pickle.dumps(obj)
    sizes = _all_gather(torch.tensor(len(payload), dtype=torch.int64, device=dev)).cpu().numpy()
    cap = int(sizes.max())
    gathered = _all_gather(torch.from_numpy(pad_for_allgather(payload, cap)).to(dev)).cpu().numpy()
    return [pickle.loads(gathered[i, :int(sizes[i])].tobytes())
            for i in range(gathered.shape[0])]


def gather_eval_pytree(tree):
    """Gather of fixed-shape evaluation arrays (tensors or numpy arrays in
    dicts, lists and tuples): every leaf gains a leading process axis, rank
    r's leaf at index r, as JAX's `multihost_utils.process_allgather`
    stacks them; `.reshape(-1, ...)` concatenates the ranks' leading axes.
    Every rank's leaf must have the same shape and dtype. The identity on a
    single process."""
    if process_count() == 1:
        return tree

    def leaf(x):
        if isinstance(x, np.ndarray):
            return _all_gather(torch.from_numpy(x).to(_comm_device())).cpu().numpy()
        return _all_gather(x)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return leaf(t)

    return walk(tree)
