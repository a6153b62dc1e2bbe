"""Groups of ranks: the port's counterpart of ``recognizer3d_tpu/parallel/mesh.py``.

The JAX package drives its devices from one process through a mesh. Here
each rank is a process of its own, so that the host work of one card
(launches, host prep) does not serialise that of the others:

- :class:`RankPool` starts D ranks on a list of devices. The caller's
  process is rank 0; ranks 1..D-1 are spawned (``spawn``, never ``fork``:
  CUDA cannot fork) and live across calls until :meth:`RankPool.close`. A
  device may repeat in the list: ranks then share a card.
- The ranks form one ``torch.distributed`` group on the gloo backend,
  which meets through a ``FileStore`` in a temporary directory (no TCP
  port to collide) and bounds every operation by a timeout of at most a
  minute. Gloo sends only host memory, so device tensors are staged
  through pinned host buffers (:func:`exchange`).
- :meth:`RankPool.run` runs one function on every rank (SPMD, as a
  ``shard_map`` body runs on every device); the function exchanges data
  through the helpers below. Commands and small results travel over a
  pipe per worker, outside the group: an idle worker waits on its pipe
  with no timeout, and a worker that raises reports its traceback there
  and exits, which closes its connections, so no rank stays blocked in a
  receive from it. Any failure ends the whole pool: the workers are joined
  or killed on every exit path.
- The kernels are built once, in rank 0, before the workers start; the
  workers load the library. Launch counts (``ops/_build.LAUNCHES``) and the
  session recall guard (``ops/knn``) are per process: :func:`launches` and
  :func:`peak_memory_bytes` read a rank's own, and the serving classes hand
  rank 0's guard to the workers on every call.

The helpers read this process's place in the running group (:func:`rank`,
:func:`world`, :func:`device`); outside :meth:`RankPool.run` a process is
rank 0 of 1 with no device of its own, and every exchange is the
identity.
"""

import os
import pickle
import shutil
import tempfile
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from recognizer3d_tpu_torch.utils.device import resolve_device

#: seconds any group operation, the rendezvous and a worker's reply may take
TIMEOUT_S = 60.0

# this process's place in the running group, and the objects each rank
# keeps across calls (replicated models), by key
_place = {"rank": 0, "world": 1, "device": None}
_local: Dict[str, object] = {}


def rank() -> int:
    return _place["rank"]


def world() -> int:
    return _place["world"]


def device() -> torch.device:
    """This rank's device (only inside :meth:`RankPool.run`: outside it a
    process has no rank's device, and nothing falls back to the CPU)."""
    if _place["device"] is None:
        raise RuntimeError("no rank of a pool runs here: call this inside RankPool.run")
    return _place["device"]


def local() -> Dict[str, object]:
    """This rank's objects kept across calls (replicated models), by key."""
    return _local


def devices_for(n: int, device_type: str = "cuda") -> List[str]:
    """The device list of ``n`` ranks, the counterpart of
    ``data_parallel_mesh(n)``: on ``cuda`` the first ``n`` visible cards (-1:
    all), refused beyond them; on ``cpu`` any ``n`` ranks on the CPU (the
    counterpart of JAX's virtual CPU devices; -1: one)."""
    if device_type == "cpu":
        return ["cpu"] * (1 if n == -1 else n)
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == -1:
        n = available
    if not 1 <= n <= available:
        raise ValueError(f"requested {n} devices, only {available} available")
    return [f"cuda:{i}" for i in range(n)]


def normalize_device(dev) -> torch.device:
    """``dev`` as a torch device with its card's index (``cuda`` is the current
    card); raises where ``resolve_device`` does."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# --- exchanges ------------------------------------------------------------


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as a flat uint8 host tensor (pinned for a device
    tensor), ready for gloo, which moves bytes of any dtype this way."""
    flat = t.contiguous().view(-1).view(torch.uint8)
    if flat.device.type == "cpu":
        return flat
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return host


def _nbytes(shape, dtype) -> int:
    n = torch.Size(shape).numel()
    return n * torch.empty((), dtype=dtype).element_size()


def exchange(
    sends: Sequence[Tuple[torch.Tensor, int]],
    recvs: Sequence[Tuple[tuple, torch.dtype, int]],
    dev: Optional[torch.device] = None,
) -> List[torch.Tensor]:
    """Point-to-point: send each ``(tensor, peer)`` and receive each
    ``(shape, dtype, peer)``, all posted at once and then waited for (so
    no pairing of sends and receives can deadlock). Messages between two
    ranks match in the order they are posted. Returns the received tensors
    on ``dev`` (default: this rank's device)."""
    dev = device() if dev is None else dev
    pinned = dev.type == "cuda"
    staged = [(_to_host(t), peer) for t, peer in sends]
    boxes = [
        (torch.empty(_nbytes(shape, dtype), dtype=torch.uint8, pin_memory=pinned), shape, dtype)
        for shape, dtype, _ in recvs
    ]
    works = [dist.isend(buf, peer) for buf, peer in staged]
    works += [dist.irecv(box, peer) for (box, _, _), (_, _, peer) in zip(boxes, recvs)]
    for work in works:
        work.wait()
    return [box.to(dev, non_blocking=True).view(dtype).view(shape) for box, shape, dtype in boxes]


@dataclass(frozen=True)
class Ring:
    """The ranks of one point axis: ``size`` consecutive ranks from rank
    ``base``. The whole group is one ring; on a (dp, sp) grid of ranks
    (rank = row · sp + column, as a JAX mesh of axes ("batch", "points")
    numbers its devices) each row is a ring of its own."""

    size: int
    base: int = 0

    @property
    def position(self) -> int:
        """This rank's place on the ring."""
        return rank() - self.base

    def peer(self, position: int) -> int:
        """The rank at ``position`` (taken modulo the size) on the ring."""
        return self.base + position % self.size


def ring(batch_shards: int = 1) -> Ring:
    """This rank's ring when the group forms a grid of ``batch_shards``
    rows (1: the whole group)."""
    d = world()
    if batch_shards < 1 or d % batch_shards:
        raise ValueError(f"{d} ranks do not form {batch_shards} rows")
    size = d // batch_shards
    return Ring(size, rank() - rank() % size)


def rotate(tensors: Sequence[torch.Tensor], on: Optional[Ring] = None) -> List[torch.Tensor]:
    """The ring step (``lax.ppermute`` to position + 1): send ``tensors`` to
    the next rank of the ring ``on`` (default: the whole group) and return
    the previous one's. The identity on a ring of one (gloo refuses a send
    to self)."""
    on = ring() if on is None else on
    if on.size == 1:
        return list(tensors)
    me = on.position
    # a range the profiler reads (profile_port.py): the ring's share of a call
    with torch.profiler.record_function("r3d.rotate"):
        return exchange(
            [(t, on.peer(me + 1)) for t in tensors],
            [(tuple(t.shape), t.dtype, on.peer(me - 1)) for t in tensors],
            tensors[0].device,
        )


def replicate(obj=None):
    """Rank 0's ``obj`` on every rank (a pickled broadcast): settings,
    metadata, a ``state_dict`` (on the host)."""
    if world() == 1:
        return obj
    box = [obj if rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def block_of(full: torch.Tensor, r: int, axis: int, batch_shards: int = 1) -> torch.Tensor:
    """Rank ``r``'s block of ``full``, a view: block sharding along ``axis``
    over the group's ranks (as ``P("data")`` or ``P(None, "points")``). On
    a grid of ``batch_shards`` rows (``P("batch", "points")``; rank = row ·
    columns + column, as :func:`ring` numbers them), its row's block of axis
    0 and its column's block of ``axis``."""
    columns = world() // batch_shards
    rows = full.chunk(batch_shards, dim=0)[r // columns] if batch_shards > 1 else full
    return rows.chunk(columns, dim=axis)[r % columns]


def scatter_blocks(full: Optional[torch.Tensor], axis: int, shape, dtype,
                   batch_shards: int = 1) -> torch.Tensor:
    """Rank 0's host tensor ``full`` of ``shape`` and ``dtype`` (which every
    rank passes) cut into ``world()`` equal blocks along ``axis`` (block
    sharding, as ``P("data")`` or ``P(None, "points")``); returns this
    rank's block, on the host. With ``batch_shards`` > 1 the ranks form that
    many rows (``P("batch", "points")``): rank r takes row r // (D /
    batch_shards)'s block of axis 0 and its column's block of ``axis``."""
    d, me = world(), rank()
    if d == 1:
        return full
    shape = list(shape)
    sp = d // batch_shards
    if shape[axis] % sp or shape[0] % batch_shards:
        raise ValueError(f"{tuple(shape)} does not split over {batch_shards} x {sp} ranks "
                         f"(axes 0 and {axis})")
    shape[axis] //= sp
    if batch_shards > 1:
        shape[0] //= batch_shards
    cpu = torch.device("cpu")
    if me == 0:
        exchange([(block_of(full, r, axis, batch_shards), r) for r in range(1, d)], [], cpu)
        return block_of(full, 0, axis, batch_shards)
    return exchange([], [(tuple(shape), dtype, 0)], cpu)[0]


def gather_blocks(block: torch.Tensor, axis: int,
                  batch_shards: int = 1) -> Optional[torch.Tensor]:
    """The inverse of :func:`scatter_blocks`: every rank's host ``block``
    (equal shapes) joined along ``axis`` (and, on a grid, the rows along
    axis 0) on rank 0; None elsewhere."""
    d, me = world(), rank()
    if d == 1:
        return block
    cpu = torch.device("cpu")
    if me != 0:
        exchange([(block, 0)], [], cpu)
        return None
    parts = [block] + exchange([], [(tuple(block.shape), block.dtype, r)
                                    for r in range(1, d)], cpu)
    sp = d // batch_shards
    rows = [torch.cat(parts[i:i + sp], dim=axis) for i in range(0, d, sp)]
    return torch.cat(rows, dim=0)


# --- per-rank readings --------------------------------------------------------


def launches() -> Dict[str, int]:
    """This rank's kernel launch counts (``ops/_build.reset_launches`` sets
    them to 0)."""
    from recognizer3d_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def peak_memory_bytes() -> int:
    """The largest device memory this rank has allocated since the last
    :func:`reset_peak_memory` (0 on the CPU)."""
    dev = device()
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak_memory() -> None:
    dev = device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def forget(key: str) -> None:
    """Drop a kept object of this rank."""
    _local.pop(key, None)


# --- the pool -------------------------------------------------------------------


def _init_group(store: str, r: int, d: int) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=r, world_size=d,
        timeout=timedelta(seconds=TIMEOUT_S),
    )


def _worker_main(r: int, d: int, store: str, dev: str, conn) -> None:
    """A worker rank: join the group, then run each command that arrives on
    the pipe until ``None`` (or the pipe closes), answering ``("ok",
    result)``; on an exception answer ``("error", traceback)`` and exit at
    once, which closes this rank's connections."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    _place.update(rank=r, world=d, device=dev)
    try:
        _init_group(store, r, d)
    except BaseException:
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        os._exit(1)
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            break
        if msg is None:
            break
        fn, args, kwargs = msg
        try:
            reply = ("ok", fn(*args, **kwargs))
        except BaseException:
            try:
                conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
            finally:
                os._exit(1)
        conn.send_bytes(pickle.dumps(reply))
    _local.clear()
    dist.destroy_process_group()
    conn.close()


class RankPool:
    """D ranks on ``devices`` (rank r on ``devices[r]``; the caller is rank
    0, on ``devices[0]``). Use as a context manager, or call :meth:`close`.

    A process runs one pool at a time (it owns the process's default
    group). After any failure of :meth:`run` the pool is closed."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a pool needs at least one device")
        self.devices = [normalize_device(d) for d in devices]
        self._procs, self._conns = [], []
        self._dir = None
        self.closed = False
        if self.n_ranks == 1:
            return
        if dist.is_initialized():
            raise RuntimeError("this process already runs a group of ranks; close its pool first")
        if any(d.type == "cuda" for d in self.devices):
            from recognizer3d_tpu_torch.ops import _build

            _build.library()  # build once here; the workers load it
        self._dir = tempfile.mkdtemp(prefix="r3d_ranks_")
        store = os.path.join(self._dir, "store")
        ctx = torch.multiprocessing.get_context("spawn")
        try:
            for r in range(1, self.n_ranks):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main,
                    args=(r, self.n_ranks, store, str(self.devices[r]), child),
                    daemon=True,
                )
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
            _init_group(store, 0, self.n_ranks)
        except BaseException as exc:
            self._abort()
            raise RuntimeError(f"starting {self.n_ranks} ranks failed{self._worker_errors()}") \
                from exc

    @property
    def n_ranks(self) -> int:
        return len(self.devices)

    @contextmanager
    def _as_rank0(self):
        saved = dict(_place)
        _place.update(rank=0, world=self.n_ranks, device=self.devices[0])
        try:
            yield
        finally:
            _place.update(saved)

    def run(self, fn, *args, root=None, **kwargs) -> List[object]:
        """Call ``fn(*args, **kwargs)`` on every rank and return the results,
        rank 0's first. ``fn`` must be importable by name in a worker, which
        imports its module: a module-level function of this package, or of
        a helper that imports no more than it does. With
        ``root`` given, rank 0's call also gets ``root=root`` and the workers'
        ``root=None``: data that only rank 0 has, which ``fn`` then sends
        through the group. Workers' results travel pickled: keep them
        small, on the host."""
        if self.closed:
            raise RuntimeError("the pool is closed")
        if root is not None:
            kwargs = dict(kwargs, root=None)
        msg = pickle.dumps((fn, args, kwargs))
        try:
            for conn in self._conns:
                conn.send_bytes(msg)
            with self._as_rank0():
                own = fn(*args, **(kwargs if root is None else dict(kwargs, root=root)))
            results = [own]
            for r, conn in enumerate(self._conns, start=1):
                if not conn.poll(TIMEOUT_S):
                    raise TimeoutError(f"rank {r} did not answer within {TIMEOUT_S} s")
                status, value = pickle.loads(conn.recv_bytes())
                if status != "ok":
                    raise RuntimeError(f"rank {r} failed:\n{value}")
                results.append(value)
            return results
        except BaseException as exc:
            errors = self._worker_errors()
            self._abort()
            if errors:
                raise RuntimeError(f"{type(exc).__name__}: {exc}{errors}") from exc
            raise

    def _worker_errors(self) -> str:
        """The tracebacks that failed workers left on their pipes."""
        out = []
        for r, conn in enumerate(self._conns, start=1):
            try:
                if conn.poll(0.5):
                    status, value = pickle.loads(conn.recv_bytes())
                    if status == "error":
                        out.append(f"\nrank {r} failed:\n{value}")
            except (EOFError, OSError, pickle.UnpicklingError):
                pass
        return "".join(out)

    def _abort(self) -> None:
        """Kill the workers and leave the group."""
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
        self._finish()

    def _finish(self) -> None:
        for proc in self._procs:
            proc.join(TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if dist.is_initialized() and self.n_ranks > 1:
            dist.destroy_process_group()
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
        self.closed = True

    def close(self) -> None:
        """Stop the workers (each leaves the group and exits) and join them;
        one that does not exit within the timeout is killed."""
        if self.closed:
            return
        for conn in self._conns:
            try:
                conn.send_bytes(pickle.dumps(None))
            except OSError:
                pass
        self._finish()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            if not self.closed:
                self._abort()
        except Exception:  # noqa: BLE001 — at interpreter exit
            pass


# --- shard_map ------------------------------------------------------------------


def _shard(x, axis: int):
    if isinstance(x, torch.Tensor) and x.dim() > axis:
        return block_of(x, rank(), axis).to(device())
    return x


def _to_numpy(out):
    """Tensors (nested in tuples) as numpy on the host; bfloat16, which numpy
    lacks, as float32 (exactly)."""
    if isinstance(out, torch.Tensor):
        out = out.cpu()
        return (out.float() if out.dtype == torch.bfloat16 else out).numpy()
    if isinstance(out, tuple):
        return tuple(_to_numpy(o) for o in out)
    return out


def shard_map_rank(fn, args, kwargs, axis: int = 1):
    """The body of :meth:`RankPool.shard_map` on one rank: this rank's
    block of every tensor argument along ``axis``, on this rank's device,
    through ``fn``; the result's tensors back on the host, as numpy."""
    args = [_shard(a, axis) for a in args]
    with torch.inference_mode():
        return _to_numpy(fn(*args, **kwargs))


def shard_map(pool: RankPool, fn, *args, axis: int = 1, out_axis: Optional[int] = None,
              **kwargs):
    """``fn`` over point-sharded inputs, as ``shard_map`` with every spec
    ``P(None, "points")``: each rank runs ``fn`` on its block (along
    ``axis``) of every tensor argument (others pass as they are); the
    blocks of the result (numpy, or a tuple of them) are joined along
    ``out_axis`` (default ``axis``). Every argument travels to every rank:
    for tests and small inputs."""
    import numpy as np

    out_axis = axis if out_axis is None else out_axis
    outs = pool.run(shard_map_rank, fn, args, kwargs, axis)
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate(parts, axis=out_axis) for parts in zip(*outs))
    return np.concatenate(outs, axis=out_axis)
