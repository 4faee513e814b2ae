"""Multi-host streaming ingest: process topology and the compressed
cross-host merge, on ``torch.distributed``.

The port of ``repro.dist.multihost``. Each host streams its own contiguous
shard of the global rows through ``StreamingSummarizer.ingest`` (rows never
leave the host that read them); then one exchange of compressed
``StreamState`` wire images gives every host the merged global state. What
crosses hosts is ``wire_pack`` bytes, never the data.

* ``initialize`` joins a multi-process cell: from its arguments or the
  ``REPRO_COORDINATOR`` (host:port), ``REPRO_NUM_PROCESSES`` and
  ``REPRO_PROCESS_ID`` environment it makes a ``TCPStore`` (process 0 is
  its server) and ``init_process_group`` over it, NCCL for a process that
  runs its collectives on the card, gloo on the CPU. With one process it
  does nothing and returns False. It keeps the store for
  ``cross_host_merge``; a caller may hand it a store of its own
  (``store=``, e.g. a ``FileStore``).
* ``process_topology`` / ``host_shard_range`` / ``host_groups``: the
  process's (rank, count); the balanced row range each host ingests (the
  first ``d % hosts`` hosts take one more row); and the ``(outer, inner)``
  process groups of the hierarchical reduce in ``core.distributed``.
* ``cross_host_merge`` / ``sharded_ingest``: the exchange goes through the
  store as bytes (in pieces of at most 4 MiB), sequence-numbered per call,
  and process 0 deletes a call's keys once every host has read them; every
  host reads all images
  and ``tree_merge``s them in ascending process order, so the merged state
  is bit-identical on every host. With ``tol`` each host votes the wire
  spec its own probe gate chooses, and the most precise vote wins.

>>> host_shard_range(10, hosts=4, host=0)   # balanced, ragged-tolerant
(0, 3)
>>> host_shard_range(10, hosts=4, host=3)
(8, 10)
>>> initialize()        # no coordinator configured: single-process no-op
False
>>> process_topology()
(0, 1)
>>> import torch
>>> from repro_torch import prng
>>> from repro_torch.core.streaming import StreamingSummarizer
>>> A, B = torch.randn(40, 6), torch.randn(40, 4)
>>> state = sharded_ingest(StreamingSummarizer(k=8, device="cpu"),
...                        prng.PRNGKey(0), (40, 6, 4),
...                        lambda lo, hi: (A[lo:hi], B[lo:hi]), chunk=16)
>>> int(state.rows_seen)        # one process ingests the whole range
40
"""
from __future__ import annotations

import datetime
import itertools
import os
from typing import Callable, Iterator, Optional, Tuple, Union

import torch.distributed as dist

from repro_torch import device as _device

# The store of the cell this process joined (``initialize``), which
# ``cross_host_merge`` exchanges its images through.
_STORE: Optional[dist.Store] = None

# One sequence per process: cross_host_merge is a collective, every host
# calls it as often, so the sequence numbers agree and the store keys of
# two merges never collide.
_MERGE_SEQ = itertools.count()

# Bytes a store value holds at most here: a libuv ``TCPStore`` (torch's
# default) refuses a payload above 8 MiB, so a wire image crosses in pieces.
_PIECE = 4 << 20


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    return int(raw) if raw else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               store: Optional[dist.Store] = None, device="cuda",
               timeout: float = 300.0) -> bool:
    """Join the multi-process cell, when one is configured.

    The arguments fall back to the ``REPRO_COORDINATOR`` (host:port),
    ``REPRO_NUM_PROCESSES`` and ``REPRO_PROCESS_ID`` environment. Without a
    coordinator (or ``store``), or with one process, nothing happens and
    the result is False; ``process_topology`` then reports ``(0, 1)``.
    Otherwise process ``process_id`` joins through a ``TCPStore`` at the
    coordinator's address (process 0 serves it) or through ``store``, and
    ``init_process_group`` takes NCCL when ``device`` is CUDA and gloo when
    it is the CPU (the device this process's collectives run on). The
    store's operations time out after ``timeout`` seconds. Returns True.
    """
    global _STORE
    if coordinator_address is None:
        coordinator_address = os.environ.get("REPRO_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("REPRO_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("REPRO_PROCESS_ID")
    if (coordinator_address is None and store is None) or not num_processes \
            or int(num_processes) <= 1:
        return False
    n, pid = int(num_processes), int(process_id or 0)
    dev = _device.resolve(device)
    wait = datetime.timedelta(seconds=timeout)
    if store is None:
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), n, is_master=pid == 0,
                              timeout=wait)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=pid, world_size=n,
                            timeout=wait)
    _STORE = store
    return True


def process_topology() -> Tuple[int, int]:
    """``(process index, process count)`` of the running cell; ``(0, 1)``
    outside one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_groups(hosts: Optional[int] = None):
    """``(outer, inner)`` process groups over the cell's processes laid out
    as ``hosts`` hosts of equal size, row-major: ``inner`` holds this
    process's host, ``outer`` one process of each host (those at this
    process's place on its host). Pass it as ``group=`` to
    ``core.distributed`` for the hierarchical reduce. ``hosts`` defaults to
    the process count (one process a host); a divisor of it emulates a
    hierarchy on one host's processes. Every process of the cell calls it
    (it creates groups)."""
    pid, n = process_topology()
    if not dist.is_initialized():
        raise RuntimeError("host_groups needs an initialized process group "
                           "(call dist.multihost.initialize first)")
    hosts = n if hosts is None else int(hosts)
    if hosts < 1 or n % hosts:
        raise ValueError(f"{n} processes do not split over {hosts} hosts")
    per = n // hosts
    inner = outer = None
    for h in range(hosts):
        g = dist.new_group(list(range(h * per, (h + 1) * per)))
        if h == pid // per:
            inner = g
    for j in range(per):
        g = dist.new_group(list(range(j, n, per)))
        if j == pid % per:
            outer = g
    return outer, inner


def host_shard_range(d: int, *, hosts: Optional[int] = None,
                     host: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous global row range ``[lo, hi)`` that ``host`` ingests.

    Balanced to within one row (the first ``d % hosts`` hosts take the
    extra), covering ``0..d`` once across the cell. Defaults describe the
    calling process."""
    pid, n = process_topology()
    hosts = n if hosts is None else int(hosts)
    host = pid if host is None else int(host)
    if hosts < 1 or not 0 <= host < hosts:
        raise ValueError(f"host {host} outside a {hosts}-host cell")
    if d < 0:
        raise ValueError(f"row count must be non-negative, got {d}")
    base, extra = divmod(d, hosts)
    lo = host * base + min(host, extra)
    return lo, lo + base + (1 if host < extra else 0)


def _store() -> dist.Store:
    if _STORE is None:
        raise RuntimeError(
            "cross_host_merge needs the coordinator's store (call "
            "dist.multihost.initialize first)")
    return _STORE


def _put(store: dist.Store, key: str, blob: bytes) -> None:
    """Set ``blob`` under ``key`` in pieces of at most ``_PIECE`` bytes;
    the piece count is set last, so a reader that sees it finds every
    piece."""
    n = max(1, -(-len(blob) // _PIECE))
    for j in range(n):
        store.set(f"{key}/{j}", blob[j * _PIECE:(j + 1) * _PIECE])
    store.set(f"{key}/n", str(n))


def _gather(store: dist.Store, prefix: str, nproc: int,
            wait: datetime.timedelta) -> list:
    """The values every process ``_put`` under ``prefix/<process>``, in
    process order, waiting at most ``wait`` for them."""
    store.wait([f"{prefix}/{i}/n" for i in range(nproc)], wait)
    out = []
    for i in range(nproc):
        n = int(store.get(f"{prefix}/{i}/n"))
        out.append(b"".join(store.get(f"{prefix}/{i}/{j}")
                            for j in range(n)))
    return out


def _release(store: dist.Store, prefix: str, pid: int, nproc: int,
             wait: datetime.timedelta) -> None:
    """Drop one merge's keys once every process has read them: each
    process marks itself done, and process 0 waits for all marks, then
    deletes the votes, the images and the marks, so that a cell that merges
    again and again holds no more in the store than one merge."""
    store.set(f"{prefix}/done/{pid}", b"1")
    if pid != 0:
        return
    store.wait([f"{prefix}/done/{i}" for i in range(nproc)], wait)
    for part in ("spec", "state"):
        for i in range(nproc):
            n = int(store.get(f"{prefix}/{part}/{i}/n"))
            for j in range(n):
                store.delete_key(f"{prefix}/{part}/{i}/{j}")
            store.delete_key(f"{prefix}/{part}/{i}/n")
    for i in range(nproc):
        store.delete_key(f"{prefix}/done/{i}")


def cross_host_merge(state, *, wire: Union[str, None] = None,
                     tol: Optional[float] = None, timeout: float = 60.0):
    """Merge the hosts' partial ``StreamState``s into the global state.

    A collective: every process calls it with its partial state and gets
    the same merged state, bit for bit (every host decompresses the same
    images and reduces them with the same ascending-process
    ``tree_merge``). The transfer is the wire format: ``wire`` names a
    ``WireSpec`` precision (default lossless f32), or ``tol`` turns on the
    probe-measured gate, each host votes ``choose_wire_spec`` of its own
    state and the most precise vote is everyone's. A single process
    returns the state unchanged. Waits at most ``timeout`` seconds for the
    other hosts' votes and images; the merged state lies on the state's
    device."""
    pid, nproc = process_topology()
    if nproc == 1:
        return state
    from repro_torch.core import streaming
    store = _store()
    seq = next(_MERGE_SEQ)
    wait = datetime.timedelta(seconds=timeout)
    if tol is not None:
        spec, _ = streaming.choose_wire_spec(state, tol)
    else:
        spec = streaming._as_wire_spec("f32" if wire is None else wire)
    # the vote: the highest precision wins, so no host's gate is violated
    rank = {name: i for i, name in enumerate(streaming.WIRE_DTYPES)}
    _put(store, f"repro/merge/{seq}/spec/{pid}", spec.sketch.encode())
    votes = [v.decode() for v in
             _gather(store, f"repro/merge/{seq}/spec", nproc, wait)]
    spec = streaming.WireSpec(min(votes, key=lambda v: rank[v]))
    _put(store, f"repro/merge/{seq}/state/{pid}",
         streaming.wire_pack(streaming.compress_state(state, spec)))
    images = _gather(store, f"repro/merge/{seq}/state", nproc, wait)
    _release(store, f"repro/merge/{seq}", pid, nproc, wait)
    dev = state.A_acc.device
    return streaming.tree_merge([
        streaming.decompress_state(streaming.wire_unpack(blob, device=dev))
        for blob in images])


def sharded_ingest(summarizer, key, shapes: Tuple[int, int, int],
                   fetch: Callable[[int, int], tuple], *,
                   chunk: int = 4096, prefetch: int = 2,
                   wire: Union[str, None] = None,
                   tol: Optional[float] = None,
                   timeout: float = 60.0):
    """The whole multi-host pass: ingest this host's shard, then merge.

    ``fetch(lo, hi)`` returns the ``(A_rows, B_rows)`` of global rows
    ``[lo, hi)``; each host fetches only its ``host_shard_range``, in
    ``chunk``-row pieces through ``StreamingSummarizer.ingest``
    (``prefetch`` chunks staged ahead of the update on the card). The
    final ``cross_host_merge`` gives every host the global state;
    ``wire``/``tol``/``timeout`` as there."""
    if not isinstance(chunk, int) or isinstance(chunk, bool) or chunk < 1:
        raise ValueError(f"chunk must be a positive row count, got {chunk!r}")
    lo, hi = host_shard_range(shapes[0])
    state = summarizer.init(key, shapes)

    def _chunks() -> Iterator[tuple]:
        for off in range(lo, hi, chunk):
            yield fetch(off, min(off + chunk, hi))

    state = summarizer.ingest(state, _chunks(), row_offset=lo,
                              prefetch=prefetch)
    return cross_host_merge(state, wire=wire, tol=tol, timeout=timeout)
