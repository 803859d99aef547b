"""Partition-major sharded feature store.

Port of the reference's ``store/feature_store.py``. Layout: node
features live in one partition-major padded table. With K partitions of
at most ``N_max`` nodes, node ``v`` homed on partition ``k`` at local
rank ``r`` (rank = position within the home partition's id-sorted node
list) sits at flat row ``loc[v] = k * N_max + r`` of a ``(K * N_max, F)``
float32 table — equivalently slice ``k`` of the stacked
``(K, N_max, F)`` shard view.

Backends:

* ``"numpy"`` (and ``"auto"``, as the reference picks on a host with one
  device) — the flat table is a host numpy array and gathers are fancy
  indexing: the bit-exactness reference (rows are verbatim copies of
  ``Graph.features`` rows);
* ``"torch"`` — the reference's ``"jax"`` backend: the flat table is a
  torch tensor on ``device`` (the card by default) and gathers index it
  there; values are bit-identical (a gather copies rows, it never
  rounds).

Which route serves a gather depends on the method called:

* :meth:`FeatureStore.gather_tensor` — the training step's rows, large,
  duplicate-heavy and kept on the card — is one flat gather on a device
  route (``use_kernel=True`` or ``backend="torch"``): the local ids go up
  once as int32 (site ``store.ids``), and one
  :func:`repro_torch.kernels.ops.gather_rows` launch reads their rows of
  the flat table through :meth:`FeatureStore.device_view`'s int32 map, in
  request order. :attr:`FeatureStore.flat_gathers` counts those launches
  (telemetry: ``store.flat_gathers``, ``store.flat_rows``).
* :meth:`FeatureStore.gather` and :meth:`FeatureStore.gather_batch` — the
  miss and admission rows that go back to the host — keep the per-home
  pull with ``use_kernel=True``: requests are bucketed by home partition
  into a dense ``(K, M_max)`` local-row matrix (the DistDGL KVStore pull
  shape) and served by one :func:`repro_torch.kernels.ops.gather_rows_batch`
  launch on the ``(K, N_max, F)`` shard view.
  :attr:`FeatureStore.kernel_gathers` counts those launches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import telemetry as tel


@dataclass
class StoreGather:
    """Result of one batched (multi-PE) store gather."""

    blocks: list[np.ndarray]  # per-request (m_i, F) float32 feature blocks
    nbytes: int               # bytes actually moved out of the store
    seconds: float            # wall-clock time of the gather
    #: The concatenated block as a tensor on the store's device
    #: (``gather_batch(..., device=True)``): the device hot path scatters
    #: it straight into the engine payload. None on host-only gathers.
    device_block: object = None


class FeatureStore:
    """Per-partition feature shards behind a single gather interface.

    Takes the reference's arguments plus ``device``, where the device
    table, the shard view and :meth:`device_view` live (``"cuda"`` by
    default; ``"cpu"`` runs the kernel path through the plain gather).
    ``id_base`` is the graph's global-id offset: gather ids are global
    and rebased before indexing ``loc``.
    """

    def __init__(
        self,
        features: np.ndarray,
        part_of: np.ndarray,
        num_parts: int | None = None,
        backend: str = "auto",
        use_kernel: bool = False,
        id_base: int = 0,
        device="cuda",
    ):
        from ..runtime.engine import resolve_device

        features = np.asarray(features, dtype=np.float32)
        if features.ndim != 2:
            raise ValueError(f"features must be (N, F), got {features.shape}")
        part_of = np.asarray(part_of, dtype=np.int64)
        if part_of.shape != (features.shape[0],):
            raise ValueError(
                f"part_of shape {part_of.shape} != ({features.shape[0]},)"
            )
        if part_of.size and part_of.min() < 0:
            raise ValueError("part_of must be non-negative")
        K = int(num_parts) if num_parts is not None else int(part_of.max(initial=0)) + 1
        if part_of.size and int(part_of.max()) >= K:
            raise ValueError("part_of references a partition >= num_parts")
        self.num_parts = K
        self.num_nodes, self.feature_dim = features.shape
        self.id_base = int(id_base)
        counts = np.bincount(part_of, minlength=K)
        self.shard_sizes = counts.astype(np.int64)
        self.n_max = int(counts.max(initial=0)) or 1

        # loc[v] = home * N_max + local_rank; ranks follow ascending node
        # id within each home partition (stable, derivable on any host).
        order = np.argsort(part_of, kind="stable")  # groups homes, keeps id order
        rank = np.empty(self.num_nodes, dtype=np.int64)
        rank[order] = np.arange(self.num_nodes, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        self._loc = part_of * self.n_max + rank

        flat = np.zeros((K * self.n_max, self.feature_dim), dtype=np.float32)
        flat[self._loc] = features
        self._flat = flat

        if backend == "auto":
            backend = "numpy"
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.use_kernel = bool(use_kernel)
        self.device = resolve_device(device)
        # The flat table on self.device: one copy, uploaded at first use,
        # that the torch backend, the kernel's shard view and device_view
        # all share.
        self._dev = None
        self._dev_view: dict = {}  # device -> (flat table, int32 loc)
        # gather_tensor's kept pinned id buffer and the event recorded after
        # its last copy to the card (None until the first flat gather there).
        self._ids_buf = None
        self._ids_sent = None
        #: ``gather_rows_batch`` launches this store made: the per-home
        #: pulls of :meth:`gather` / :meth:`gather_batch` (the miss and
        #: admission rows), not the training rows of :meth:`gather_tensor`.
        self.kernel_gathers = 0
        #: ``gather_rows`` launches of :meth:`gather_tensor`'s flat route.
        self.flat_gathers = 0

    # ------------------------------------------------------------------ #
    @classmethod
    def for_partitions(cls, parts, **kwargs) -> "FeatureStore":
        """Build from a :class:`repro_torch.graph.partition.Partitioned`."""
        kwargs.setdefault("id_base", int(parts.graph.id_base))
        return cls(
            parts.graph.features, parts.part_of, parts.num_parts, **kwargs
        )

    # ------------------------------------------------------------------ #
    @property
    def nbytes(self) -> int:
        return self._flat.nbytes

    @property
    def shards(self) -> np.ndarray:
        """Stacked ``(K, N_max, F)`` shard view of the flat table."""
        return self._flat.reshape(self.num_parts, self.n_max, self.feature_dim)

    def home_of(self, ids) -> np.ndarray:
        local = np.asarray(ids, dtype=np.int64) - self.id_base
        return self._loc[local] // self.n_max

    def _upload(self, a: np.ndarray, device=None, site: str = "store.index") -> torch.Tensor:
        """``a`` on ``device`` (the store's by default), counted as a copy
        at ``site``."""
        a = np.ascontiguousarray(a)
        tel.copied(site, "h2d", a.nbytes)
        return torch.from_numpy(a).to(device or self.device)

    def _table(self, device=None) -> torch.Tensor:
        """The flat ``(K * N_max, F)`` table on ``device`` (the store's by
        default); on the store's device, its single shared copy."""
        if device is not None and device != self.device:
            return self._upload(self._flat, device, site="store.table")
        if self._dev is None:
            self._dev = self._upload(self._flat, site="store.table")
        return self._dev

    def device_view(self, device=None):
        """``(table, loc)`` on ``device`` (the store's by default) for the
        single-launch hot path: the flat ``(K * N_max, F)`` float32 table
        and the int32 node→row map, indexed by the local id ``id -
        id_base`` (the wide step reads ``loc[id - id_base]``, the narrow
        one, at ``id_base == 0``, ``loc[id]``). The frontier step copies
        admission rows from these into the payload inside the step, so
        feature rows never cross the host boundary. Cached until :meth:`poke`. Needs
        the flat row count to be int32-addressable — the bound the device
        engine already enforces on node ids."""
        from ..kernels import ops
        from ..runtime.engine import resolve_device

        dev = resolve_device(device) if device is not None else self.device
        view = self._dev_view.get(dev)
        if view is None:
            if not ops.int32_id_eligible(self._flat.shape[0] - 1):
                raise ValueError(
                    "feature store flat table has >= 2^31 rows; "
                    "device view indexes rows as int32"
                )
            view = (
                self._table(dev),
                self._upload(self._loc.astype(np.int32), dev, site="store.table"),
            )
            self._dev_view[dev] = view
        return view

    # ------------------------------------------------------------------ #
    def _checked(self, ids: np.ndarray) -> np.ndarray:
        """``ids`` as flat int64 global ids; ``IndexError`` if any lies
        outside ``[id_base, id_base + num_nodes)``."""
        flat = ids.reshape(-1).astype(np.int64, copy=False)
        if flat.size:
            lo, hi = int(flat.min()), int(flat.max())
            if lo < self.id_base or hi >= self.id_base + self.num_nodes:
                raise IndexError(
                    f"node id out of range "
                    f"[{self.id_base}, {self.id_base + self.num_nodes}): "
                    f"min {lo}, max {hi}"
                )
        return flat

    def _rows_of(self, ids: np.ndarray) -> np.ndarray:
        flat = self._checked(ids)
        if self.id_base:
            flat = flat - np.int64(self.id_base)
        return self._loc[flat]

    def _local_ids_on_device(self, flat: np.ndarray) -> torch.Tensor:
        """``flat - id_base`` as int32 on the store's device, one copy
        counted at site ``store.ids``. On a card the copy leaves from a
        kept pinned buffer without blocking; the buffer is overwritten only
        once the event recorded after its previous copy has passed."""
        M = flat.size
        if self.device.type != "cuda":
            local = (flat - np.int64(self.id_base)).astype(np.int32)
            return self._upload(local, site="store.ids")
        if self._ids_buf is None or self._ids_buf.numel() < M:
            # The old buffer's copy in flight keeps its block alive: the
            # pinned allocator frees it only after that copy's event.
            self._ids_buf = torch.empty(M, dtype=torch.int32, pin_memory=True)
        elif self._ids_sent is not None:
            self._ids_sent.synchronize()
        host = self._ids_buf[:M]
        np.subtract(flat, np.int64(self.id_base), out=host.numpy(), casting="unsafe")
        tel.copied("store.ids", "h2d", host.numel() * 4)
        local = host.to(self.device, non_blocking=True)
        self._ids_sent = torch.cuda.Event()
        self._ids_sent.record(torch.cuda.current_stream(self.device))
        return local

    def _gather_flat(self, ids: np.ndarray) -> torch.Tensor:
        """The rows of ``ids`` as an ``(M, F)`` tensor on the store's device,
        in request order: one ``gather_rows`` launch on the flat table,
        the map from node to row read inside it (:meth:`device_view`)."""
        from ..kernels import ops

        flat = self._checked(ids)
        M = flat.size
        if M == 0:
            return torch.zeros((0, self.feature_dim), dtype=torch.float32, device=self.device)
        table, loc = self.device_view()
        out = ops.gather_rows(table, self._local_ids_on_device(flat), loc)
        self.flat_gathers += 1
        tel.count("store.flat_gathers", 1)
        tel.count("store.flat_rows", M)
        return out

    def _gather_on_device(self, rows: np.ndarray) -> torch.Tensor:
        """Rows of the flat table as an ``(M, F)`` tensor on the store's
        device (``backend="torch"`` or the kernel path)."""
        if self.use_kernel:
            return self._gather_rows_kernel(rows)
        return self._table().index_select(0, self._upload(rows))

    def _gather_rows_kernel(self, rows: np.ndarray) -> torch.Tensor:
        """Per-home routing through the batch gather: bucket the request
        by home partition into a dense ``(K, M_max)`` local-row matrix and
        serve every shard in one ``gather_rows_batch`` launch, then put
        the rows back in request order."""
        from ..kernels import ops

        K, F = self.num_parts, self.feature_dim
        M = rows.shape[0]
        if M == 0:
            return torch.zeros((0, F), dtype=torch.float32, device=self.device)
        home = rows // self.n_max
        local = rows - home * self.n_max
        order = np.argsort(home, kind="stable")
        counts = np.bincount(home, minlength=K)
        m_max = max(int(counts.max(initial=0)), 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        sorted_home = home[order]
        within = np.arange(M, dtype=np.int64) - starts[sorted_home]
        idx = np.zeros((K, m_max), dtype=np.int32)
        idx[sorted_home, within] = local[order]
        # pos[j]: the output row that holds request j.
        pos = np.empty(M, dtype=np.int64)
        pos[order] = sorted_home * m_max + within
        tables = self._table().view(K, self.n_max, F)  # the shard view
        out = ops.gather_rows_batch(tables, self._upload(idx))
        self.kernel_gathers += 1
        return out.reshape(K * m_max, F).index_select(0, self._upload(pos))

    def _gather_rows(self, rows: np.ndarray):
        """``(host rows, device rows or None)`` of the flat table."""
        if self.use_kernel or self.backend == "torch":
            dev = self._gather_on_device(rows)
            host = dev.cpu().numpy()
            tel.copied("store.rows", "d2h", host.nbytes)
            return host, dev
        return self._flat[rows], None

    # ------------------------------------------------------------------ #
    def gather(self, ids) -> np.ndarray:
        """Feature rows of ``ids`` — any shape, any int dtype; returns
        ``ids.shape + (F,)`` float32, bit-identical to
        ``graph.features[ids]``."""
        arr = np.asarray(ids)
        block, _ = self._gather_rows(self._rows_of(arr))
        return block.reshape(arr.shape + (self.feature_dim,))

    def gather_tensor(self, ids, device) -> torch.Tensor:
        """:meth:`gather` as an ``(len(ids), F)`` tensor on ``device``:
        the training step's feature rows, kept on the card when the store
        gathers there (no host round trip); bit-identical rows. A device
        route serves them by one flat gather (no bucketing by home); the
        numpy backend indexes its host table and uploads the rows."""
        ids = np.asarray(ids)
        if self.use_kernel or self.backend == "torch":
            return self._gather_flat(ids).to(device)
        return self._upload(self._flat[self._rows_of(ids)], device, site="store.rows")

    def gather_batch(self, id_lists, device: bool = False) -> StoreGather:
        """One timed gather for a whole cluster's per-PE request lists:
        the P ragged requests are served by a single concatenated row
        gather and split back. ``device=True`` also returns the
        concatenated block as a tensor on the store's device
        (``StoreGather.device_block``); the numpy blocks, and every exact
        stream derived from them, are the same either way."""
        sp = tel.begin("store.gather", plane="store")
        t0 = time.perf_counter()
        lengths = [len(x) for x in id_lists]
        if sum(lengths):
            ids = np.concatenate(
                [np.asarray(x, dtype=np.int64).reshape(-1) for x in id_lists]
            )
        else:
            ids = np.array([], dtype=np.int64)
        block, dev_block = self._gather_rows(self._rows_of(ids))
        blocks = [
            np.ascontiguousarray(b)
            for b in np.split(block, np.cumsum(lengths)[:-1])
        ]
        if device and dev_block is None:
            dev_block = self._upload(block, site="store.rows")
        seconds = time.perf_counter() - t0
        if sp is not None:
            # The bytes the gather moved: what calibrate_from_session fits.
            sp.nbytes = int(block.nbytes)
        tel.end(sp)
        if tel.enabled():
            tel.count("store.bytes", block.nbytes)
            tel.count("store.gathers", 1)
            tel.count("store.rows", np.asarray(lengths, dtype=np.float64))
        return StoreGather(
            blocks=blocks,
            nbytes=int(block.nbytes),
            seconds=seconds,
            device_block=dev_block if device else None,
        )

    # ------------------------------------------------------------------ #
    def poke(self, node_id: int, delta: float = 1.0) -> None:
        """Fault injection: corrupt one shard row in place (the golden
        drift negative test — a poked store must surface in the trace's
        ``feat_sums`` stream at the first step that fetches the node)."""
        row = self._loc[int(node_id) - self.id_base]
        self._flat[row] += np.float32(delta)
        self._dev = None
        self._dev_view = {}
