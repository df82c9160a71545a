"""The loader graph: one composable op-graph behind every loader.

Counterpart of ``lance_distributed_training_tpu/data/graph.py``. An input
pipeline expressed as a graph of typed ops (tf.data, PAPERS.md 2101.12127)
is what makes transport, caching and autotuning pluggable: each plane
(the batch cache, device decode, the token plane, the placement plane)
plugs in at one node, not once per loader.

Vocabulary, one node per concern:

* **Source**: what rows exist and in what order. :class:`LanceSource`
  (columnar fragments and a sampler plan), :class:`MapStyleSource`
  (permuted row indices), :class:`FolderSource` (walk-ordered files),
  :class:`EvalSource` (the full-coverage padded index plan). A source owns
  the *plan*, a pure function of (dataset, sampler, batch, shard, seed,
  epoch): the property every resume cursor and cache key leans on.
* **Decode**: the decode-boundary seam. In process it carries the decode
  hook itself; behind a remote transport only the *declaration*
  (task/image_size/seq_len/device_decode/token_pack), because decode runs
  server-side. ``schedule=`` attaches the straggler scheduler
  (``data/schedule.py``).
* **Cache**: the :class:`~.cache.BatchCache` at the decode boundary (a hit
  skips read and decode and returns byte-identical pages).
* **Pool** / **Buffers** / **Prefetch**: decode worker processes, the
  shared :class:`~.buffers.BufferPool`, the decoded-batch queue depth and
  the producer thread count.
* **Transport**: where the stream crosses a process boundary.
  :class:`InProcess` (none), :class:`ServiceTransport` (one data service),
  :class:`FleetTransport` (a coordinator-striped fleet), which compile to
  the service's :class:`~..service.client.RemoteLoader` and the fleet's
  :class:`~..fleet.balancer.FleetLoader`.
* **DevicePut** / **Place**: the synchronous placement on the consumer
  thread (``parallel.mesh.make_global_batch``, the ``--no_global_batch``
  arm) or the placement plane (``data/placement.py``) owning H2D on its
  own thread.

:class:`LoaderGraph` composes nodes into one loader with the contract
every consumer speaks: ``__iter__``/``__len__``, ``state_dict``/
``load_state_dict`` (ONE resume cursor at the graph root, delegated to the
engine that owns it), ``set_prefetch``/``tunables()`` (one aggregation for
the autotuner), and attribute fallthrough for engine-specific surface
(``counters``, ``placement_counters``, ``num_classes``, ...).

Compilation is lazy and cached: ``describe()`` renders topology without
touching a dataset, a socket or a decoder, while the first iteration,
``len`` or live cursor call compiles the node set down to exactly the
engine the direct constructors build (:class:`~.pipeline.TrainLoader`,
:class:`~.pipeline.EvalLoader`, :class:`~.pipeline.MapStylePipeline`,
:class:`~.folder.FolderDataPipeline`), with the same plan, cache binding
and defaults. So a graph's batches are the engine's, bit for bit, and the
JAX graph's for the same nodes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

__all__ = [
    "Node",
    "Source",
    "LanceSource",
    "MapStyleSource",
    "FolderSource",
    "EvalSource",
    "Decode",
    "Cache",
    "Pool",
    "Buffers",
    "Prefetch",
    "Transport",
    "InProcess",
    "ServiceTransport",
    "FleetTransport",
    "DevicePut",
    "Place",
    "LoaderGraph",
    "canonical_graphs",
]


# -- node vocabulary --------------------------------------------------------


class Node:
    """One typed op in a :class:`LoaderGraph`.

    ``kind`` names the concern (one node per kind per graph); ``describe()``
    renders without compiling (no dataset open, no socket, no decoder
    import), so spec-only graphs (``dataset=None``) still draw topology.
    """

    kind = "node"
    #: knob names this node contributes to the graph root's ``tunables()``
    #: (informational: the compiled engines own the live Tunable objects).
    tunable_names: Sequence[str] = ()

    def detail(self) -> str:
        return ""

    def describe(self) -> dict:
        return {
            "node": type(self).__name__,
            "kind": self.kind,
            "detail": self.detail(),
            "tunables": list(self.tunable_names),
        }

    def __repr__(self) -> str:
        d = self.detail()
        name = type(self).__name__
        return f"{name}({d})" if d else f"{name}()"


class Source(Node):
    kind = "source"


class LanceSource(Source):
    """Columnar fragments and a sampler plan (the iterable arm's source).

    Owns plan construction: the ``full``-sampler multi-process refusal, the
    cross-process equal-step validation (the fragment-imbalance deadlock
    guard) and the :func:`~.samplers.make_plan` call. ``dataset=None`` is a
    spec-only source: it can describe itself and declare plan parameters
    and ``dataset_fingerprint`` to a remote transport, but cannot build an
    in-process plan.
    """

    def __init__(
        self,
        dataset,
        sampler_type: str,
        batch_size: int,
        process_index: int,
        process_count: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        epoch: int = 0,
        dataset_fingerprint: Optional[str] = None,
    ):
        self.dataset = dataset
        self.sampler_type = sampler_type
        self.batch_size = int(batch_size)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self._fingerprint = dataset_fingerprint

    def detail(self) -> str:
        return (
            f"sampler={self.sampler_type} shard="
            f"{self.process_index}/{self.process_count} "
            f"seed={self.seed} epoch={self.epoch}"
            + ("" if self.dataset is not None else " [spec-only]")
        )

    @property
    def dataset_fingerprint(self) -> Optional[str]:
        if self._fingerprint is None and self.dataset is not None:
            self._fingerprint = self.dataset.fingerprint()
        return self._fingerprint

    def _refuse_full_multiprocess(self) -> None:
        if (
            self.sampler_type in ("full", "full_scan")
            and self.process_count > 1
        ):
            # A full scan is not DP-aware: each process's identical scan
            # would train every row once a process.
            raise ValueError(
                "sampler_type='full' is not DP-aware (every process scans "
                "the whole dataset) and cannot run across "
                f"{self.process_count} processes; use sampler_type='batch' "
                "or 'fragment', or launch a single process (no "
                "coordinator/multi-host env) for eval/debug"
            )

    def shard_plans(self) -> list:
        """Every process's plan, equal-step validated: the cross-shard
        collective-deadlock guard."""
        from .samplers import assert_equal_step_counts, make_plan

        rows = self.dataset.fragment_rows()
        plans = [
            make_plan(self.sampler_type, rows, self.batch_size, p,
                      self.process_count, shuffle=self.shuffle,
                      seed=self.seed, epoch=self.epoch)
            for p in range(self.process_count)
        ]
        if self.sampler_type not in ("full", "full_scan"):
            assert_equal_step_counts(plans, self.batch_size)
        return plans

    def plan(self):
        """THIS shard's epoch plan: a pure function of (dataset, sampler,
        batch, shard, seed, epoch)."""
        if self.dataset is None:
            raise ValueError(
                "spec-only LanceSource (dataset=None) cannot build an "
                "in-process plan; attach a ServiceTransport/FleetTransport "
                "or construct with a dataset"
            )
        self._refuse_full_multiprocess()
        return self.shard_plans()[self.process_index]


class MapStyleSource(Source):
    """Permuted row indices (``DistributedSampler`` semantics), optionally
    restricted to a filter's or a val split's ``index_pool``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        process_index: int,
        process_count: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        drop_last: bool = True,
        index_pool=None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.drop_last = bool(drop_last)
        self.index_pool = index_pool

    def detail(self) -> str:
        pool = "" if self.index_pool is None else (
            f" pool={len(self.index_pool)}rows"
        )
        return (
            f"shard={self.process_index}/{self.process_count} "
            f"shuffle={self.shuffle} seed={self.seed} "
            f"epoch={self.epoch}{pool}"
        )


class FolderSource(Source):
    """Walk-ordered image-folder tree (the file-based control arm)."""

    def __init__(
        self,
        root: Optional[str],
        batch_size: int,
        process_index: int,
        process_count: int,
        *,
        loader_style: str = "map",
        shuffle: bool = True,
        seed: int = 0,
        epoch: int = 0,
        drop_last: bool = True,
        dataset_fingerprint: Optional[str] = None,
    ):
        self.root = root
        self.batch_size = int(batch_size)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.loader_style = loader_style
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.drop_last = bool(drop_last)
        self.dataset_fingerprint = dataset_fingerprint

    def detail(self) -> str:
        return (
            f"style={self.loader_style} shard="
            f"{self.process_index}/{self.process_count} "
            f"seed={self.seed} epoch={self.epoch}"
            + ("" if self.root is not None else " [spec-only]")
        )


class EvalSource(Source):
    """Full-coverage eval plan: every row exactly once, the ragged tail
    padded back to a full global batch by wrap-around rows carried with
    ``_weight`` 0.0, so every batch has one shape and every process the
    same step count. ``read_fn`` maps an index array to an Arrow table
    (``Dataset.take`` for the columnar arm, the file reader for the folder
    arm), so both storage arms share this source."""

    def __init__(
        self,
        read_fn: Optional[Callable],
        num_rows: int,
        global_batch: int,
        process_index: int,
        process_count: int,
        *,
        index_pool=None,
    ):
        self.read_fn = read_fn
        self.num_rows = int(num_rows)
        self.global_batch = int(global_batch)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.index_pool = index_pool

    def detail(self) -> str:
        total = (
            self.num_rows if self.index_pool is None
            else len(self.index_pool)
        )
        return (
            f"rows={total} global_batch={self.global_batch} "
            f"shard={self.process_index}/{self.process_count} "
            "padded-tail"
        )

    def plan(self):
        from .samplers import padded_eval_index_batches

        total = (
            self.num_rows if self.index_pool is None
            else len(self.index_pool)
        )
        return padded_eval_index_batches(
            total, self.global_batch, self.process_index,
            self.process_count, index_pool=self.index_pool,
        )


class Decode(Node):
    """The decode-boundary seam, where cache and device decode plug in.

    In-process graphs carry the decode hook itself (``decode_fn``: Arrow
    table → dict of host arrays). Remote graphs carry ``decode_fn=None``
    and the *declaration* kwargs: the server owns the decoder.

    ``schedule`` attaches straggler-aware dispatch at the decode seam
    (worker-pool graphs only): a :class:`~.schedule.DecodeScheduler`, a
    dict of its options (``{"lookahead": 8, "heavy_share": 25}``), or
    ``True`` for defaults. Compile builds the scheduler with a
    :meth:`~.schedule.CostModel.from_env` warm-started cost model, so a
    restarted job schedules from its ``LDT_COST_PATH`` history. Remote
    graphs refuse it: the server owns dispatch.
    """

    kind = "decode"
    tunable_names = ("coeff_chunk",)

    def __init__(
        self,
        decode_fn: Optional[Callable] = None,
        *,
        columns: Optional[Sequence[str]] = None,
        task_type: Optional[str] = None,
        image_size: Optional[int] = None,
        seq_len: Optional[int] = None,
        device_decode: Optional[bool] = None,
        token_pack: Optional[bool] = None,
        schedule=None,
    ):
        self.decode_fn = decode_fn
        self.columns = columns
        self.task_type = task_type
        self.image_size = image_size
        self.seq_len = seq_len
        self.device_decode = device_decode
        self.token_pack = token_pack
        self.schedule = schedule
        if schedule is not None:
            # An instance override: schedule-less graphs (every canonical
            # shape among them) render as the JAX graph's do.
            self.tunable_names = (
                "coeff_chunk", "sched_lookahead", "sched_heavy_share",
            )

    def detail(self) -> str:
        sched = "" if self.schedule is None else " sched=on"
        if self.decode_fn is not None:
            name = getattr(
                type(self.decode_fn), "__name__", str(self.decode_fn)
            )
            cols = (
                "" if self.columns is None
                else f" columns={list(self.columns)}"
            )
            return f"fn={name}{cols}{sched}"
        declared = [
            f"{k}={v}"
            for k, v in (
                ("task", self.task_type), ("image_size", self.image_size),
                ("seq_len", self.seq_len),
                ("device_decode", self.device_decode),
                ("token_pack", self.token_pack),
            )
            if v is not None
        ]
        return (
            "server-side [" + " ".join(declared) + "]"
            if declared else "server-side"
        )


class Cache(Node):
    """The decoded-batch cache bound at the decode boundary: a hit is
    byte-identical to what decode would have produced, in fresh pool-leased
    pages. ``batch_cache=None`` keeps the node as a documented seam with
    the exact cacheless behaviour. ``dataset_fingerprint`` gives the
    content identity where the source has none (the eval arm)."""

    kind = "cache"

    def __init__(self, batch_cache=None, *,
                 dataset_fingerprint: Optional[str] = None):
        self.batch_cache = batch_cache
        self.dataset_fingerprint = dataset_fingerprint

    def detail(self) -> str:
        return "on" if self.batch_cache is not None else "off"


class Pool(Node):
    """Decode worker-process pool (``num_workers``); ``None`` runs decode
    on the producer threads and the native decoder's own threads."""

    kind = "pool"
    tunable_names = ("workers",)

    def __init__(self, workers=None):
        self.workers = workers

    def detail(self) -> str:
        return "producer-thread" if self.workers is None else "worker-pool"


class Buffers(Node):
    """The shared :class:`~.buffers.BufferPool`: decoders lease output
    pages, the consumer side releases them after placement (or after the
    consumer's turn for host batches), so pages recycle across batches."""

    kind = "buffers"
    tunable_names = ("pool_pages",)

    def __init__(self, pool=None):
        self.pool = pool

    def detail(self) -> str:
        return "pooled" if self.pool is not None else "unpooled"


class Prefetch(Node):
    """Decoded-batch queue depth ahead of the consumer and the producer
    thread count (results stay in plan order)."""

    kind = "prefetch"
    tunable_names = ("prefetch",)

    def __init__(self, depth: int = 2, *, producers: int = 1):
        self.depth = int(depth)
        self.producers = int(producers)

    def detail(self) -> str:
        return f"depth={self.depth} producers={self.producers}"


class Transport(Node):
    kind = "transport"


class InProcess(Transport):
    """No process boundary: source → decode → batch run in this
    process."""

    def detail(self) -> str:
        return "in-process"


class ServiceTransport(Transport):
    """One remote data service: plan and decode run server-side, this
    process streams host batches. Network knobs pass through to the
    service's client verbatim; ``job_id``/``job_priority`` declare the
    stream's tenancy. Compiles to a
    :class:`~..service.client.RemoteLoader`."""

    def __init__(self, addr: str, job_id: Optional[str] = None,
                 job_priority: Optional[str] = None, **opts):
        self.addr = addr
        if job_id is not None:
            opts["job_id"] = job_id
            if job_priority is not None:
                opts["job_priority"] = job_priority
        self.opts = opts

    def detail(self) -> str:
        job = self.opts.get("job_id")
        suffix = f" job={job}" if job else ""
        return f"service addr={self.addr}{suffix}"


class FleetTransport(Transport):
    """A coordinator-striped fleet of data services: batches round-robin
    across the member stripe, merged back into plan order client-side.
    Compiles to a :class:`~..fleet.balancer.FleetLoader`."""

    tunable_names = ("stripe_width",)

    def __init__(self, coordinator_addr: str, job_id: Optional[str] = None,
                 job_priority: Optional[str] = None, **opts):
        self.coordinator_addr = coordinator_addr
        if job_id is not None:
            opts["job_id"] = job_id
            if job_priority is not None:
                opts["job_priority"] = job_priority
        self.opts = opts

    def detail(self) -> str:
        job = self.opts.get("job_id")
        suffix = f" job={job}" if job else ""
        return f"fleet coordinator={self.coordinator_addr}{suffix}"


class DevicePut(Node):
    """Synchronous placement on ``device`` (the control arm: the engine
    places each batch through ``make_global_batch``, JAX's synchronous
    closure); ``device=None`` yields host batches, which :class:`Place`
    places downstream."""

    kind = "device_put"

    def __init__(self, device=None):
        self.device = device

    def detail(self) -> str:
        return "sync-closure" if self.device is not None else "host-batches"


class Place(Node):
    """The placement plane: a ring of in-flight device batches placed by a
    dedicated H2D thread; owns the consumed-batch cursor when present."""

    kind = "place"
    tunable_names = ("ring_depth",)

    def __init__(self, plane=None):
        self.plane = plane

    def detail(self) -> str:
        if self.plane is None:
            return "plane"
        return f"ring_depth={getattr(self.plane, 'depth', '?')}"


# -- the graph --------------------------------------------------------------

_SINGLETON_KINDS = (
    "source", "decode", "cache", "pool", "buffers", "prefetch",
    "transport", "device_put", "place",
)
_REMOTE = (ServiceTransport, FleetTransport)


class LoaderGraph:
    """A composed loader: typed nodes in, the standard loader contract out.

    Topology rules (validated at construction, with the JAX graph's
    messages): exactly one ``source`` node, at most one node of every other
    kind, and a remote transport excludes the in-process-only nodes
    (``Cache``/``Pool`` payloads and an in-process ``decode_fn``).

    ``compile()`` lowers the node set to the matching engine exactly once
    (cached); ``describe()`` never compiles. The resume cursor, the
    tunables aggregation and iteration all delegate to the compiled
    engine, so a graph is drop-in wherever an engine was.
    """

    def __init__(self, *nodes: Node):
        by_kind: dict = {}
        for node in nodes:
            if not isinstance(node, Node):
                raise TypeError(f"not a graph node: {node!r}")
            if node.kind in by_kind:
                raise ValueError(
                    f"duplicate {node.kind!r} node: {node!r} vs "
                    f"{by_kind[node.kind]!r}"
                )
            if node.kind not in _SINGLETON_KINDS:
                raise ValueError(f"unknown node kind {node.kind!r}")
            by_kind[node.kind] = node
        if "source" not in by_kind:
            raise ValueError("a LoaderGraph needs exactly one Source node")
        self.nodes = list(nodes)
        self._by_kind = by_kind
        self._validate()
        self._runtime = None
        # The engine beneath a Place wrap (the runtime itself without one):
        # __getattr__ falls back here for engine-only surface (num_classes)
        # that the placement wrapper does not re-export.
        self._engine = None
        # A resume cursor staged before compile (applied by compile());
        # afterwards the engine owns it and this stays None.
        self._pending_state: Optional[dict] = None

    # -- topology ----------------------------------------------------------

    def node(self, kind: str) -> Optional[Node]:
        return self._by_kind.get(kind)

    @property
    def source(self) -> Source:
        return self._by_kind["source"]

    @property
    def transport(self) -> Transport:
        return self._by_kind.get("transport") or InProcess()

    def _validate(self) -> None:
        src = self.source
        transport = self.transport
        decode = self.node("decode")
        if isinstance(transport, _REMOTE):
            if not isinstance(src, LanceSource):
                raise ValueError(
                    f"{type(transport).__name__} streams a server-side "
                    "lance plan; the source must be a LanceSource "
                    f"(spec-only is fine), got {type(src).__name__}"
                )
            if decode is not None and decode.decode_fn is not None:
                raise ValueError(
                    "remote transports decode server-side: Decode must be "
                    "declaration-only (decode_fn=None, with task_type/"
                    "image_size/... riding the HELLO skew checks)"
                )
            if decode is not None and decode.schedule is not None:
                raise ValueError(
                    "remote transports dispatch server-side: drop "
                    "schedule= from Decode and configure the DataService "
                    "(ServeConfig.sched_lookahead / sched_heavy_share) "
                    "instead"
                )
            for kind in ("cache", "pool"):
                node = self.node(kind)
                payload = getattr(node, "batch_cache", None) or getattr(
                    node, "workers", None
                )
                if node is not None and payload is not None:
                    raise ValueError(
                        f"a {kind!r} node cannot ride a remote transport — "
                        "the DataService owns cache and decode workers "
                        "server-side (ServeConfig)"
                    )
        else:
            if decode is None or decode.decode_fn is None:
                raise ValueError(
                    "in-process graphs need a Decode node with a decode_fn"
                )
            if isinstance(src, EvalSource):
                pool = self.node("pool")
                if pool is not None and pool.workers is not None:
                    raise ValueError(
                        "EvalSource runs decode on producer threads (a "
                        "single pass needs no worker-pool protocol); drop "
                        "the Pool node"
                    )

    # -- compilation -------------------------------------------------------

    def compile(self):
        """Lower to the engine (cached). Compilation happens on the
        constructing thread before the loader is shared; afterwards every
        delegate reads the same reference."""
        if self._runtime is None:
            self._runtime = self._build()
            if self._pending_state is not None:
                self._runtime.load_state_dict(self._pending_state)
                self._pending_state = None
        return self._runtime

    def _build(self):
        transport = self.transport
        if isinstance(transport, _REMOTE):
            engine = self._build_remote(transport)
        else:
            src = self.source
            if isinstance(src, LanceSource):
                engine = self._build_lance(src)
            elif isinstance(src, MapStyleSource):
                engine = self._build_map_style(src)
            elif isinstance(src, FolderSource):
                engine = self._build_folder(src)
            elif isinstance(src, EvalSource):
                engine = self._build_eval(src)
            else:
                raise ValueError(f"unbuildable source {type(src).__name__}")
        self._engine = engine
        place = self.node("place")
        if place is not None:
            if place.plane is None:
                raise ValueError(
                    "Place node has no plane — construct with "
                    "Place(PlacementPlane(device, ...))"
                )
            engine = place.plane.wrap(engine)
        return engine

    def _common(self) -> dict:
        """The knobs every in-process engine shares, the node defaults
        equal to the engines' constructor defaults."""
        decode = self.node("decode")
        prefetch = self.node("prefetch") or Prefetch()
        pool = self.node("pool") or Pool()
        buffers = self.node("buffers") or Buffers()
        put = self.node("device_put") or DevicePut()
        cache = self.node("cache") or Cache()
        return {
            "decode_fn": decode.decode_fn,
            "columns": decode.columns,
            "device": put.device,
            "prefetch": prefetch.depth,
            "producers": prefetch.producers,
            "workers": pool.workers,
            "buffer_pool": buffers.pool,
            "batch_cache": cache.batch_cache,
            "scheduler": self._scheduler(decode),
        }

    @staticmethod
    def _scheduler(decode):
        """Lower the Decode node's ``schedule`` spec to a live
        :class:`~.schedule.DecodeScheduler` (an instance passes through; a
        dict or ``True`` builds one, warm-started from ``LDT_COST_PATH``)."""
        spec = getattr(decode, "schedule", None)
        if spec is None:
            return None
        from .schedule import CostModel, DecodeScheduler

        if isinstance(spec, DecodeScheduler):
            return spec
        opts = {} if spec is True else dict(spec)
        return DecodeScheduler(CostModel.from_env(), **opts)

    def _build_lance(self, src: LanceSource):
        from .pipeline import TrainLoader

        c = self._common()
        return TrainLoader(
            src.dataset, src.plan(), c["decode_fn"], c["device"],
            prefetch=c["prefetch"], epoch=src.epoch,
            producers=c["producers"], buffer_pool=c["buffer_pool"],
            workers=c["workers"], batch_cache=c["batch_cache"],
            columns=c["columns"], scheduler=c["scheduler"],
        )

    def _build_map_style(self, src: MapStyleSource):
        from .pipeline import MapStylePipeline

        c = self._common()
        return MapStylePipeline(
            src.dataset, src.batch_size, src.process_index,
            src.process_count, c["decode_fn"], c["device"],
            shuffle=src.shuffle, seed=src.seed, epoch=src.epoch,
            drop_last=src.drop_last, prefetch=c["prefetch"],
            columns=c["columns"], index_pool=src.index_pool,
            producers=c["producers"], buffer_pool=c["buffer_pool"],
            workers=c["workers"], batch_cache=c["batch_cache"],
            scheduler=c["scheduler"],
        )

    def _build_folder(self, src: FolderSource):
        from .folder import FolderDataPipeline

        if src.root is None:
            raise ValueError(
                "spec-only FolderSource (root=None) cannot compile"
            )
        c = self._common()
        return FolderDataPipeline(
            src.root, src.batch_size, src.process_index,
            src.process_count, c["decode_fn"], c["device"],
            loader_style=src.loader_style, shuffle=src.shuffle,
            seed=src.seed, epoch=src.epoch, drop_last=src.drop_last,
            prefetch=c["prefetch"], producers=c["producers"],
            buffer_pool=c["buffer_pool"], workers=c["workers"],
            batch_cache=c["batch_cache"],
            dataset_fingerprint=src.dataset_fingerprint,
            scheduler=c["scheduler"],
        )

    def _build_eval(self, src: EvalSource):
        from .pipeline import EvalLoader

        if src.read_fn is None:
            raise ValueError("spec-only EvalSource (read_fn=None) cannot "
                             "compile")
        c = self._common()
        cache = self.node("cache") or Cache()
        return EvalLoader(
            src.read_fn, src.plan(), c["decode_fn"], c["device"],
            prefetch=c["prefetch"], producers=c["producers"],
            buffer_pool=c["buffer_pool"], batch_cache=c["batch_cache"],
            dataset_fingerprint=cache.dataset_fingerprint,
        )

    def _build_remote(self, transport: Transport):
        """The service's or the fleet's client, declaring the decode knobs
        the server checks at connect time; it places each batch on the
        :class:`DevicePut` node's device, or yields host batches."""
        src = self.source
        decode = self.node("decode") or Decode()
        prefetch = self.node("prefetch") or Prefetch()
        buffers = self.node("buffers") or Buffers()
        put = self.node("device_put") or DevicePut()
        common = dict(
            sampler_type=src.sampler_type,
            shuffle=src.shuffle,
            seed=src.seed,
            epoch=src.epoch,
            prefetch=prefetch.depth,
            columns=decode.columns,
            task_type=decode.task_type,
            image_size=decode.image_size,
            seq_len=decode.seq_len,
            device_decode=decode.device_decode,
            token_pack=decode.token_pack,
            dataset_fingerprint=src.dataset_fingerprint,
            buffer_pool=buffers.pool,
        )
        common.update(transport.opts)
        if isinstance(transport, FleetTransport):
            from ..fleet.balancer import FleetLoader

            return FleetLoader(
                transport.coordinator_addr, src.batch_size,
                src.process_index, src.process_count, put.device, **common,
            )
        from ..service.client import RemoteLoader

        return RemoteLoader(
            transport.addr, src.batch_size, src.process_index,
            src.process_count, put.device, **common,
        )

    # -- describe (no compile) ---------------------------------------------

    def cursor_owner(self) -> str:
        """Which node's engine owns the graph-root resume cursor: the
        placement plane counts CONSUMED batches when present; otherwise
        the stream root (the transport for remote graphs, the source's
        engine in process)."""
        if self.node("place") is not None:
            return type(self.node("place")).__name__
        transport = self.transport
        if isinstance(transport, _REMOTE):
            return type(transport).__name__
        return type(self.source).__name__

    def describe(self) -> dict:
        owner = self.cursor_owner()
        nodes = []
        for node in self.nodes:
            d = node.describe()
            d["cursor"] = type(node).__name__ == owner
            nodes.append(d)
        return {
            "nodes": nodes,
            "cursor_owner": owner,
            "tunable_nodes": [
                type(n).__name__ for n in self.nodes if n.tunable_names
            ],
        }

    # -- the loader contract (delegated to the compiled engine) ------------

    def __iter__(self):
        return iter(self.compile())

    def __len__(self) -> int:
        return len(self.compile())

    def state_dict(self) -> dict:
        """The ONE resume cursor at the graph root, delegated to the engine
        that owns it, so engine and graph serialize identically. Reads
        never compile: before compile the cursor is whatever was staged,
        the origin otherwise."""
        runtime = self._runtime
        if runtime is None:
            return (
                dict(self._pending_state)
                if self._pending_state is not None else {"step": 0}
            )
        return runtime.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Position the cursor: staged when the graph has not compiled yet
        (compile() applies it), delegated live otherwise."""
        step = int(state.get("step", 0))
        if step < 0:
            raise ValueError(f"negative resume cursor: {step}")
        runtime = self._runtime
        if runtime is None:
            self._pending_state = dict(state)
            return
        runtime.load_state_dict(state)

    def set_prefetch(self, depth: int) -> int:
        return self.__getattr__("set_prefetch")(depth)

    def tunables(self):
        """The autotuner's single aggregation: the compiled engine already
        chains plane → loader → decoder (→ scheduler) knobs."""
        return self.compile().tunables()

    def __getattr__(self, name: str):
        # Engine-specific surface (counters, placement_counters,
        # num_classes, set_epoch, ...) falls through to the compiled
        # runtime; dunders and graph internals never delegate.
        if name.startswith("__") or name in (
            "nodes", "_by_kind", "_runtime", "_engine", "_pending_state",
        ):
            raise AttributeError(name)
        runtime = self.compile()
        try:
            return getattr(runtime, name)
        except AttributeError:
            # A Place wrap narrows the surface to the loader contract;
            # engine-only attributes live one layer down.
            engine = self._engine
            if engine is not None and engine is not runtime:
                return getattr(engine, name)
            raise

    def __repr__(self) -> str:
        chain = " -> ".join(type(n).__name__ for n in self.nodes)
        return f"LoaderGraph({chain})"


# -- canonical shapes (describe-only) ----------------------------------------


def canonical_graphs() -> "dict[str, LoaderGraph]":
    """The five loader shapes as spec-only graphs: no dataset, socket or
    decoder is touched. They render the node topology, and they are the
    one executable source of the shapes the trainer composes."""
    decode_stub = Decode(lambda table: table)  # in-process seam marker
    return {
        "train-iterable": LoaderGraph(
            LanceSource(None, "batch", 32, 0, 1, shuffle=True),
            decode_stub, Cache(), Pool(), Buffers(), Prefetch(2),
            InProcess(), Place(),
        ),
        "train-map-style": LoaderGraph(
            MapStyleSource(None, 32, 0, 1),
            decode_stub, Cache(), Pool(), Buffers(), Prefetch(2),
            InProcess(),
        ),
        "train-folder": LoaderGraph(
            FolderSource(None, 32, 0, 1),
            decode_stub, Cache(), Pool(), Buffers(), Prefetch(2),
            InProcess(),
        ),
        "service": LoaderGraph(
            LanceSource(None, "batch", 32, 0, 1,
                        dataset_fingerprint="<hello-skew-check>"),
            Decode(task_type="classification", image_size=224),
            Buffers(), Prefetch(2),
            ServiceTransport("host:5055"),
        ),
        "fleet": LoaderGraph(
            LanceSource(None, "batch", 32, 0, 1,
                        dataset_fingerprint="<hello-skew-check>"),
            Decode(task_type="classification", image_size=224),
            Buffers(), Prefetch(2),
            FleetTransport("coordinator:5060"),
        ),
    }
