"""The port's loader graph (``data/graph.py``) against the JAX package's.

Every validation refusal of JAX ``tests/test_graph.py`` raises in both
packages with the same message; ``describe()`` of every
``canonical_graphs()`` entry equals JAX's (node, kind, detail, tunables,
cursor); cursor reads never compile and a staged cursor applies at compile.
The parity matrix (iterable, map-style, folder, eval, device-decode and
token-pack graphs, cache off and on) holds each port graph's batches
against the JAX graph's over the same nodes and against the direct port
engine, bit for bit (uint8 pixels, int16 coefficient pages, integer
tokens and plans; the eval's f32 ``_weight`` is 0 or 1), with the resume
tail after two batches. The factories and every arm of the trainer return
compiled graphs whose engine surface reaches through ``Place``; the remote
transports describe as JAX's and compile against a live server to the
service's and the fleet's loaders.
"""

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.data import cache as jax_cache
from lance_distributed_training_tpu.data import decode as jax_decode
from lance_distributed_training_tpu.data import graph as JG
from lance_distributed_training_tpu.data import pipeline as jax_pipeline
from lance_distributed_training_tpu.data import token_pack as jax_token_pack
from lance_distributed_training_tpu.data.authoring import (
    create_variable_length_token_dataset,
)
from lance_distributed_training_tpu.data.format import Dataset as JaxDataset
from lance_distributed_training_tpu.obs.registry import (
    MetricsRegistry as JaxRegistry,
)
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.data import graph as G
from lance_distributed_training_tpu_torch.data.cache import BatchCache
from lance_distributed_training_tpu_torch.data.decode import (
    ImageClassificationDecoder,
)
from lance_distributed_training_tpu_torch.data.folder import (
    FolderDataPipeline,
)
from lance_distributed_training_tpu_torch.data.format import Dataset
from lance_distributed_training_tpu_torch.data.pipeline import (
    EvalLoader,
    MapStylePipeline,
    TrainLoader,
    make_eval_pipeline,
    make_map_style_pipeline,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.data.placement import (
    PlacementPlane,
)
from lance_distributed_training_tpu_torch.data.samplers import (
    make_plan,
    padded_eval_index_batches,
)
from lance_distributed_training_tpu_torch.data.token_pack import (
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
)
from lance_distributed_training_tpu_torch.obs.registry import MetricsRegistry
from lance_distributed_training_tpu_torch.utils.chaos import batch_digest
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_jax_native import jax_native  # noqa: F401 (fixture)


SIZE = 32


def _ident(table):
    return table


# -- topology validation: the same refusal, the same message ----------------

REFUSALS = {
    "no-source": lambda m: m.LoaderGraph(m.Decode(_ident), m.InProcess()),
    "two-sources": lambda m: m.LoaderGraph(
        m.MapStyleSource(None, 8, 0, 1), m.FolderSource(None, 8, 0, 1),
        m.Decode(_ident)),
    "two-prefetch": lambda m: m.LoaderGraph(
        m.MapStyleSource(None, 8, 0, 1), m.Decode(_ident), m.Prefetch(2),
        m.Prefetch(4)),
    "not-a-node": lambda m: m.LoaderGraph(
        m.MapStyleSource(None, 8, 0, 1), "prefetch=2"),
    "remote-needs-lance": lambda m: m.LoaderGraph(
        m.MapStyleSource(None, 8, 0, 1), m.ServiceTransport("h:1")),
    "remote-decode-fn": lambda m: m.LoaderGraph(
        m.LanceSource(None, "batch", 8, 0, 1), m.Decode(_ident),
        m.ServiceTransport("h:1")),
    "remote-schedule": lambda m: m.LoaderGraph(
        m.LanceSource(None, "batch", 8, 0, 1),
        m.Decode(image_size=32, schedule=True), m.FleetTransport("h:1")),
    "remote-cache": lambda m: m.LoaderGraph(
        m.LanceSource(None, "batch", 8, 0, 1), m.Cache(object()),
        m.FleetTransport("h:1")),
    "remote-pool": lambda m: m.LoaderGraph(
        m.LanceSource(None, "batch", 8, 0, 1), m.Pool(workers=object()),
        m.ServiceTransport("h:1")),
    "inprocess-no-decode": lambda m: m.LoaderGraph(
        m.MapStyleSource(None, 8, 0, 1), m.InProcess()),
    "inprocess-declaration-only": lambda m: m.LoaderGraph(
        m.MapStyleSource(None, 8, 0, 1), m.Decode(image_size=32)),
    "eval-pool": lambda m: m.LoaderGraph(
        m.EvalSource(lambda idx: idx, 64, 8, 0, 1), m.Decode(_ident),
        m.Pool(workers=object())),
    "spec-only-lance": lambda m: m.LoaderGraph(
        m.LanceSource(None, "batch", 8, 0, 1), m.Decode(_ident)).compile(),
    "spec-only-folder": lambda m: m.LoaderGraph(
        m.FolderSource(None, 8, 0, 1), m.Decode(_ident)).compile(),
    "spec-only-eval": lambda m: m.LoaderGraph(
        m.EvalSource(None, 64, 8, 0, 1), m.Decode(_ident)).compile(),
}


def _raised(fn, module):
    with pytest.raises((TypeError, ValueError)) as info:
        fn(module)
    return info.type, str(info.value)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    got, want = _raised(REFUSALS[case], G), _raised(REFUSALS[case], JG)
    # The "not a node" message names the node's repr, identical in both.
    assert got == want


def test_empty_seams_ride_a_remote_transport_as_in_jax():
    for m in (G, JG):
        m.LoaderGraph(m.LanceSource(None, "batch", 8, 0, 1), m.Cache(),
                      m.Pool(), m.ServiceTransport("h:1"))


def test_place_without_plane_and_the_full_sampler_refusal(image_dataset):
    ds = Dataset(image_dataset.uri)
    with pytest.raises(ValueError, match="Place node has no plane"):
        G.LoaderGraph(G.LanceSource(ds, "batch", 16, 0, 1),
                      G.Decode(_decoder()), G.Place()).compile()
    got = _raised(lambda m: m.LoaderGraph(
        m.LanceSource(ds if m is G else image_dataset, "full", 16, 1, 2),
        m.Decode(_ident)).compile(), G)
    want = _raised(lambda m: m.LoaderGraph(
        m.LanceSource(image_dataset, "full", 16, 1, 2),
        m.Decode(_ident)).compile(), JG)
    assert got == want
    with pytest.raises(ValueError, match="not DP-aware"):
        make_train_pipeline(ds, "full", 16, 1, 2, _decoder(), None)


# -- describe and cursor ownership -------------------------------------------


def test_canonical_graphs_describe_as_jax_without_compiling():
    got, want = G.canonical_graphs(), JG.canonical_graphs()
    assert list(got) == list(want)
    for name, graph in got.items():
        assert graph.describe() == want[name].describe(), name
        assert repr(graph) == repr(want[name])
        assert graph._runtime is None  # describe() never compiles
    owners = {name: g.cursor_owner() for name, g in got.items()}
    assert owners == {
        "train-iterable": "Place", "train-map-style": "MapStyleSource",
        "train-folder": "FolderSource", "service": "ServiceTransport",
        "fleet": "FleetTransport",
    }


def test_scheduled_decode_describes_as_jax():
    for spec in (True, {"lookahead": 4, "heavy_share": 25}):
        got = G.Decode(_ident, columns=["image"], schedule=spec).describe()
        want = JG.Decode(_ident, columns=["image"], schedule=spec).describe()
        assert got == want
        assert "sched_lookahead" in got["tunables"]


@pytest.fixture()
def live_service(image_dataset):
    """A port data service on ``image_dataset`` (32 px) and a coordinator
    with that service as its one member: ``(service addr, coordinator
    addr)``."""
    from lance_distributed_training_tpu_torch.fleet import (
        Coordinator, CoordinatorConfig)
    from lance_distributed_training_tpu_torch.service import (
        DataService, ServeConfig)

    coord = Coordinator(CoordinatorConfig(
        host="127.0.0.1", port=0, heartbeat_interval_s=0.05,
        lease_ttl_s=2.0)).start()
    svc = DataService(ServeConfig(
        dataset_path=image_dataset.uri, host="127.0.0.1", port=0,
        image_size=SIZE, queue_depth=2,
        coordinator_addr=f"127.0.0.1:{coord.port}")).start()
    try:
        yield f"127.0.0.1:{svc.port}", f"127.0.0.1:{coord.port}"
    finally:
        svc.stop()
        coord.stop()


@pytest.mark.parametrize("transport", ["service", "fleet"])
def test_remote_transports_validate_describe_and_refuse_to_compile(
        transport, image_dataset, live_service):
    """Both remote transports describe as JAX's and compile against a live
    port server to the service's and the fleet's loaders, whose host
    batches equal local decode's (the name is kept from when they
    refused to compile)."""
    from lance_distributed_training_tpu_torch.fleet import FleetLoader
    from lance_distributed_training_tpu_torch.service import RemoteLoader

    addr = live_service[0] if transport == "service" else live_service[1]

    def build(m):
        kind = (m.ServiceTransport if transport == "service"
                else m.FleetTransport)
        return m.LoaderGraph(
            m.LanceSource(None, "batch", 16, 0, 1),
            m.Decode(task_type="classification", image_size=SIZE),
            m.Prefetch(2), kind(addr, job_id="graph"), m.Buffers(None),
            m.DevicePut(None))

    graph = build(G)
    assert graph.describe() == build(JG).describe()
    graph.load_state_dict({"step": 3})  # staged: nothing dialed yet
    assert graph.state_dict() == {"step": 3} and graph._runtime is None
    engine = graph.compile()
    assert isinstance(engine, RemoteLoader if transport == "service"
                      else FleetLoader)
    assert len(graph) == 240 // 16
    got = [batch_digest(b) for b in graph]
    local = G.LoaderGraph(
        G.LanceSource(Dataset(image_dataset.uri), "batch", 16, 0, 1),
        G.Decode(ImageClassificationDecoder(SIZE)), G.InProcess())
    assert got == [batch_digest(b) for b in local][3:]


def test_cursor_reads_never_compile():
    graph = G.LoaderGraph(
        G.LanceSource(None, "batch", 16, 0, 1, dataset_fingerprint="fp"),
        G.Decode(image_size=32), G.ServiceTransport("127.0.0.1:9"))
    assert graph.state_dict() == {"step": 0}
    graph.load_state_dict({"step": 3})
    assert graph.state_dict() == {"step": 3}
    assert graph._runtime is None
    with pytest.raises(ValueError, match="negative resume cursor"):
        graph.load_state_dict({"step": -1})


def test_staged_cursor_applied_at_compile(image_dataset):
    ds = Dataset(image_dataset.uri)

    def graph():
        return G.LoaderGraph(G.LanceSource(ds, "batch", 16, 0, 1),
                             G.Decode(_decoder()), G.InProcess())

    full = _digests(graph())
    assert len(full) >= 4
    resumed = graph()
    resumed.load_state_dict({"epoch": 0, "step": 2})  # staged
    assert resumed._runtime is None
    assert _digests(resumed) == full[2:]
    assert resumed.state_dict() == {"epoch": 0, "step": len(full)}


# -- the parity matrix --------------------------------------------------------


def _decoder(m=G):
    if m is G:
        return ImageClassificationDecoder(SIZE, use_native=False)
    return jax_decode.ImageClassificationDecoder(image_size=SIZE,
                                                 use_native=False)


def _digests(loader):
    return [batch_digest(b) for b in loader]


@pytest.fixture()
def caches(tmp_path, request):
    """``(port cache, JAX cache, the port cache's registry)`` when the
    case's cache is on."""
    if not request.param:
        yield None, None, None
        return
    registry = MetricsRegistry()
    port = BatchCache(cache_dir=str(tmp_path / "port"), ram_budget_mb=8,
                      disk_budget_mb=64, registry=registry)
    jax = jax_cache.BatchCache(cache_dir=str(tmp_path / "jax"),
                               ram_budget_mb=8, disk_budget_mb=64,
                               registry=JaxRegistry())
    yield port, jax, registry
    port.close()
    jax.close()


@pytest.fixture()
def image_folder(tmp_path):
    """root/<class>/<img>.jpg, 3 classes x 10 images (JAX test_graph's)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path / "folder"
    for cls in ["apple", "banana", "cherry"]:
        d = root / cls
        d.mkdir(parents=True)
        for i in range(10):
            arr = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    return str(root)


@pytest.fixture()
def token_dataset(tmp_path):
    return create_variable_length_token_dataset(
        str(tmp_path / "toks"), rows=96, vocab_size=100, max_len=48,
        mean_len=10.0, seed=0)


def _token_decoder(m):
    if m is JG:
        tp = jax_token_pack
        return tp.TokenDecoder(mode="pack", seq_len=48,
                               planner=tp.TokenPackPlanner(tp.TokenPackConfig(
                                   pack_len=48, rows_multiple=2)))
    return TokenDecoder(mode="pack", seq_len=48, planner=TokenPackPlanner(
        TokenPackConfig(pack_len=48, rows_multiple=2)))


def _coeff_decoder(m):
    if m is JG:
        from lance_distributed_training_tpu.data.device_decode import (
            CoeffImageDecoder as JaxCoeff,
        )

        return JaxCoeff(image_size=SIZE)
    from lance_distributed_training_tpu_torch.data.device_decode import (
        CoeffImageDecoder,
    )

    return CoeffImageDecoder(image_size=SIZE)


def _case(kind, m, data, cache):
    """``(graph factory (resume=0), direct port engine factory)`` of one
    parity case over module ``m``'s nodes."""
    ds = None if kind == "folder" else (
        JaxDataset(data) if m is JG else Dataset(data))

    def graph(resume=0):
        if kind in ("iterable", "device-decode", "token-pack"):
            dec = {"iterable": _decoder, "device-decode": _coeff_decoder,
                   "token-pack": _token_decoder}[kind](m)
            nodes = (m.LanceSource(ds, "batch", 16, 0, 1), m.Decode(dec))
        elif kind == "map-style":
            nodes = (m.MapStyleSource(ds, 16, 0, 1, seed=7),
                     m.Decode(_decoder(m), columns=["image", "label"]))
        elif kind == "folder":
            nodes = (m.FolderSource(data, 10, 0, 1, seed=3),
                     m.Decode(_decoder(m)))
        else:
            def read(idx, _ds=ds):
                return _ds.take(idx, columns=["image", "label"])
            nodes = (m.EvalSource(read, ds.count_rows(), 32, 0, 1),
                     m.Decode(_decoder(m)))
        fp = ds.fingerprint() if kind == "eval" else None
        g = m.LoaderGraph(*nodes, m.Cache(cache, dataset_fingerprint=fp),
                          m.InProcess())
        if resume:
            g.load_state_dict({"epoch": 0, "step": resume})
        return g

    def engine():
        if kind in ("iterable", "device-decode", "token-pack"):
            dec = {"iterable": _decoder, "device-decode": _coeff_decoder,
                   "token-pack": _token_decoder}[kind](G)
            plan = make_plan("batch", ds.fragment_rows(), 16, 0, 1)
            return TrainLoader(ds, plan, dec, None)
        if kind == "map-style":
            return MapStylePipeline(ds, 16, 0, 1, _decoder(), None, seed=7,
                                    columns=["image", "label"])
        if kind == "folder":
            return FolderDataPipeline(data, 10, 0, 1, _decoder(), None,
                                      seed=3)
        return EvalLoader(
            lambda idx: ds.take(idx, columns=["image", "label"]),
            padded_eval_index_batches(ds.count_rows(), 32, 0, 1),
            _decoder(), None)

    return graph, engine


KINDS = ["iterable", "map-style", "folder", "eval", "device-decode",
         "token-pack"]


@pytest.mark.parametrize("caches", [False, True], indirect=True,
                         ids=["cache-off", "cache-on"])
@pytest.mark.parametrize("kind", KINDS)
def test_parity_matrix(kind, caches, image_dataset, image_folder,
                       token_dataset, request):
    if kind == "device-decode":
        # The JAX coefficient extractor, built for this module alone
        # (tests/torch_jax_native.py).
        assert request.getfixturevalue("jax_native").native_available()
    data = {"folder": image_folder,
            "token-pack": token_dataset.uri}.get(kind, image_dataset.uri)
    port_cache, jax_cache_, registry = caches
    graph, engine = _case(kind, G, data, port_cache)
    jax_graph, _ = _case(kind, JG, data, jax_cache_)
    want = _digests(jax_graph())
    assert len(want) >= 3
    assert _digests(engine()) == want
    got_graph = graph()
    assert isinstance(got_graph.compile(), type(engine()))
    assert _digests(got_graph) == want
    if port_cache is not None:
        hits = registry.counter("cache_hit_total")
        before = hits.value
        assert _digests(graph()) == want  # a warm epoch: pure hits
        assert hits.value - before == len(want)
    if kind == "eval":
        return  # one pass: the eval loader carries no resume cursor
    partial = graph()
    it = iter(partial)
    head = [batch_digest(next(it)) for _ in range(2)]
    it.close()
    assert head == want[:2] and partial.state_dict()["step"] == 2
    assert _digests(graph(resume=2)) == want[2:]


# -- the factories and the trainer's arms ------------------------------------


def test_factories_return_compiled_graphs(image_dataset):
    ds = Dataset(image_dataset.uri)
    train = make_train_pipeline(ds, "batch", 16, 0, 1, _decoder(), None)
    mapped = make_map_style_pipeline(ds, 16, 0, 1, _decoder(), None, seed=7)
    evals = make_eval_pipeline(lambda idx: ds.take(idx), ds.count_rows(), 32,
                               0, 1, _decoder(), None)
    for graph, engine in ((train, TrainLoader), (mapped, MapStylePipeline),
                          (evals, EvalLoader)):
        assert isinstance(graph, G.LoaderGraph)
        assert isinstance(graph._runtime, engine)
        assert graph.state_dict()["step"] == 0
    assert len(train) == ds.count_rows() // 16
    assert train.cursor_owner() == "LanceSource"
    assert [t.name for t in train.tunables()] == ["prefetch"]
    assert train.set_prefetch(3) == 3 == train.prefetch
    mapped.set_epoch(2)
    assert mapped.state_dict() == {"epoch": 2, "step": 0}
    with pytest.raises(AttributeError):
        train.not_a_loader_attribute
    # The same stream as JAX's factory, through the graph.
    want = jax_pipeline.make_train_pipeline(
        image_dataset, "batch", 16, 0, 1, _decoder(JG))
    assert _digests(train) == _digests(want)


def test_engine_surface_reaches_through_place(image_folder):
    plane = PlacementPlane(torch.device("cpu"))
    graph = G.LoaderGraph(G.FolderSource(image_folder, 10, 0, 1),
                          G.Decode(_decoder()), G.Place(plane))
    assert graph.num_classes == 3  # under the PlacedLoader wrap
    assert graph.placement_counters is plane.counters
    assert graph.counters is None  # the engine keeps no service counters
    assert graph.cursor_owner() == "Place"
    assert graph.state_dict()["step"] == 0
    assert graph.set_prefetch(4) == 4  # the engine's, under the wrap
    assert {t.name for t in graph.tunables()} >= {"ring_depth", "prefetch"}
    batches = list(graph)
    assert len(batches) == 3 and isinstance(batches[0]["image"],
                                            torch.Tensor)
    with pytest.raises(AttributeError):
        graph.not_a_loader_attribute


ARMS = [("iterable", "columnar"), ("map", "columnar"), ("map", "folder"),
        ("iterable", "folder"), ("eval", "columnar"), ("eval", "folder")]


@pytest.mark.parametrize("placed", [True, False], ids=["place", "sync"])
@pytest.mark.parametrize("arm,fmt", ARMS)
def test_trainer_arms_are_loader_graphs(arm, fmt, placed, image_dataset,
                                        image_folder):
    device = torch.device("cpu")
    path = image_folder if fmt == "folder" else image_dataset.uri
    config = trainer.TrainConfig(
        dataset_path=path, data_format=fmt, device="cpu", batch_size=10,
        image_size=SIZE, num_classes=10, global_batch=placed,
        loader_style="map" if arm == "map" else "iterable")
    decode = trainer._decoder_for(config)
    dataset = None if fmt == "folder" else Dataset(path)
    if arm == "eval":
        if fmt == "folder":
            direct = FolderDataPipeline(path, 10, 0, 1, decode, None)
            samples = direct.samples
            read, total = (lambda idx: trainer.read_sample_batch(samples,
                                                                 idx),
                           len(samples))
        else:
            read, total = (lambda idx: dataset.take(idx)), \
                dataset.count_rows()
        loader = trainer._build_eval_loader(config, device, read, total,
                                            decode)
        source = G.EvalSource
    else:
        loader = trainer._build_loader(config, dataset, decode, device, 0,
                                       10, 0, 1)
        source = {"iterable": G.LanceSource, "map": G.MapStyleSource}[arm] \
            if fmt == "columnar" else G.FolderSource
    assert isinstance(loader, G.LoaderGraph)
    assert loader._runtime is not None  # compiled at assembly
    assert isinstance(loader.source, source)
    assert (loader.node("place") is not None) is placed
    assert (loader.node("device_put").device is None) is placed
    assert loader.cursor_owner() == ("Place" if placed
                                     else type(loader.source).__name__)
    batch = next(iter(loader))
    assert isinstance(batch["image"], torch.Tensor)
    assert batch["image"].shape[0] == 10


def test_trainer_refusals_keep_their_messages(image_dataset, image_folder):
    device = torch.device("cpu")
    ds = Dataset(image_dataset.uri)
    config = trainer.TrainConfig(dataset_path=image_dataset.uri,
                                 device="cpu", batch_size=400,
                                 image_size=SIZE)
    decode = trainer._decoder_for(config)
    with pytest.raises(ValueError, match="empty plan: 240 rows cannot fill "
                       "one batch of 400 on each of 1 processes"):
        trainer._build_loader(config, ds, decode, device, 0, 400, 0, 1)
    config.loader_style = "map"
    with pytest.raises(ValueError, match="empty plan: dataset smaller than "
                       "one global batch"):
        trainer._build_loader(config, ds, decode, device, 0, 400, 0, 1)
    with pytest.raises(ValueError, match="keeps 3 rows"):
        trainer._build_loader(config, ds, decode, device, 0, 400, 0, 1,
                              index_pool=np.arange(3))
    folder = trainer.TrainConfig(dataset_path=image_folder,
                                 data_format="folder", device="cpu",
                                 batch_size=10, image_size=SIZE,
                                 num_classes=2)
    with pytest.raises(ValueError, match="folder has 3 class directories"):
        trainer._build_loader(folder, None, decode, device, 0, 10, 0, 1)
    folder.batch_size = 64
    with pytest.raises(ValueError, match="folder smaller than one global"):
        trainer._build_loader(folder, None, decode, device, 0, 64, 0, 1)
