"""The port's data service (``service/server.py``, ``service/client.py``)
against the JAX package's.

Loopback servers run in this process on 127.0.0.1 over the session's
32 px JPEG set (240 rows) and a variable-length token set. Three kinds of
batch cross the wire: decoded pixels, JPEG coefficient pages
(``device_decode``) and ragged token pages (``token_pack``). Every stream
is held bit for bit against the port's local pipeline over the same
decoder: the port's loader reading the port's server, the port's loader
reading a JAX server and a JAX loader reading the port's server. The
coefficient and ragged batches then go through the plain versions of K2
and K3, as the trainer's transform stage takes them, and equal the local
batches' outputs. The trainer's remote arm refuses what JAX's refuses
with JAX's messages, trains through the port's service to the same
losses as its local run, and serves ``/metrics`` with the ``svc_*`` and
``lineage_*`` series. The subcommands' parsers equal JAX's.

The harness functions here (``serve``, ``local_batches``, ``CASES``) are
shared by ``test_torch_fleet.py`` and ``test_torch_jobs.py``, and so is
the module fixture ``_private_jax_decoder``: the JAX servers decode with
the JAX package's native decoder built for the module
(``tests/torch_jax_native.py``), whichever test process won the JAX
package's shared build, and a test shows the streams match when that
build had failed in the process.
"""

import json
import socket
import urllib.request

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu import cli as jax_cli
from lance_distributed_training_tpu import service as jax_service
from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.data.authoring import (
    create_variable_length_token_dataset,
)
from lance_distributed_training_tpu_torch import cli, service, trainer
from lance_distributed_training_tpu_torch.data.buffers import BufferPool
from lance_distributed_training_tpu_torch.data.decode import decoder_for_task
from lance_distributed_training_tpu_torch.data.format import Dataset
from lance_distributed_training_tpu_torch.data.pipeline import (
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.data.token_pack import (
    TokenPackConfig,
    is_ragged_batch,
)
from lance_distributed_training_tpu_torch.ops.jpeg_device import (
    make_batch_transform,
)
from lance_distributed_training_tpu_torch.ops.token_device import (
    make_pack_transform,
)
from lance_distributed_training_tpu_torch.parallel.mesh import (
    make_global_batch,
)
from lance_distributed_training_tpu_torch.service import protocol as P
from lance_distributed_training_tpu_torch.utils.chaos import batch_digest
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_jax_native import jax_native, private_jax_native  # noqa: F401

SIZE, SEQ, BATCH = 32, 48, 16
PACKAGES = {"port": service, "jax": jax_service}

# Each kind of batch: the server's decode knobs, which the client
# declares too (the server refuses a mismatch at connect time).
CASES = {
    "pixels": dict(task_type="classification", image_size=SIZE),
    "coeff": dict(task_type="classification", image_size=SIZE,
                  device_decode=True),
    "ragged": dict(task_type="causal_lm", seq_len=SEQ, token_pack=True),
}


@pytest.fixture(scope="module", autouse=True)
def _private_jax_decoder(jax_native):  # noqa: F811 (fixture)
    """The JAX package's native decoder, built for this module: a JAX
    server's pixels and coefficient pages are then the port's native
    decode's, as the tests hold them."""
    return jax_native


@pytest.fixture()
def token_dataset(tmp_path):
    return create_variable_length_token_dataset(
        str(tmp_path / "toks"), rows=96, vocab_size=100, max_len=SEQ,
        fragment_size=40)


def dataset_for(case, image_dataset, token_dataset):
    return token_dataset if case == "ragged" else image_dataset


def serve(pkg, uri, case="pixels", **kw):
    """A started loopback ``DataService`` of package ``pkg``."""
    knobs = dict(CASES[case])
    if "seq_len" not in knobs:
        knobs["seq_len"] = 128
    return PACKAGES[pkg].DataService(PACKAGES[pkg].ServeConfig(
        dataset_path=uri, host="127.0.0.1", port=0, queue_depth=2,
        **knobs, **kw)).start()


def client_knobs(case):
    """The decode knobs a client declares for ``case``."""
    knobs = dict(CASES[case])
    knobs.setdefault("device_decode", False)
    knobs.setdefault("token_pack", False)
    return knobs


def local_decoder(case):
    knobs = CASES[case]
    if case == "ragged":
        return decoder_for_task(
            "causal_lm", seq_len=SEQ,
            token_pack=TokenPackConfig(pack_len=SEQ, rows_multiple=8))
    return decoder_for_task("classification", image_size=SIZE,
                            device_decode=knobs.get("device_decode", False))


def local_batches(uri, case="pixels", process_index=0, process_count=1,
                  **kw):
    """The port's in-process batches of ``case``, the reference of every
    remote stream."""
    return list(make_train_pipeline(
        Dataset(uri), "batch", BATCH // process_count, process_index,
        process_count, local_decoder(case), None, **kw))


def remote_loader(pkg, addr, case="pixels", process_index=0,
                  process_count=1, **kw):
    """A ``RemoteLoader`` of package ``pkg`` declaring ``case``'s knobs."""
    kw.setdefault("connect_retries", 2)
    kw.setdefault("backoff_s", 0.01)
    return PACKAGES[pkg].RemoteLoader(
        addr, BATCH // process_count, process_index, process_count,
        **client_knobs(case), **kw)


def digests(batches):
    return [batch_digest(b) for b in batches]


def transformed(case, batch):
    """A host batch as the trainer's transform stage leaves it on the CPU:
    K2's plain version on coefficient pages, K3's on ragged pages."""
    placed = make_global_batch(batch, torch.device("cpu"))
    if case == "coeff":
        return make_batch_transform(SIZE)(placed)
    if case == "ragged":
        return make_pack_transform()(placed)
    return placed


# -- the port reads itself --------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_loader_matches_local_pipeline(case, image_dataset,
                                            token_dataset):
    uri = dataset_for(case, image_dataset, token_dataset).uri
    svc = serve("port", uri, case)
    try:
        loader = remote_loader("port", f"127.0.0.1:{svc.port}", case)
        local = local_batches(uri, case)
        assert len(loader) == len(local) > 2
        remote = list(loader)
        assert digests(remote) == digests(local)
        if case == "ragged":
            assert all(is_ragged_batch(b) for b in remote)
        if case != "pixels":
            # The batches K2 and K3 take: their plain versions give the
            # local batch's output, bit for bit.
            for got, want in zip(remote[:2], local[:2]):
                assert batch_digest(transformed(case, got)) == \
                    batch_digest(transformed(case, want))
    finally:
        svc.stop()


# -- across the two packages -------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("loader_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_loaders_stream_from_the_other_packages_server(
        loader_pkg, server_pkg, case, image_dataset, token_dataset):
    uri = dataset_for(case, image_dataset, token_dataset).uri
    svc = serve(server_pkg, uri, case)
    try:
        loader = remote_loader(loader_pkg, f"127.0.0.1:{svc.port}", case,
                               shuffle=True, seed=3)
        remote = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
        assert digests(remote) == digests(
            local_batches(uri, case, shuffle=True, seed=3))
        assert loader.last_lineage is not None  # v2 lineage crossed
        assert loader.last_trace is not None  # v5 trace crossed
    finally:
        svc.stop()


def test_two_shards_of_a_jax_server_are_the_local_shards(image_dataset):
    svc = serve("jax", image_dataset.uri)
    try:
        for rank in range(2):
            loader = remote_loader("port", f"127.0.0.1:{svc.port}",
                                   process_index=rank, process_count=2)
            assert digests(loader) == digests(local_batches(
                image_dataset.uri, process_index=rank, process_count=2))
    finally:
        svc.stop()


@pytest.mark.parametrize("case", ["pixels", "coeff"])
def test_jax_server_streams_match_after_the_shared_build_failed(
        case, image_dataset, jax_native, monkeypatch):  # noqa: F811
    """A test process whose JAX build lost the race keeps ``_load_failed``
    (its JAX decoder would take PIL, or refuse coefficient pages); the
    module's private build restores the JAX server's native decode."""
    from pathlib import Path

    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_failed", True)
    assert not jax_native.native_available()
    with private_jax_native(Path(jax_native._LIB_PATH).parent):
        svc = serve("jax", image_dataset.uri, case)
        try:
            loader = remote_loader("port", f"127.0.0.1:{svc.port}", case)
            assert digests(loader) == digests(local_batches(
                image_dataset.uri, case))
        finally:
            svc.stop()
    assert not jax_native.native_available()


# -- the client's cursor, pool and placement ---------------------------------


@pytest.fixture()
def port_service(image_dataset):
    svc = serve("port", image_dataset.uri)
    yield svc
    svc.stop()


def test_reconnect_resumes_at_cursor(image_dataset, port_service):
    loader = remote_loader("port", f"127.0.0.1:{port_service.port}")
    got = []
    for i, batch in enumerate(loader):
        got.append(batch_digest(batch))
        if i == 4:
            loader._close_conn()  # a dropped connection mid-epoch
    assert got == digests(local_batches(image_dataset.uri))
    assert loader.counters.snapshot()["svc_reconnects"] >= 1


def test_fresh_client_resumes_from_a_cursor(image_dataset, port_service):
    loader = remote_loader("port", f"127.0.0.1:{port_service.port}")
    loader.load_state_dict({"epoch": 0, "step": 6})
    assert loader.state_dict() == {"epoch": 0, "step": 6}
    assert digests(loader) == digests(local_batches(image_dataset.uri))[6:]
    assert loader.state_dict()["step"] == len(loader)


def test_pool_pages_go_back_after_placement(image_dataset, port_service):
    """The received tensors land in pages of the port's pool; placed on a
    device, every page returns to the pool with the batch."""
    pool = BufferPool()
    loader = remote_loader("port", f"127.0.0.1:{port_service.port}",
                           device=torch.device("cpu"), buffer_pool=pool)
    local = local_batches(image_dataset.uri)
    for got, want in zip(loader, local):
        assert isinstance(got["image"], torch.Tensor)
        np.testing.assert_array_equal(got["image"].numpy(), want["image"])
    assert pool.stats()["outstanding"] == 0
    assert pool.counters()["hits"] > 0  # later batches reuse the pages


def test_host_batches_return_their_pages_after_their_turn(image_dataset,
                                                         port_service):
    pool = BufferPool()
    loader = remote_loader("port", f"127.0.0.1:{port_service.port}",
                           buffer_pool=pool)
    for batch in loader:
        assert pool.owns(batch["image"])
    assert pool.stats()["outstanding"] == 0


def test_early_stop_drains_cleanly(port_service):
    loader = remote_loader("port", f"127.0.0.1:{port_service.port}")
    it = iter(loader)
    next(it)
    it.close()  # the receiver thread and the socket go with it
    assert loader._conn is None


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_unreachable_service_raises_after_backoff():
    port = _closed_port()
    errors = {}
    for pkg in PACKAGES:
        loader = PACKAGES[pkg].RemoteLoader(
            f"127.0.0.1:{port}", BATCH, 0, 1, connect_retries=2,
            backoff_s=0.01)
        with pytest.raises(ConnectionError) as info:
            len(loader)
        errors[pkg] = str(info.value)
    assert errors["port"] == errors["jax"]
    assert "after 2 attempts" in errors["port"]


@pytest.mark.parametrize("declared", [
    dict(image_size=64),
    dict(task_type="masked_lm"),
    dict(device_decode=True),
    dict(dataset_fingerprint="0" * 64),
])
def test_decode_config_skew_refused_as_jax_refuses(image_dataset, declared):
    messages = {}
    for pkg in PACKAGES:
        svc = serve(pkg, image_dataset.uri)
        try:
            kw = dict(task_type="classification", image_size=SIZE)
            kw.update(declared)
            loader = PACKAGES[pkg].RemoteLoader(
                f"127.0.0.1:{svc.port}", BATCH, 0, 1, connect_retries=1,
                **kw)
            with pytest.raises(RuntimeError) as info:
                list(loader)
            messages[pkg] = str(info.value)
        finally:
            svc.stop()
    assert messages["port"] == messages["jax"]
    assert "skew" in messages["port"]


def test_bad_shard_and_full_sampler_refused(image_dataset, port_service):
    addr = f"127.0.0.1:{port_service.port}"
    with pytest.raises(RuntimeError, match="invalid shard"):
        list(service.RemoteLoader(addr, 8, 3, 2, connect_retries=1))
    with pytest.raises(RuntimeError, match="not DP-aware"):
        list(service.RemoteLoader(addr, 8, 0, 2, sampler_type="full",
                                  connect_retries=1))


def test_server_pool_is_unpinned(image_dataset, port_service):
    """A decode server page-locks nothing: pinning would create a CUDA
    context in a process that never uses a card."""
    assert port_service.buffer_pool is not None
    assert not port_service.buffer_pool.pin_memory


_HOST_PROCESS = r"""
import contextlib, io, sys
from lance_distributed_training_tpu_torch.cli import main
from lance_distributed_training_tpu_torch.fleet import (
    Coordinator, CoordinatorConfig, FleetLoader)
from lance_distributed_training_tpu_torch.service import (
    DataService, RemoteLoader, ServeConfig)
uri, size = sys.argv[1], 32
coord = Coordinator(CoordinatorConfig(host="127.0.0.1", port=0,
                                      lease_ttl_s=30.0)).start()
addr = f"127.0.0.1:{coord.port}"
for dd in (False, True):
    svc = DataService(ServeConfig(
        dataset_path=uri, host="127.0.0.1", port=0, image_size=size,
        device_decode=dd, coordinator_addr=addr, metrics_port=0)).start()
    assert svc.fleet_agent.registered.wait(30)
    kw = dict(task_type="classification", image_size=size, device_decode=dd)
    assert len(list(RemoteLoader(f"127.0.0.1:{svc.port}", 16, 0, 1, **kw)))
    assert len(list(FleetLoader(addr, 16, 0, 1, **kw)))
    svc.stop()
with contextlib.redirect_stdout(io.StringIO()):
    assert main(["fleet", "recommend", "--coordinator", addr]) == 0
    assert main(["jobs", "list", "--coordinator", addr]) == 0
    assert main(["protocol", "goldens"]) == 0
coord.stop()
print("TORCH_LOADED", "torch" in sys.modules)
"""


def test_host_processes_never_load_torch(image_dataset):
    """A server (pixels and coefficient pages), a coordinator, host-batch
    clients and the operator subcommands in one fresh interpreter never
    load torch, so they cannot create a CUDA context."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _HOST_PROCESS,
                           image_dataset.uri], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TORCH_LOADED False" in proc.stdout


def test_service_metrics_endpoint_serves_svc_and_lineage(image_dataset):
    svc = serve("port", image_dataset.uri, metrics_port=0)
    try:
        list(remote_loader("port", f"127.0.0.1:{svc.port}"))
        base = f"http://127.0.0.1:{svc.metrics_port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
    finally:
        svc.stop()
    assert "svc_batches_sent" in text and "svc_decode_ms_bucket" in text
    assert "lineage_batch_age_ms_bucket" in text  # this process's client
    assert health["status"] == "ok"
    assert health["build"]["protocol_versions"] == [
        P.MIN_PROTOCOL_VERSION, P.PROTOCOL_VERSION]


# -- the trainer's remote arm --------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(data_service_addr="h:1", coordinator_addr="h:2"),
    dict(job_id="a"),
    dict(data_service_addr="h:1", job_priority="bulk"),
    dict(data_service_addr="h:1", loader_style="map"),
    dict(coordinator_addr="h:1", data_format="folder"),
])
def test_remote_train_config_refused_as_jax_refuses(kw):
    messages = {}
    for name, mod in (("port", trainer), ("jax", jax_trainer)):
        with pytest.raises(ValueError) as info:
            mod.train(mod.TrainConfig(dataset_path="/nonexistent", **kw))
        messages[name] = str(info.value)
    assert messages["port"] == messages["jax"]


def test_remote_filter_refused_as_jax_refuses():
    kw = dict(dataset_path="/nonexistent", data_service_addr="h:1",
              filter="label < 5")
    messages = []
    for mod in (trainer, jax_trainer):
        with pytest.raises(ValueError) as info:
            mod.train(mod.TrainConfig(**kw))
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert "cannot combine with data_service_addr" in messages[0]


def test_remote_run_needs_a_readable_dataset_for_eval_and_horizon():
    cfg = dict(dataset_path="/nonexistent", data_service_addr="h:1",
               device="cpu")
    with pytest.raises(ValueError, match="eval needs the dataset"):
        trainer.train(trainer.TrainConfig(**cfg))
    with pytest.raises(ValueError, match="lr_schedule needs a horizon"):
        trainer.train(trainer.TrainConfig(
            **cfg, eval_at_end=False, lr_schedule="cosine"))


def test_remote_num_workers_warns(image_dataset):
    with pytest.warns(UserWarning, match="num_workers>0 has no effect"):
        with pytest.raises(ValueError):
            trainer.train(trainer.TrainConfig(
                dataset_path="/nonexistent", data_service_addr="h:1",
                num_workers=2, device="cpu"))


def _text_run(path, **kw):
    return trainer.TrainConfig(
        dataset_path=path, task_type="masked_lm", model_name="bert_small",
        vocab_size=100, seq_len=SEQ, token_pack=True, batch_size=8,
        max_steps=4, optimizer="adamw", lr=1e-3, log_every=2,
        autotune=False, device="cpu", no_wandb=True, seed=5, **kw)


def test_trainer_through_the_port_service_matches_local_losses(
        tmp_path, token_dataset, monkeypatch):
    """Bit for bit: the same batches (ragged pages, K3's plain version on
    the CPU) and so the same losses, the eval over every row included;
    and the run's exporter serves the svc_* and lineage_* series."""
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    local = trainer.train(_text_run(token_dataset.uri))
    svc = service.DataService(service.ServeConfig(
        dataset_path=token_dataset.uri, host="127.0.0.1", port=0,
        task_type="masked_lm", seq_len=SEQ, token_pack=True)).start()
    scraped = {}
    from lance_distributed_training_tpu_torch.obs import http

    stop = http.MetricsHTTPServer.stop

    def scrape_then_stop(self):
        base = f"http://127.0.0.1:{self.port}"
        scraped["metrics"] = urllib.request.urlopen(
            base + "/metrics").read().decode()
        scraped["healthz"] = json.loads(
            urllib.request.urlopen(base + "/healthz").read())
        stop(self)

    monkeypatch.setattr(http.MetricsHTTPServer, "stop", scrape_then_stop)
    try:
        remote = trainer.train(_text_run(
            token_dataset.uri, data_service_addr=f"127.0.0.1:{svc.port}",
            metrics_port=0))
    finally:
        svc.stop()
    assert remote["losses"] == local["losses"]
    assert remote["payload_tokens"] == local["payload_tokens"]
    assert remote["eval_rows"] == local["eval_rows"] == 96
    assert remote["eval_accuracy"] == local["eval_accuracy"]
    assert "svc_batches_received" in scraped["metrics"]
    assert "lineage_batch_age_ms_bucket" in scraped["metrics"]
    assert scraped["healthz"]["role"] == "trainer"
    assert scraped["healthz"]["steps"] == 4


# -- the CLI ---------------------------------------------------------------


@pytest.mark.parametrize("name,argv", [
    ("build_serve_parser", ["--dataset_path", "/d", "--port", "0",
                            "--device_decode", "--coordinator", "h:1",
                            "--admission_max_jobs", "2", "--token_pack"]),
    ("build_coordinator_parser", ["--port", "0", "--lease_ttl_s", "1.5"]),
    ("build_fleet_parser", ["recommend", "--coordinator", "h:1", "--json"]),
    ("build_jobs_parser", ["describe", "a", "--coordinator", "h:1"]),
])
def test_subcommand_parsers_equal_jax(name, argv):
    port, jax = getattr(cli, name)(), getattr(jax_cli, name)()
    assert vars(port.parse_args(argv)) == vars(jax.parse_args(argv))
    assert port.format_help() == jax.format_help()


def test_train_cli_takes_the_remote_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(cli, "train",
                        lambda config: seen.__setitem__("config", config))
    cli.main(["train", "--dataset_path", "/d", "--data_service", "h:1",
              "--job_id", "a", "--job_priority", "bulk",
              "--metrics_port", "0", "--metrics_host", "0.0.0.0"])
    config = seen["config"]
    assert (config.data_service_addr, config.coordinator_addr) == ("h:1",
                                                                   None)
    assert (config.job_id, config.job_priority) == ("a", "bulk")
    assert (config.metrics_port, config.metrics_host) == (0, "0.0.0.0")
    cli.main(["--dataset_path", "/d", "--coordinator", "h:2"])
    assert seen["config"].coordinator_addr == "h:2"
