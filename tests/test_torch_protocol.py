"""The port's wire protocol (``service/protocol.py``), golden corpus
(``service/goldens.py``), wire sanitizer (``utils/wiretrack.py``) and
retry policy (``utils/retry.py``) against the JAX package's.

Every golden under ``tests/goldens/protocol/`` is built byte for byte by
the port's encoders, decodes, and re-encodes to the same bytes in both
packages; the port's ``protocol goldens`` gate passes and its
``--update`` writes the JAX corpus's bytes to another directory, never to
the checked-in one. ``decode_batch(pool=...)`` copies a batch into pages
of the port's ``BufferPool``: the coefficient golden keeps K2's page
schema and the ragged golden comes out as the port's ragged page pair
(K3's layout, its capacity bucket declared in the meta). HELLO
construction, its type gate, address parsing, the wire witness's counts
and the retry delays from one seed equal JAX's; ``build_info`` lists the
wire sanitizer in both packages when it is on.
"""

import json
import socket
from pathlib import Path

import numpy as np
import pytest

from lance_distributed_training_tpu.obs import http as jax_http
from lance_distributed_training_tpu.service import goldens as JG
from lance_distributed_training_tpu.service import protocol as JP
from lance_distributed_training_tpu.utils import retry as jax_retry
from lance_distributed_training_tpu.utils import wiretrack as jax_wiretrack
from lance_distributed_training_tpu_torch.data.buffers import BufferPool
from lance_distributed_training_tpu_torch.data.token_pack import (
    is_ragged_batch,
    pack_meta,
)
from lance_distributed_training_tpu_torch.obs import http
from lance_distributed_training_tpu_torch.obs.registry import MetricsRegistry
from lance_distributed_training_tpu_torch.service import goldens as G
from lance_distributed_training_tpu_torch.service import protocol as P
from lance_distributed_training_tpu_torch.utils import retry, wiretrack
from test_torch_threads import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "goldens" / "protocol"
NAMES = [spec.name for spec in JG.GOLDEN_SPECS]


def test_the_port_has_every_golden_of_jax():
    assert [s.name for s in G.GOLDEN_SPECS] == NAMES
    assert [(s.version, s.msg, s.legacy, s.batch) for s in G.GOLDEN_SPECS] \
        == [(s.version, s.msg, s.legacy, s.batch) for s in JG.GOLDEN_SPECS]


@pytest.mark.parametrize("name", NAMES)
def test_golden_is_built_and_round_trips_in_both_packages(name):
    data = (CORPUS / f"{name}.bin").read_bytes()
    port = {s.name: s for s in G.GOLDEN_SPECS}[name]
    jax = {s.name: s for s in JG.GOLDEN_SPECS}[name]
    assert G.build_golden(port) == JG.build_golden(jax) == data
    assert G._roundtrip_errors(port, data) == []
    assert JG._roundtrip_errors(jax, data) == []
    if port.batch:
        # Decoded by either package, re-encoded by the other: the bytes.
        _t, payload = G._split_frame(data)
        step, batch, lineage, trace = P.decode_batch(
            payload, with_trace=True)
        again = JP.encode_batch(step, batch, lineage, trace=trace)
        assert again == bytes(payload)


def test_goldens_gate_passes_and_update_never_writes_the_corpus(
        tmp_path, monkeypatch):
    assert G.verify_goldens(str(CORPUS)) == []
    monkeypatch.chdir(ROOT)
    out = []

    class Sink:
        write = out.append

    assert G.goldens_main(["goldens"], out=Sink()) == 0
    assert "31 goldens round-trip byte-identically" in "".join(out)
    before = {p.name: p.read_bytes() for p in CORPUS.iterdir()}
    assert G.goldens_main(["goldens", "--update"], out=Sink()) == 2
    assert {p.name: p.read_bytes() for p in CORPUS.iterdir()} == before
    G.goldens_main(["goldens", "--update", "--dir", str(tmp_path / "p")],
                   out=Sink())
    JG.goldens_main(["goldens", "--update", "--dir", str(tmp_path / "j")],
                    out=Sink())
    port = {p.name: p.read_bytes() for p in (tmp_path / "p").iterdir()}
    jax = {p.name: p.read_bytes() for p in (tmp_path / "j").iterdir()}
    assert port == jax == before


def _golden_batch(name, pool=None):
    _t, payload = G._split_frame((CORPUS / f"{name}.bin").read_bytes())
    return P.decode_batch(payload, with_lineage=True, pool=pool)


def test_pixel_golden_lands_in_pages_of_the_port_pool():
    pool = BufferPool()
    step, batch, lineage = _golden_batch("v1_batch_pixels", pool)
    assert step == 4 and lineage is None
    expected = G._golden_tensors()
    for key, value in expected.items():
        np.testing.assert_array_equal(batch[key], value)
        assert pool.owns(batch[key]) == (value.size > 0)
    assert pool.release_batch(batch) == sum(v.size > 0
                                            for v in expected.values())


def test_coeff_golden_keeps_the_page_schema_k2_takes():
    pool = BufferPool()
    _step, batch, lineage = _golden_batch("v3_batch_coeff", pool)
    assert lineage == G._GOLDEN_LINEAGE
    want = G._golden_coeff_tensors()
    assert list(batch) == list(want)
    for key in want:
        assert batch[key].dtype == want[key].dtype
        np.testing.assert_array_equal(batch[key], want[key])
        assert pool.owns(batch[key])
    assert batch["jpeg_coef_y"].dtype == np.int16


def test_ragged_golden_is_the_port_ragged_page():
    pool = BufferPool()
    _step, batch, _lineage = _golden_batch("v4_batch_ragged", pool)
    assert is_ragged_batch(batch)
    want = G._golden_ragged_tensors()
    for key in want:
        np.testing.assert_array_equal(batch[key], want[key])
    values = batch["input_ids__values"]
    assert values.dtype == np.int32 and pool.owns(values)
    # The capacity bucket rides the meta, and the page is that bucket.
    assert P.ragged_meta(batch) == {"input_ids": values.shape[0]}
    assert pack_meta(batch) == tuple(int(x) for x in
                                     want["_host_pack_meta"])


def test_torn_ragged_capacity_refused_as_jax_refuses():
    batch = G._golden_ragged_tensors()
    metas, body = P.encode_tensors(batch)
    meta = P.encode_batch_meta(0, metas, ragged={"input_ids": 3})
    payload = P._META_LEN.pack(len(meta)) + meta + body
    messages = []
    for proto in (P, JP):
        with pytest.raises(proto.ProtocolError) as info:
            proto.decode_batch(payload)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert "declared capacity bucket" in messages[0]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(version=1),
    dict(version=3, stripe_index=1, stripe_count=2, device_decode=True),
    dict(version=4, token_pack=True, seq_len=128),
    dict(job_id="tenant-a", job_priority="bulk", start_step=7,
         dataset_fingerprint="ab" * 32),
])
def test_hello_equals_jax(kw):
    base = dict(batch_size=16, process_index=0, process_count=2)
    port, jax = P.hello(**base, **kw), JP.hello(**base, **kw)
    assert port == jax
    assert json.dumps(port) == json.dumps(jax)  # key order too
    assert P.hello_malformed(port) == JP.hello_malformed(jax)


@pytest.mark.parametrize("field,bad", [
    ("batch_size", "16"), ("process_count", True), ("stripe_index", 1.5),
    ("job_id", 3), ("device_decode", "true"), ("columns", "image"),
])
def test_hello_type_gate_equals_jax(field, bad):
    msg = P.hello(batch_size=16, process_index=0, process_count=1)
    msg[field] = bad
    assert P.hello_malformed(msg) == JP.hello_malformed(dict(msg))
    assert P.hello_malformed(msg) is not None


@pytest.mark.parametrize("addr", ["h:1", "[::1]:8476", "10.0.0.1:80",
                                  "no-port", ":5", "h:x"])
def test_parse_hostport_equals_jax(addr):
    def parse(mod):
        try:
            return mod.parse_hostport(addr)
        except ValueError as exc:
            return str(exc)
    assert parse(P) == parse(JP)


@pytest.fixture()
def witness():
    """Both packages' wire recorders, enabled and empty, restored after."""
    saved = (wiretrack.snapshot(), jax_wiretrack.snapshot())
    for mod in (wiretrack, jax_wiretrack):
        mod.reset()
        mod.enable()
    yield
    wiretrack.restore(saved[0])
    jax_wiretrack.restore(saved[1])


def _traffic(proto):
    a, b = socket.socketpair()
    try:
        proto.send_msg(a, proto.MSG_HELLO, proto.hello(
            batch_size=4, process_index=0, process_count=1, version=2))
        proto.FrameReader(b).recv_msg()
        proto.send_msg(a, proto.MSG_ACK, {"step": 3})
        proto.recv_msg(b)
        proto.send_frame(a, proto.MSG_BATCH, proto.encode_batch(
            0, {"x": np.ones((2, 2), np.float32)}))
        proto.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_wire_witness_counts_equal_jax(witness, tmp_path):
    _traffic(P)
    _traffic(JP)
    port, jax = wiretrack.snapshot(), jax_wiretrack.snapshot()
    assert port == jax
    assert wiretrack.frames()[P.MSG_ACK] == 2  # a send and a receive
    assert 2 in port["versions"][P.MSG_HELLO]
    path = wiretrack.dump(str(tmp_path / "w.json"))
    assert json.loads(Path(path).read_text())["frames"] == json.loads(
        Path(jax_wiretrack.dump(str(tmp_path / "j.json"))).read_text()
    )["frames"]


def test_build_info_lists_the_wire_sanitizer_in_both_packages(witness):
    """The port lists the leak and wire sanitizers (it has no compile
    tracker); with the wire witness on, both packages say ``wire``."""
    assert "wire" in http.build_info()["sanitizers_active"]
    assert "wire" in jax_http.build_info()["sanitizers_active"]
    wiretrack.disable()
    assert "wire" not in http.build_info()["sanitizers_active"]
    info = http.build_info()
    assert info["version"] == "0.1.0"
    assert info["protocol_versions"] == [P.MIN_PROTOCOL_VERSION,
                                         P.PROTOCOL_VERSION]


@pytest.mark.parametrize("policy", [
    dict(),
    dict(attempts=8, base_s=0.001, cap_s=0.004),
    dict(attempts=4, base_s=0.002, jitter=False),
])
def test_retry_delays_equal_jax_from_one_seed(policy):
    """The same schedule from the same seed: the delays each package's
    ``retrying`` waits between attempts (a stop event that records its
    waits stands in for the clock)."""
    def delays(mod, registry):
        waits = []

        class Recorder:
            def wait(self, delay):
                waits.append(delay)
                return False

            def is_set(self):
                return False

        kw = dict(policy)
        kw.setdefault("base_s", 0.0001)
        attempts = list(mod.retrying(
            mod.RetryPolicy(**kw), stop=Recorder(), registry=registry,
            _rng=np.random.default_rng(11)))
        return attempts, waits

    port = delays(retry, MetricsRegistry())
    jax = delays(jax_retry, None)
    assert port == jax
    assert len(port[1]) == len(port[0]) - 1


def test_retry_stop_interrupts_as_jax():
    import threading

    messages = []
    for mod in (retry, jax_retry):
        stop = threading.Event()
        stop.set()
        with pytest.raises(ConnectionError) as info:
            list(mod.retrying(mod.RetryPolicy(), stop=stop,
                              interrupt_message="closed"))
        messages.append(str(info.value))
    assert messages == ["closed", "closed"]
