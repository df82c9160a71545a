"""The port's remote-path observability (``obs/tracectx.py``,
``obs/lineage.py``, ``obs/slo.py``, ``obs/http.py``, ``obs/critpath.py``,
the ``trace`` and ``costs`` subcommands) against the JAX package's.

Fed the same inputs, both packages give the same trace contexts (from the
same random bytes), the same lineage histograms, the same SLO gauges and
status over the same ticks, the same ``/metrics`` text and ``/healthz``
body, and the same ``trace export``, ``trace critical-path`` and ``costs
report`` output on the same JSONL. The two ``obs`` packages export the
same names. The trace context and the lineage cross the port's wire from
its server to its client.
"""

import io
import json
import urllib.request

import pytest

from lance_distributed_training_tpu import obs as jax_obs
from lance_distributed_training_tpu.obs import costs as jax_costs
from lance_distributed_training_tpu.obs import critpath as jax_critpath
from lance_distributed_training_tpu.obs import http as jax_http
from lance_distributed_training_tpu.obs import lineage as jax_lineage
from lance_distributed_training_tpu.obs import registry as jax_registry
from lance_distributed_training_tpu.obs import slo as jax_slo
from lance_distributed_training_tpu.obs import spans as jax_spans
from lance_distributed_training_tpu.obs import tracectx as jax_tracectx
from lance_distributed_training_tpu.utils import metrics as jax_metrics
from lance_distributed_training_tpu_torch import cli, obs
from lance_distributed_training_tpu_torch.obs import (
    costs,
    critpath,
    http,
    lineage,
    registry,
    slo,
    spans,
    tracectx,
)
from lance_distributed_training_tpu_torch.utils import metrics
from test_torch_service import remote_loader, serve
from test_torch_threads import _one_torch_thread  # noqa: F401


def test_obs_exports_equal_jax():
    assert sorted(obs.__all__) == sorted(jax_obs.__all__)
    for name in obs.__all__:
        assert hasattr(obs, name)


def _seeded_urandom(monkeypatch, mod):
    state = {"n": 0}

    def urandom(n):
        state["n"] += 1
        return bytes((state["n"] * 7 + i) % 256 for i in range(n))

    monkeypatch.setattr(mod.os, "urandom", urandom)


def test_trace_context_equals_jax(monkeypatch):
    out = {}
    for name, mod in (("port", tracectx), ("jax", jax_tracectx)):
        _seeded_urandom(monkeypatch, mod)
        root = mod.make_trace()
        hop = mod.child(root)
        out[name] = (root, hop, mod.coerce_trace(hop),
                     mod.coerce_trace({"trace_id": "x" * 99}),
                     mod.coerce_trace({"trace_id": "ab" * 16,
                                       "span_id": "cd" * 8}))
    assert out["port"] == out["jax"]
    root, hop = out["port"][:2]
    assert len(root["trace_id"]) == 32 and hop["trace_id"] == root[
        "trace_id"]
    assert hop["parent_span_id"] == root["span_id"]


@pytest.mark.parametrize("stamps", [
    {"batch_seq": 3, "created_ns": 1_000_000, "decode_ms": 4.5,
     "queue_wait_ms": 1.25, "sent_ns": 3_000_000},
    {"batch_seq": "x", "created_ns": "bad", "decode_ms": float("nan")},
    {"batch_seq": 1, "created_ns": 9_000_000, "sent_ns": 9_500_000},
    None,
])
def test_wire_lineage_equals_jax(stamps):
    out = {}
    for name, (lin, reg_mod) in {"port": (lineage, registry),
                                 "jax": (jax_lineage, jax_registry)}.items():
        reg = reg_mod.MetricsRegistry()
        observed = lin.observe_wire_lineage(reg, stamps, 5_000_000)
        out[name] = (observed, reg.snapshot())
    assert out["port"] == out["jax"]


def test_local_lineage_equals_jax(monkeypatch):
    out = {}
    for name, (lin, reg_mod) in {"port": (lineage, registry),
                                 "jax": (jax_lineage, jax_registry)}.items():
        monkeypatch.setattr(lin.time, "monotonic_ns", lambda: 7_000_000)
        monkeypatch.setattr(lin.time, "time_ns", lambda: 8_000_000)
        reg = reg_mod.MetricsRegistry()
        stamp = lin.make_lineage(2, 3.5)
        out[name] = (stamp, lin.observe_local_lineage(reg, stamp),
                     reg.snapshot())
    assert out["port"] == out["jax"]


def test_slo_parse_and_tracker_equal_jax():
    def run(mod, reg_mod):
        parsed = mod.parse_slos("stall_pct<=10@10, unprobed<=1, b<=2")
        reg = reg_mod.MetricsRegistry()
        values = {"stall_pct": 0.0}
        tracker = mod.SLOTracker(
            probes={"stall_pct": lambda: values["stall_pct"],
                    "b": lambda: 1 / 0},
            slos=parsed, registry=reg)
        for i in range(25):
            if i == 10:
                values["stall_pct"] = 50.0
            if i == 20:
                values["stall_pct"] = float("nan")
            tracker.tick(now=1000.0 + i)
        return ([(s.name, s.threshold, s.budget_pct) for s in parsed],
                [s.name for s in tracker.slos], reg.snapshot(),
                tracker.status(),
                [(s.name, s.threshold) for s in mod.DEFAULT_SLOS],
                [(s.name, s.threshold) for s in mod.scoped_slos(
                    "tenant", mod.DEFAULT_SLOS)])

    port, jax = run(slo, jax_registry), run(jax_slo, jax_registry)
    port_own = run(slo, registry)
    assert port == jax == port_own
    assert port[3]["stall_pct"]["burn"]["1m"] == pytest.approx(5.0)
    for spec in ("stall_pct=25", "a<=1@0"):
        with pytest.raises(ValueError) as a:
            slo.parse_slos(spec)
        with pytest.raises(ValueError) as b:
            jax_slo.parse_slos(spec)
        assert str(a.value) == str(b.value)


def _registry_with_traffic(reg_mod):
    reg = reg_mod.MetricsRegistry()
    reg.counter("svc_batches_sent").inc(3)
    reg.gauge("svc_queue_depth").set(2)
    for v in (0.5, 4.0, 40.0):
        reg.histogram("lineage_batch_age_ms").observe(v)
    return reg


def _scrape(mod, reg_mod, healthz_fn):
    server = mod.MetricsHTTPServer(_registry_with_traffic(reg_mod), port=0,
                                   healthz_fn=healthz_fn).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        try:
            health = urllib.request.urlopen(base + "/healthz")
            code, body = health.status, json.loads(health.read())
        except urllib.error.HTTPError as exc:
            code, body = exc.code, json.loads(exc.read())
        missing = urllib.request.Request(base + "/nope")
        try:
            urllib.request.urlopen(missing)
            missing_code = 200
        except urllib.error.HTTPError as exc:
            missing_code = exc.code
        return text, code, body, missing_code
    finally:
        server.stop()


@pytest.mark.parametrize("healthz", ["ok", "degraded", "raises"])
def test_exporter_serves_as_jax(healthz):
    def fn():
        if healthz == "raises":
            raise RuntimeError("probe broken")
        return {"role": "trainer", "status": healthz}

    port = _scrape(http, registry, fn)
    jax = _scrape(jax_http, jax_registry, fn)
    assert port == jax
    assert "lineage_batch_age_ms_bucket" in port[0]
    assert port[1] == (200 if healthz == "ok" else 503)
    assert port[3] == 404


def test_service_counters_observe_as_jax():
    out = {}
    for name, (mod, reg_mod) in {"port": (metrics, registry),
                                 "jax": (jax_metrics, jax_registry)}.items():
        reg = reg_mod.MetricsRegistry()
        a = mod.ServiceCounters(registry=reg)
        b = mod.ServiceCounters(registry=reg)
        for v in (1.0, 2.0, 30.0):
            a.observe("decode_ms", v)
        b.observe("decode_ms", 500.0)
        out[name] = (a.percentiles("decode_ms"), b.percentiles("decode_ms"),
                     a.percentiles("never"), reg.snapshot())
    assert out["port"] == out["jax"]


# -- the JSONL tools ---------------------------------------------------------


def _chain_events(trace_id="a" * 32, step=0, pid_a=100, pid_b=200):
    """Two processes with skewed clocks and one batch chain across them
    (decode and send on the server, receive and step on the trainer)."""
    wall_a, wall_b = 1_000_000_000_000, 1_000_000_000_777
    span_srv, span_cli = "b" * 16, "c" * 16
    return [
        {"name": critpath.CLOCK_SYNC_NAME, "ph": "M", "pid": pid_a,
         "tid": 0, "ts": 0, "args": {"wall_ns": wall_a * 1000,
                                     "mono_ns": 0}},
        {"name": critpath.CLOCK_SYNC_NAME, "ph": "M", "pid": pid_b,
         "tid": 0, "ts": 0, "args": {"wall_ns": wall_b * 1000,
                                     "mono_ns": 0}},
        {"name": "svc.decode", "ph": "X", "pid": pid_a, "tid": 1,
         "ts": 0, "dur": 400, "args": {"trace_id": trace_id,
                                       "trace_span": span_srv,
                                       "step": step, "item": "sha256:itm"}},
        {"name": "svc.send", "ph": "X", "pid": pid_a, "tid": 1, "ts": 500,
         "dur": 100, "args": {"trace_id": trace_id, "trace_span": span_srv,
                              "step": step}},
        {"name": "client.decode", "ph": "X", "pid": pid_b, "tid": 2,
         "ts": 0, "dur": 200, "args": {"trace_id": trace_id,
                                       "trace_parent": span_srv,
                                       "trace_span": span_cli,
                                       "step": step}},
        {"name": "train.step", "ph": "X", "pid": pid_b, "tid": 2,
         "ts": 250, "dur": 300, "args": {"step": step}},
    ]


@pytest.fixture()
def span_files(tmp_path):
    spans_path = tmp_path / "spans.jsonl"
    with open(spans_path, "w") as f:
        for step in range(3):
            for ev in _chain_events(trace_id=f"{step:032x}", step=step):
                f.write(json.dumps(ev) + "\n")
        f.write("not json\n")
    costs_path = tmp_path / "costs.jsonl"
    with open(costs_path, "w") as f:
        for key, ms in (("sha256:itm", 0.4), ("sha256:itm", 0.9),
                        ("sha256:two", 0.1)):
            f.write(json.dumps({"key": key, "decode_ms": ms, "bytes": 64})
                    + "\n")
    return str(spans_path), str(costs_path), tmp_path


def test_critpath_analysis_equals_jax(span_files):
    events = [json.loads(line) for line in open(span_files[0])
              if line.startswith("{")]
    assert critpath.analyze(events) == jax_critpath.analyze(events)
    assert critpath.rebase_events(events) == jax_critpath.rebase_events(
        events)
    assert critpath.flow_events(events) == jax_critpath.flow_events(events)
    assert len(critpath.analyze(events)) == 3


def _cli_text(fn, argv):
    buf = io.StringIO()
    rc = fn(argv, out=buf)
    return rc, buf.getvalue()


def test_trace_critical_path_prints_as_jax(span_files):
    spans_path, costs_path, _ = span_files
    argv = ["critical-path", "--spans", spans_path, "--costs", costs_path,
            "--top", "2"]
    port = _cli_text(spans.trace_main, argv)
    assert port == _cli_text(jax_spans.trace_main, argv)
    assert port[0] == 0 and "3 batch chains" in port[1]
    assert "cost[sha256:itm]" in port[1]


def test_trace_export_writes_the_jax_trace(span_files):
    spans_path, _, tmp = span_files
    outs = {}
    for name, mod in (("port", spans), ("jax", jax_spans)):
        path = tmp / f"{name}.json"
        rc, text = _cli_text(mod.trace_main, [
            "export", "--spans", spans_path, "--spans",
            str(tmp / "missing.jsonl"), "--out", str(path)])
        outs[name] = (rc, text.replace(str(path), "OUT"),
                      json.loads(path.read_text()))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0
    assert "missing span file(s)" in outs["port"][1]


def test_port_spans_export_through_both_packages(tmp_path):
    path = tmp_path / "spans.jsonl"
    tracer = spans.SpanTracer(jsonl_path=str(path))
    with tracer.span("svc.decode", step=0):
        with tracer.span("svc.send", step=0):
            pass
    tracer.close()
    for mod in (spans, jax_spans):
        out = tmp_path / f"{mod.__name__}.json"
        rc, _ = _cli_text(mod.trace_main, ["export", "--spans", str(path),
                                           "--out", str(out)])
        assert rc == 0
        names = {e["name"] for e in json.loads(out.read_text())[
            "traceEvents"]}
        assert {"svc.decode", "svc.send"} <= names


def test_costs_report_prints_as_jax(span_files):
    _, costs_path, tmp = span_files
    for argv in (["report", "--costs", costs_path, "--top", "1"],
                 ["report", "--costs", str(tmp / "none.jsonl")], []):
        port = _cli_text(costs.costs_main, argv)
        assert port == _cli_text(jax_costs.costs_main, argv)
    assert _cli_text(costs.costs_main, ["report", "--costs",
                                        costs_path])[0] == 0


def test_cli_dispatches_trace_and_costs(span_files, capsys):
    spans_path, costs_path, _ = span_files
    assert cli.main(["trace", "critical-path", "--spans", spans_path]) == 0
    assert "batch chains" in capsys.readouterr().out
    assert cli.main(["costs", "report", "--costs", costs_path]) == 0
    assert "2 items, 3 observations" in capsys.readouterr().out


def test_trace_and_lineage_cross_the_port_wire(image_dataset):
    svc = serve("port", image_dataset.uri)
    try:
        loader = remote_loader("port", f"127.0.0.1:{svc.port}")
        for _ in loader:
            pass
    finally:
        svc.stop()
    hop = loader.last_trace
    assert tracectx.coerce_trace(hop) == hop and hop["parent_span_id"]
    stamps = loader.last_lineage
    assert stamps["batch_seq"] == len(loader) - 1
    assert stamps["batch_age_ms"] >= 0 and stamps["wire_ms"] >= 0
