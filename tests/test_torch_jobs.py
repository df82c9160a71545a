"""The port's job plane (``fleet/jobs.py``) against the JAX package's.

The decision cores run the same scripts in both packages and give the
same grants, refusals (with the same messages), per-job stats and
registry rows: the fair stride scheduler, the admission gates, the
cursors and the cache accounting of ``JobPlane``, and the coordinator's
``JobRegistry``. On the wire a port server admits and refuses a tenant's
HELLO as a JAX server does; two jobs stream through the port's fleet
while a member dies and both streams stay bit-identical; the job cursors
reach the coordinator's registry (awaited on an event the registry's own
update sets). The ``jobs`` subcommand prints the same text and exits with
the same codes (4 = unknown job) in both packages on one coordinator.
"""

import socket
import threading

import pytest

from lance_distributed_training_tpu.fleet import jobs as jax_jobs
from lance_distributed_training_tpu.obs.registry import (
    MetricsRegistry as JaxRegistry,
)
from lance_distributed_training_tpu.service import protocol as jax_protocol
from lance_distributed_training_tpu.utils import metrics as jax_metrics
from lance_distributed_training_tpu_torch import fleet
from lance_distributed_training_tpu_torch.fleet import chaos, jobs
from lance_distributed_training_tpu_torch.obs.registry import MetricsRegistry
from lance_distributed_training_tpu_torch.service import protocol as P
from lance_distributed_training_tpu_torch.utils import metrics
from test_torch_fleet import (
    Fleet,
    _run,
    fleet_loader,
    host_copies,
    start_coordinator,
    watch,
)
from test_torch_service import (  # noqa: F401 (the fixtures)
    BATCH,
    _private_jax_decoder,
    digests,
    jax_native,
    local_batches,
    serve,
)
from test_torch_threads import _one_torch_thread  # noqa: F401

SIDES = {
    "port": (jobs, MetricsRegistry, metrics.ServiceCounters, P),
    "jax": (jax_jobs, JaxRegistry, jax_metrics.ServiceCounters,
            jax_protocol),
}
STEPS = 240 // BATCH


def both(script):
    """``script`` run on each package's modules; the two results."""
    return {name: script(*mods) for name, mods in SIDES.items()}


def _grants(sched, jobs_, rounds):
    out = []
    for _ in range(rounds):
        job = sched.pick(jobs_)
        out.append(job)
        sched.advance(job)
    return out


def test_fair_scheduler_grants_as_jax():
    def script(m, *_):
        weighted = m.FairScheduler()
        weighted.ensure("a", "training")
        weighted.ensure("b", "bulk")
        preempt = m.FairScheduler()
        preempt.ensure("scan", "bulk")
        preempt.ensure("probe", "inference")
        for _ in range(8):
            preempt.advance("probe")
        late = m.FairScheduler()
        late.ensure("old", "training")
        for _ in range(10):
            late.advance("old")
        late.ensure("new", "training")
        return (_grants(weighted, ["a", "b"], 30),
                preempt.pick(["scan", "probe"]),
                _grants(late, ["old", "new"], 12))

    out = both(script)
    assert out["port"] == out["jax"]
    weighted, first, late = out["port"]
    assert weighted.count("a") == 20 and weighted.count("b") == 10
    assert first == "probe"
    assert late.count("old") == late.count("new") == 6


def test_begin_step_is_bounded():
    s = jobs.FairScheduler(max_wait_s=0.05)
    with s._cond:
        s._ensure_locked("phantom", "inference")
        s._waiting["phantom"] = 1  # a preempting job that never advances
    s.begin_step("mine")  # returns after max_wait_s: fairness, not liveness
    jobs.FairScheduler(max_wait_s=60.0).begin_step("solo")  # no contention


@pytest.mark.parametrize("name", ["smoke-train", "Tenant.A", "--", "a b/c"])
def test_job_slug_as_jax(name):
    assert jobs.job_slug(name) == jax_jobs.job_slug(name)


def test_slug_collisions_disambiguated_as_jax():
    def script(m, reg, *_):
        plane = m.JobPlane(registry=reg(), slo_interval_s=60.0)
        try:
            plane.admit("a-b", "training", "s1")
            plane.admit("a.b", "training", "s2")
            with plane._lock:
                return {j: st.slug for j, st in plane._jobs.items()}
        finally:
            plane.stop()

    out = both(script)
    assert out["port"]["a-b"] == out["jax"]["a-b"] == "a_b"
    assert out["port"]["a.b"].startswith("a_b_")
    assert out["jax"]["a.b"].startswith("a_b_")


def _refusal(plane, *args):
    try:
        plane.admit(*args)
    except Exception as exc:  # noqa: BLE001 — each package's own class
        return type(exc).__name__, str(exc)
    return None


def test_admission_gates_refuse_as_jax():
    def script(m, reg, counters_cls, proto):
        r = reg()
        counters = counters_cls(registry=r)
        plane = m.JobPlane(counters=counters, registry=r, max_jobs=1,
                           slo_interval_s=60.0)
        try:
            out = [_refusal(plane, "tenant-a", "training", "sess-1"),
                   _refusal(plane, "tenant-b", "training", "sess-2"),
                   _refusal(plane, "tenant-a", "training", "sess-3"),
                   _refusal(plane, "probe", "inference", "sess-4"),
                   _refusal(plane, "tenant-a", "bulk", "sess-5"),
                   _refusal(plane, "tenant-c", "urgent", "sess-6")]
            snap = counters.snapshot()
            out.append((snap["svc_admission_refusals"],
                        snap["svc_jobs_active"]))
            return out
        finally:
            plane.stop()

    out = both(script)
    assert out["port"] == out["jax"]
    assert out["port"][1][0] == "AdmissionRefused"
    assert out["port"][1][1].startswith(P.ADMISSION_REFUSED_MARKER)
    assert out["port"][-1] == (3, 2)


def test_stall_gate_refuses_as_jax():
    def script(m, reg, *_):
        stall = {"pct": 80.0}
        plane = m.JobPlane(registry=reg(), max_stall_pct=25.0,
                           stall_fn=lambda: stall["pct"],
                           slo_interval_s=60.0)
        try:
            out = [_refusal(plane, "newcomer", "training", "s1")]
            stall["pct"] = 3.0
            out.append(_refusal(plane, "newcomer", "training", "s1"))
            stall["pct"] = 99.0
            out.append(_refusal(plane, "newcomer", "training", "s2"))
            return out
        finally:
            plane.stop()

    out = both(script)
    assert out["port"] == out["jax"]
    assert "80.0% exceeds the admission ceiling 25.0%" in out["port"][0][1]
    assert out["port"][1:] == [None, None]


def test_cursors_and_cache_accounting_as_jax():
    def script(m, reg, *_):
        plane = m.JobPlane(registry=reg(), slo_interval_s=60.0)
        try:
            plane.admit("tenant-a", "training", "s1")
            plane.note_cursor("tenant-a", "c1", 5)
            plane.note_cursor("tenant-a", "c1", 3)  # stale: ignored
            plane.note_cursor("tenant-a", "c2", 7)
            for hit in (True, True, False):
                plane.note_cache("tenant-a", hit)
            plane.note_plan("tenant-a", ("plan", "key"))
            plane.note_cursor("ghost", "c1", 99)
            plane.note_cache("ghost", True)
            before = plane.stats()
            plane.release("tenant-a", "s1")
            return before, plane.stats(), plane.counters_for("ghost")
        finally:
            plane.stop()

    def strip_slo(stats):
        return {job: {k: v for k, v in row.items() if k != "slo"}
                for job, row in stats.items()}

    out = both(script)
    port, jax = out["port"], out["jax"]
    assert strip_slo(port[0]) == strip_slo(jax[0])
    assert strip_slo(port[1]) == strip_slo(jax[1])
    row = port[0]["tenant-a"]
    assert (row["cursor"], row["cache_hit"], row["cache_miss"]) == (7, 2, 1)
    assert port[1]["tenant-a"]["sessions"] == 0 and port[2] is None


def test_registry_rows_as_jax():
    def script(m, *_):
        reg = m.JobRegistry()
        reg.declare("tenant-a", "training")
        reg.declare("tenant-a")
        reg.observe_member("m1", {"tenant-a": {
            "priority": "training", "sessions": 1, "cursor": 4,
            "batches_sent": 5.0, "cache_hit": 3.0, "cache_miss": 1.0,
            "slo": {"stall_pct": {"burn": {"1m": 0.5}}}}})
        reg.observe_member("m2", {
            "tenant-a": {"priority": "training", "sessions": 2,
                         "cursor": 9, "batches_sent": 10.0,
                         "cache_hit": 1.0, "cache_miss": 3.0,
                         "slo": {"stall_pct": {"burn": {"1m": 2.0}}}},
            "tenant-b": {"priority": "bulk", "sessions": 1, "cursor": 2}})
        first = reg.payload()
        reg.drop_member("m2")
        reg.declare(None)
        reg.observe_member("m3", "garbage")
        reg.observe_member("m4", {"ok": {"cursor": "NaN"}, 3: {}, "x": []})
        return first, reg.payload()

    out = both(script)
    assert out["port"] == out["jax"]
    rows = {r["job_id"]: r for r in out["port"][0]}
    assert rows["tenant-a"]["sessions"] == 3
    assert rows["tenant-a"]["cursor"] == 9
    assert rows["tenant-a"]["cache_hit_rate"] == 0.5
    after = {r["job_id"]: r for r in out["port"][1]}
    assert after["tenant-a"]["cursor"] == 9  # survives the member's loss
    assert after["ok"]["cursor"] == -1


# -- on the wire ---------------------------------------------------------------


def _raw_hello(port, **fields):
    with socket.create_connection(("127.0.0.1", port)) as sock:
        P.send_msg(sock, P.MSG_HELLO, P.hello(
            batch_size=BATCH, process_index=0, process_count=1, **fields))
        return P.recv_msg(sock)


def test_hello_admission_as_a_jax_server_admits(image_dataset):
    replies = {}
    for pkg in ("port", "jax"):
        svc = serve(pkg, image_dataset.uri, admission_max_jobs=1)
        try:
            replies[pkg] = [
                _raw_hello(svc.port, job_id="job-a", job_priority="training"),
                _raw_hello(svc.port, job_id="job-b", job_priority="training"),
                _raw_hello(svc.port, job_id="job-a", job_priority="training"),
                _raw_hello(svc.port, job_id="probe",
                           job_priority="inference"),
                _raw_hello(svc.port, version=5),
            ]
            replies[pkg].append(sorted(svc.job_plane.stats()))
        finally:
            svc.stop()

    def kinds(rs):
        return [(t, r.get("job_id"), r.get("message")) for t, r in rs[:-1]]

    assert kinds(replies["port"]) == kinds(replies["jax"])
    # The implicit default job of the v5 peer is a second non-read-only
    # tenant: refused at capacity too.
    assert replies["port"][-1] == replies["jax"][-1] == ["job-a", "probe"]
    msg_type, reply = replies["port"][1]
    assert msg_type == P.MSG_ERROR
    assert reply["message"].startswith(P.ADMISSION_REFUSED_MARKER)
    assert replies["port"][4][0] == P.MSG_ERROR


def test_two_jobs_stream_bit_identical_through_a_kill(image_dataset):
    f = Fleet("port", image_dataset.uri)
    try:
        killer = chaos.ChaosController(f.members[0]).kill_after(3)
        results, errors = {}, []

        def run(job_id, priority):
            try:
                results[job_id] = host_copies(fleet_loader(
                    "port", f.addr, job_id=job_id, job_priority=priority))
            except Exception as exc:  # noqa: BLE001 — asserted below
                errors.append((job_id, exc))

        threads = [threading.Thread(target=run, args=args) for args in
                   (("tenant-a", "training"), ("tenant-b", "bulk"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert killer.killed.is_set()
    finally:
        f.stop()
    ref = digests(local_batches(image_dataset.uri))
    assert digests(results["tenant-a"]) == ref
    assert digests(results["tenant-b"]) == ref


def test_job_cursors_reach_the_coordinators_registry(image_dataset):
    """Each tenant's cursor is the max step its clients acked, aggregated
    from member heartbeats; awaited on the registry's own update."""
    f = Fleet("port", image_dataset.uri)
    try:
        host_copies(fleet_loader("port", f.addr, job_id="tenant-a",
                                 job_priority="training"))
        steps_b = len(host_copies(fleet.FleetLoader(
            f.addr, BATCH, 0, 2, connect_retries=2, resolve_retries=3,
            backoff_s=0.05, job_id="tenant-b", job_priority="bulk")))
        assert 0 < steps_b < STEPS

        def rows():
            return {r["job_id"]: r for r in f.coord.jobs.payload()}

        def near_end():
            r = rows()
            return ("tenant-a" in r and "tenant-b" in r
                    and r["tenant-a"]["cursor"] >= STEPS - 3
                    and r["tenant-b"]["cursor"] >= steps_b - 3)

        assert watch(f.coord.jobs, "observe_member", near_end).wait(60)
        got = rows()
        assert STEPS - 3 <= got["tenant-a"]["cursor"] <= STEPS - 1
        assert steps_b - 3 <= got["tenant-b"]["cursor"] <= steps_b - 1
        assert got["tenant-a"]["priority"] == "training"
        assert got["tenant-b"]["priority"] == "bulk"
        _, payload = f.coord._handle_resolve({})
        assert {r["job_id"] for r in payload["jobs"]} >= {"tenant-a",
                                                          "tenant-b"}
    finally:
        f.stop()


# -- `jobs list|describe` on one coordinator's state ---------------------------


@pytest.mark.parametrize("coord_pkg", ["port", "jax"])
def test_jobs_cli_prints_and_exits_as_jax(coord_pkg):
    coord = start_coordinator(coord_pkg, lease_ttl_s=60.0,
                              heartbeat_interval_s=30.0)
    try:
        addr = f"127.0.0.1:{coord.port}"
        coord.jobs.declare("tenant-a", "training")
        coord.jobs.observe_member("m1", {"tenant-a": {
            "priority": "training", "sessions": 2, "cursor": 14,
            "batches_sent": 30.0, "cache_hit": 3.0, "cache_miss": 1.0,
            "slo": {"stall_pct": {"burn": {"1m": 0.5}}}}})
        for argv in (["list", "--coordinator", addr],
                     ["list", "--coordinator", addr, "--json"],
                     ["describe", "tenant-a", "--coordinator", addr],
                     ["describe", "nobody", "--coordinator", addr]):
            assert _run("port", "jobs_main", argv) == _run(
                "jax", "jobs_main", argv)
        rc, out = _run("port", "jobs_main", ["list", "--coordinator", addr])
        assert rc == 0 and "tenant-a [training]" in out
        assert "cursor 14" in out and "cache_hit_rate 0.75" in out
        rc, out = _run("port", "jobs_main",
                       ["describe", "nobody", "--coordinator", addr])
        assert rc == 4 and "not registered" in out
        rc, _ = _run("port", "main", ["jobs", "list", "--coordinator", addr])
        assert rc == 0
    finally:
        coord.stop()
