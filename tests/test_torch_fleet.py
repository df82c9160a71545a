"""The port's fleet (``fleet/coordinator.py``, ``fleet/agent.py``,
``fleet/balancer.py``, ``fleet/chaos.py``) against the JAX package's.

A coordinator and two member servers run in this process on 127.0.0.1.
The striped stream of a ``FleetLoader`` equals the port's local pipeline
bit for bit for pixel, coefficient and ragged batches: the port's loader
over the port's fleet, over a JAX fleet, and a JAX loader over the port's
fleet. A member killed after exactly three sent batches
(``ChaosController.kill_after``) leaves the stream bit-identical. The
``fleet`` subcommand prints the same text and exits with the same code in
both packages on one coordinator's state. Membership changes are awaited
on events the coordinator's own methods set, never on a wall-clock
deadline; heartbeats and lease TTLs are a fraction of a second.
"""

import io
import json
import re
import socket
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest

from lance_distributed_training_tpu import cli as jax_cli
from lance_distributed_training_tpu import fleet as jax_fleet
from lance_distributed_training_tpu.fleet import chaos as jax_chaos
from lance_distributed_training_tpu_torch import cli, fleet
from lance_distributed_training_tpu_torch.data.buffers import BufferPool
from lance_distributed_training_tpu_torch.fleet import chaos
from test_torch_service import (  # noqa: F401 (the fixtures)
    BATCH,
    CASES,
    client_knobs,
    dataset_for,
    digests,
    local_batches,
    _private_jax_decoder,
    jax_native,
    serve,
    token_dataset,
)
from test_torch_threads import _one_torch_thread  # noqa: F401

FLEETS = {"port": fleet, "jax": jax_fleet}
CHAOS = {"port": chaos, "jax": jax_chaos}
CLIS = {"port": cli, "jax": jax_cli}


def watch(obj, method, predicate) -> threading.Event:
    """An event set once ``predicate()`` holds after a call of
    ``obj.method`` (checked at once too): tests wait on what the
    coordinator does, not on the clock."""
    event = threading.Event()
    original = getattr(obj, method)

    def spy(*args, **kwargs):
        out = original(*args, **kwargs)
        if predicate():
            event.set()
        return out

    setattr(obj, method, spy)
    if predicate():
        event.set()
    return event


def start_coordinator(pkg, **kw):
    kw.setdefault("heartbeat_interval_s", 0.05)
    kw.setdefault("lease_ttl_s", 0.4)
    return FLEETS[pkg].Coordinator(FLEETS[pkg].CoordinatorConfig(
        host="127.0.0.1", port=0, **kw)).start()


def start_member(pkg, uri, coord, case="pixels", **kw):
    svc = serve(pkg, uri, case, coordinator_addr=f"127.0.0.1:{coord.port}",
                **kw)
    assert svc.fleet_agent.registered.wait(30), "registration timed out"
    return svc


class Fleet:
    """A coordinator and ``n`` members of package ``pkg``."""

    def __init__(self, pkg, uri, case="pixels", n=2):
        self.pkg = pkg
        self.coord = start_coordinator(pkg)
        self.members = []
        try:
            for _ in range(n):
                self.members.append(start_member(pkg, uri, self.coord, case))
        except BaseException:
            self.stop()
            raise
        self.addr = f"127.0.0.1:{self.coord.port}"

    def stop(self):
        for m in self.members:
            m.stop()
        self.coord.stop()


def fleet_loader(pkg, addr, case="pixels", **kw):
    kw.setdefault("connect_retries", 2)
    kw.setdefault("resolve_retries", 3)
    kw.setdefault("backoff_s", 0.05)
    return FLEETS[pkg].FleetLoader(addr, BATCH, 0, 1, **client_knobs(case),
                                   **kw)


def host_copies(loader):
    """The stream as numpy copies, each batch's pool pages returned."""
    out = []
    for batch in loader:
        out.append({k: np.array(v, copy=True) for k, v in batch.items()})
        if loader.buffer_pool is not None:
            loader.buffer_pool.release_batch(batch)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("loader_pkg,fleet_pkg",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_fleet_loader_streams_the_local_batches(
        loader_pkg, fleet_pkg, case, image_dataset, token_dataset):
    uri = dataset_for(case, image_dataset, token_dataset).uri
    f = Fleet(fleet_pkg, uri, case)
    try:
        loader = fleet_loader(loader_pkg, f.addr, case)
        got = host_copies(loader)
        assert loader.counters.snapshot()["fleet_stripes"] == 2
    finally:
        f.stop()
    assert digests(got) == digests(local_batches(uri, case))


@pytest.mark.parametrize("loader_pkg,fleet_pkg",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_kill_mid_epoch_stream_bit_identical(loader_pkg, fleet_pkg,
                                             image_dataset):
    """A member killed after exactly 3 sent batches: the survivor serves
    the tail from the cursor and the stream has no gap, no duplicate and
    no changed bit."""
    f = Fleet(fleet_pkg, image_dataset.uri)
    try:
        killer = CHAOS[fleet_pkg].ChaosController(f.members[0]).kill_after(3)
        pool = BufferPool() if loader_pkg == "port" else None
        loader = fleet_loader(loader_pkg, f.addr, buffer_pool=pool)
        got = host_copies(loader)
        assert killer.killed.is_set()
        snap = loader.counters.snapshot()
    finally:
        f.stop()
    assert digests(got) == digests(local_batches(image_dataset.uri))
    assert snap["fleet_failovers_total"] >= 1
    if pool is not None:
        assert pool.stats()["outstanding"] == 0


def test_kill_before_the_first_batch_restripes_from_zero(image_dataset):
    f = Fleet("port", image_dataset.uri)
    try:
        killer = chaos.ChaosController(f.members[1]).kill_after(0)
        got = host_copies(fleet_loader("port", f.addr))
        assert killer.killed.is_set()
    finally:
        f.stop()
    assert digests(got) == digests(local_batches(image_dataset.uri))


def test_stall_is_not_failover(image_dataset):
    f = Fleet("port", image_dataset.uri)
    try:
        staller = chaos.ChaosController(f.members[0]).stall_after(2, 0.2)
        loader = fleet_loader("port", f.addr)
        got = host_copies(loader)
        assert staller.wait_stalled(0)
    finally:
        f.stop()
    assert digests(got) == digests(local_batches(image_dataset.uri))
    assert loader.counters.snapshot().get("fleet_failovers_total", 0) == 0


def test_two_shards_stripe_disjointly(image_dataset):
    f = Fleet("port", image_dataset.uri)
    try:
        streams = [digests(fleet.FleetLoader(
            f.addr, BATCH // 2, rank, 2, connect_retries=2,
            resolve_retries=3, backoff_s=0.05)) for rank in range(2)]
    finally:
        f.stop()
    for rank in range(2):
        assert streams[rank] == digests(local_batches(
            image_dataset.uri, process_index=rank, process_count=2))


def settled_generation(coord, count: int) -> int:
    """The coordinator's generation read under its lock at a moment its
    table holds ``count`` members, awaiting the rebalance that makes it
    so. Under load a member's heartbeats can miss one lease TTL, and the
    member then expires and re-registers, two membership changes of their
    own; a generation read while the table lacks it names the wrong
    table."""
    while True:
        held = watch(coord, "_rebalance_locked",
                     lambda: len(coord._members) == count)
        assert held.wait(30)
        with coord._lock:
            if len(coord._members) == count:
                return coord.generation


def test_heartbeat_expiry_reassigns_the_lease(image_dataset):
    coord = start_coordinator("port")
    members = [start_member("port", image_dataset.uri, coord)
               for _ in range(2)]
    try:
        kept = members[1].fleet_agent.server_id
        gen = settled_generation(coord, 2)
        # The change the partition makes: the lost member gone and the
        # other one in, at a later generation (not a table of one that a
        # missed heartbeat of either made before or after).
        one = watch(coord, "_rebalance_locked",
                    lambda: coord.generation > gen
                    and set(coord._members) == {kept})
        chaos.ChaosController(members[0]).partition()  # heartbeats stop
        assert one.wait(30)
        health = coord._healthz()
        assert health["stripe_count"] == 1 and coord.generation > gen
        survivor = health["members"][0]
        assert survivor["server_id"] == members[1].fleet_agent.server_id
        assert (survivor["fragment_lo"], survivor["fragment_hi"]) == (
            0, len(image_dataset.fragment_rows()))
        two = watch(coord, "_rebalance_locked",
                    lambda: len(coord._members) == 2)
        chaos.ChaosController(members[0]).heal()  # re-registers
        assert two.wait(30)
    finally:
        for m in members:
            m.stop()
        coord.stop()


def test_graceful_stop_deregisters_at_once(image_dataset):
    coord = start_coordinator("port", lease_ttl_s=60.0)
    members = [start_member("port", image_dataset.uri, coord)
               for _ in range(2)]
    try:
        health = coord._healthz()
        assert sorted(m["stripe_index"] for m in health["members"]) == [0, 1]
        lo_hi = sorted((m["fragment_lo"], m["fragment_hi"])
                       for m in health["members"])
        assert lo_hi[0][0] == 0 and lo_hi[0][1] == lo_hi[1][0]
        one = watch(coord, "_rebalance_locked",
                    lambda: len(coord._members) == 1)
        members[0].stop()  # a 60 s TTL: only the DEREGISTER explains it
        assert one.wait(30)
    finally:
        for m in members:
            m.stop()
        coord.stop()


def test_coordinator_metrics_and_healthz(image_dataset):
    import urllib.request

    coord = start_coordinator("port", metrics_port=0)
    svc = start_member("port", image_dataset.uri, coord)
    try:
        base = f"http://127.0.0.1:{coord.metrics_port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
    finally:
        svc.stop()
        coord.stop()
    for series in ("fleet_members", "fleet_lease_generation",
                   "fleet_registrations_total", "fleet_rebalance_ms_bucket"):
        assert series in text
    assert health["status"] == "ok" and health["stripe_count"] == 1


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_empty_and_unreachable_fleets_raise_as_jax_raises():
    messages = {}
    for pkg in FLEETS:
        coord = start_coordinator(pkg)
        try:
            with pytest.raises(ConnectionError) as info:
                len(fleet_loader(pkg, f"127.0.0.1:{coord.port}",
                                 resolve_retries=2, backoff_s=0.01))
            messages[pkg, "empty"] = re.sub(r":\d+", ":PORT",
                                            str(info.value))
        finally:
            coord.stop()
        with pytest.raises(ConnectionError) as info:
            len(fleet_loader(pkg, f"127.0.0.1:{_closed_port()}",
                             connect_retries=1, resolve_retries=2,
                             backoff_s=0.01))
        messages[pkg, "unreachable"] = re.sub(r":\d+", ":PORT",
                                              str(info.value))
    assert messages["port", "empty"] == messages["jax", "empty"]
    assert "membership" in messages["port", "empty"]
    assert messages["port", "unreachable"] == messages["jax", "unreachable"]


# -- `fleet recommend` on one coordinator's state ----------------------------


def _seed_state(coord, stall_pct):
    for i, sid in enumerate(("m1", "m2")):
        coord._handle_register({"server_id": sid, "addr": f"h:{i + 1}",
                                "num_fragments": 6})
        coord._handle_heartbeat({"server_id": sid, "pressure": {
            "stall_pct": stall_pct + i, "active_clients": 1}})
    coord.jobs.declare("tenant-a", "training")
    coord.jobs.observe_member("m1", {"tenant-a": {
        "priority": "training", "sessions": 1, "cursor": 4,
        "batches_sent": 5.0, "cache_hit": 1.0, "cache_miss": 3.0}})


def _run(pkg, main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = getattr(CLIS[pkg], main)(argv)
    # Heartbeat ages move between the two calls.
    return rc, re.sub(r"heartbeat \S+s ago", "heartbeat Ts ago",
                      out.getvalue())


@pytest.mark.parametrize("stall_pct,rc", [(60.0, 3), (1.0, 0)])
@pytest.mark.parametrize("coord_pkg", sorted(FLEETS))
def test_fleet_cli_prints_and_exits_as_jax(coord_pkg, stall_pct, rc):
    coord = start_coordinator(coord_pkg, lease_ttl_s=60.0,
                              heartbeat_interval_s=30.0)
    try:
        _seed_state(coord, stall_pct)
        argv = ["recommend", "--coordinator", f"127.0.0.1:{coord.port}"]
        port, jax = _run("port", "fleet_main", argv), _run(
            "jax", "fleet_main", argv)
        assert port == jax and port[0] == rc
        assert "tenant-a [training]" in port[1]
        port_json = _run("port", "fleet_main", argv + ["--json"])
        assert port_json[0] == rc
        assert {m["server_id"] for m in
                json.loads(port_json[1])["members"]} == {"m1", "m2"}
    finally:
        coord.stop()
