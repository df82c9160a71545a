"""Run a script in N processes of one gloo group on the CPU, for the port's
tests of layouts beyond data parallelism.

The script receives ``sys.argv[1:] = [rank, world, address, *args]`` and
starts with :data:`PRELUDE`, which bounds torch to one intra-op thread,
then :data:`INIT`, which joins the group through the port's own rendezvous
(``parallel/mesh.maybe_initialize_distributed``).
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = textwrap.dedent(r'''
    import sys
    import torch
    torch.set_num_threads(1)
    from lance_distributed_training_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed, shutdown_distributed)
    RANK, WORLD, ADDRESS = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ARGS = sys.argv[4:]
''')


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


INIT = textwrap.dedent(r'''
    maybe_initialize_distributed(ADDRESS, WORLD, RANK, torch.device("cpu"))
''')


def run_gloo(body: str, world: int, *args, timeout: float = 300.0,
             init: bool = True) -> list:
    """Run ``PRELUDE`` (then, with ``init``, the group's rendezvous) and
    ``body`` as ``world`` ranks; each rank's output text. Raises with the
    failing rank's output when one exits non-zero."""
    return start_gloo(body, world, *args, init=init).wait(timeout)


class start_gloo:
    """:func:`run_gloo` started: the ranks run while the caller works;
    :meth:`wait` collects them."""

    def __init__(self, body: str, world: int, *args, init: bool = True):
        self.procs = _spawn(body, world, args, init)

    def wait(self, timeout: float = 300.0) -> list:
        return _collect(self.procs, timeout)


def _spawn(body: str, world: int, args, init: bool) -> list:
    address = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    script = (PRELUDE + (INIT if init else "") + textwrap.dedent(body)
              + "\nshutdown_distributed()\n")
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(world), address,
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]


def _collect(procs: list, timeout: float) -> list:
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode:
            raise AssertionError(f"rank {rank} exited {proc.returncode}:\n"
                                 f"{out[-6000:]}")
    return outs


def run_cli(world: int, argv: list, timeout: float = 300.0) -> list:
    """``cli.main(argv)`` in ``world`` ranks of one gloo group (the CLI's
    own rendezvous flags); each rank's result dict without the objects."""
    import json

    body = r'''
    import json
    from lance_distributed_training_tpu_torch import cli
    argv = json.loads(ARGS[0])
    if WORLD > 1:
        argv += ["--coordinator_address", ADDRESS, "--num_processes",
                 str(WORLD), "--process_id", str(RANK)]
    result = cli.main(argv)
    result = {k: v for k, v in result.items()
              if k not in ("model", "optimizer", "history", "cache_stats")}
    print("RESULT " + json.dumps(result, default=str), flush=True)
    '''
    outs = run_gloo(body, world, json.dumps(argv), timeout=timeout,
                    init=False)
    results = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    return results
