"""Start a group of rank processes on this host, as torchrun does.

``run_ranks`` gives each process the environment that
``python -m torch.distributed.run`` gives its workers (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port) and waits for all of them.  Unlike
torchrun it can put several ranks on one card (``local_ranks=[0, 0]``), which
the checks of the gloo path on a single card need.  When one rank fails or
the time runs out, the others are killed rather than left waiting in a
collective.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv, world: int, local_ranks=None, env=None, timeout: float = 600.0,
              cwd=None) -> list:
    """Run ``python *argv`` as ranks 0 .. world-1 and return each one's
    output (stdout and stderr together); raise with the outputs when a rank
    exits non-zero or ``timeout`` seconds pass."""
    local_ranks = list(range(world)) if local_ranks is None else list(local_ranks)
    if len(local_ranks) != world:
        raise ValueError(f"{len(local_ranks)} local ranks for a world of {world}")
    port = free_port()
    base = dict(os.environ if env is None else env)
    procs, logs = [], []
    for r in range(world):
        e = dict(base, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(local_ranks[r]),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        log = tempfile.TemporaryFile(mode="w+")
        procs.append(subprocess.Popen([sys.executable, *argv], env=e, cwd=cwd, stdout=log,
                                      stderr=subprocess.STDOUT, text=True))
        logs.append(log)
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad \
                    else f"timed out after {timeout:.0f} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed:
        text = "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs))
        raise RuntimeError(f"{' '.join(argv)}: {failed}\n{text}")
    return outs
