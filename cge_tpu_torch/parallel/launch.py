"""Start the ranks of a one-host world as processes.

`run_ranks` runs `world` copies of a command, rank r with the variables
that torch.distributed's env:// rendezvous reads (RANK, WORLD_SIZE,
MASTER_ADDR = 127.0.0.1, MASTER_PORT = a free port), so each rank calls
`init_distributed(backend, init_method="env://")`. LOCAL_RANK is not set:
a rank picks its card itself (several ranks may share one). Each rank's
output goes to a file, so a full pipe cannot stall it; the ranks are
killed when the timeout expires, and a rank that fails fails the run.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: list, world: int, timeout: float, env: dict | None = None,
              cwd: str | None = None) -> list:
    """Run argv as ranks 0..world-1 and return each rank's output (stdout
    and stderr). Raises RuntimeError, with the output of every rank, when
    a rank exits non-zero or the timeout (seconds, for the whole world)
    expires; every rank is dead when this returns or raises."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world))
    base.pop("LOCAL_RANK", None)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(argv, env={**base, "RANK": str(r)},
                                  cwd=cwd, stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        expired = False
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            expired = True
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if expired or failed:
        why = (f"timed out after {timeout:.0f} s" if expired
               else f"rank(s) {failed} failed")
        text = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{o[-4000:]}"
                         for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{world}-rank run {why}:\n{text}")
    return outs
