"""One process a card, for a cell on more than one card.

``launch`` starts ``world`` rank processes together by the ``spawn`` method,
each with one torch thread.  They meet over a ``file://`` store in a
temporary directory and form a default process group under the backend
asked for (``'nccl'`` in a benchmark run, one card a rank, ``cuda:<rank>``;
``'gloo'`` on the CPU in the tests), and a ``gloo`` group beside it for the
harness's own messages between phases (``Ranks``), which never touch a card.
Each rank then runs the job it was given; rank 0's return value comes back
to the caller.

A rank's standard output goes to standard error: only the caller prints a
result.  A rank that raises writes its traceback and exits at once; a rank
that dies, or ranks that outlive ``limit_s``, make ``launch`` kill every
rank, wait for each, and raise ``RankFailure`` with every traceback.  A rank
also dies with the process that launched it (``PR_SET_PDEATHSIG``), so none
outlives a caller that is killed.
"""
from __future__ import annotations

import ctypes
import datetime
import json
import multiprocessing as mp
import os
import signal
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from pathlib import Path
from typing import Any, Callable, List, Optional

__all__ = ["Ranks", "RankFailure", "launch", "COLLECTIVE_TIMEOUT_S"]

COLLECTIVE_TIMEOUT_S = 240.0     # any one collective of the program or the harness
_PR_SET_PDEATHSIG = 1


class RankFailure(RuntimeError):
    pass


class Ranks:
    """A rank's view of the others, for the harness's messages between
    phases: host objects over the ``gloo`` group, never a card's tensor."""

    def __init__(self, rank: int, world: int, group):
        self.rank, self.world, self.group = rank, world, group

    @property
    def lead(self) -> bool:
        """Rank 0: it times the requests, traces, judges and reports."""
        return self.rank == 0

    def broadcast(self, value: Any) -> Any:
        """Rank 0's ``value`` on every rank."""
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def gather(self, value: Any) -> Optional[List[Any]]:
        """Every rank's ``value``, by rank, on rank 0; None elsewhere."""
        import torch.distributed as dist
        out = [None] * self.world if self.lead else None
        dist.gather_object(value, out, dst=0, group=self.group)
        return out


def _die_with_parent() -> None:
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _rank_main(rank: int, world: int, parent: int, init: str, backend: str, out_dir: str,
               job: Callable, args: tuple) -> None:
    """One rank: the default group and the host group, then
    ``job(ranks, *args)``; rank 0's return value is written to
    ``out_dir/result.json``, a failure's traceback to ``rank<r>.err``."""
    os.dup2(2, 1)                 # nothing of a rank reaches the caller's stdout
    _die_with_parent()
    if os.getppid() != parent:
        os._exit(1)
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=timeout)
        host = dist.new_group(backend="gloo", timeout=timeout)
        out = job(Ranks(rank, world, host), *args)
        if rank == 0:
            tmp = Path(out_dir, "result.tmp")
            tmp.write_text(json.dumps(out))
            os.replace(tmp, Path(out_dir, "result.json"))
        dist.barrier(group=host)
        dist.destroy_process_group()
    except BaseException:
        text = traceback.format_exc()
        Path(out_dir, f"rank{rank}.err").write_text(text)
        sys.stderr.write(f"rank {rank} failed:\n{text}")
        sys.stderr.flush()
        os._exit(1)               # no teardown: peers may be blocked in a collective


def launch(world: int, job: Callable, args: tuple, backend: str, limit_s: float,
           log: Callable[[str], None]) -> Any:
    """Run ``job(ranks, *args)`` in ``world`` rank processes and return what
    rank 0's returned (a JSON value).  ``job`` and ``args`` are pickled: a
    module-level function and plain data.  Raises ``RankFailure`` when a
    rank exits non-zero or without a result, or when the ranks have not all
    ended within ``limit_s``; every rank is then killed and waited for."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
        init = Path(tmp, "store").as_uri()
        procs = [ctx.Process(target=_rank_main, name=f"portbench-rank{r}",
                             args=(r, world, os.getpid(), init, backend, tmp, job, args))
                 for r in range(world)]
        t0 = time.monotonic()
        try:
            for p in procs:
                p.start()
            deadline = t0 + limit_s
            while any(p.exitcode is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    raise RankFailure(_failures(tmp, procs, bad, "failed"))
                left = deadline - time.monotonic()
                if left <= 0:
                    late = [r for r, p in enumerate(procs) if p.exitcode is None]
                    raise RankFailure(_failures(tmp, procs, late,
                                                f"had not ended after {limit_s:.0f} s"))
                wait([p.sentinel for p in procs if p.exitcode is None], min(left, 1.0))
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RankFailure(_failures(tmp, procs, bad, "failed"))
            path = Path(tmp, "result.json")
            if not path.exists():
                raise RankFailure("rank 0 ended without a result")
            log(f"ranks: {world} under {backend}, ended in {time.monotonic() - t0:.3f} s")
            return json.loads(path.read_text())
        finally:
            started = [p for p in procs if p.pid is not None]
            for p in started:
                if p.exitcode is None:
                    p.kill()
            for p in started:
                p.join(30)


def _failures(tmp: str, procs: List, ranks: List[int], what: str) -> str:
    """The failed or late ranks with their exit codes and tracebacks."""
    out = []
    for r in ranks:
        err = Path(tmp, f"rank{r}.err")
        out.append(f"rank {r} of {len(procs)} {what} (exit code {procs[r].exitcode})"
                   + (":\n" + err.read_text() if err.exists() else ""))
    return "\n".join(out)
