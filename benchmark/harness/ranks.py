"""Cells of several ranks: one process a rank, one card each, joined
through the port's ``parallel/distributed.init_distributed``.

The process that ``benchmark/run.py`` starts is rank 0. For a cell whose
traffic has ``ranks: N`` it starts ranks 1 .. N-1 itself
(``python -m benchmark.harness.ranks <spec>``), each with ``LOCAL_RANK`` set
and its standard output sent to standard error, so that rank 0's result is
the only line there. Every rank runs the same run (``harness/main.py``
``run_cell``); rank 0 decides when the window ends and tells the others.

No rank may hang. Rank 0 watches its children: one that exits with another
code than 0, a group not joined within ``GROUP_LIMIT_S``, or a run past its
deadline ends every rank and rank 0 with exit code 1. A child ends itself
when rank 0 is gone. Once rank 0 is done, the children have
``JOIN_LIMIT_S`` to end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["Place", "Ranks", "agree", "gather", "GROUP_LIMIT_S", "JOIN_LIMIT_S"]

ROOT = Path(__file__).resolve().parents[2]
GROUP_LIMIT_S = 300.0
JOIN_LIMIT_S = 120.0


@dataclasses.dataclass
class Place:
    """Where a run sits among its cell's ranks; ``joined`` is set once this
    rank has joined the group."""

    rank: int = 0
    ranks: int = 1
    init_method: Optional[str] = None
    joined: Optional[threading.Event] = None


def _log(*parts):
    print("ranks:", *parts, file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Rank 0's children, ranks 1 .. ``n``-1, each running ``plan`` (a list
    of ``run_cell`` keyword sets), and the watchdog over them; none for
    ``n`` = 1. Use as a context: on leaving it, the children are waited for
    (or ended, where rank 0 raised)."""

    def __init__(self, n: int, plan: List[Dict], device: str, bench: Path, deadline_s: float):
        self.n, self.deadline_s, self.t0 = n, deadline_s, time.monotonic()
        self.init_method = f"tcp://127.0.0.1:{_free_port()}" if n > 1 else None
        self.joined, self.done = threading.Event(), threading.Event()
        self.children = []
        for r in range(1, n):
            spec = {"rank": r, "ranks": n, "init_method": self.init_method, "device": device, "bench": str(bench),
                    "plan": plan, "parent": os.getpid()}
            self.children.append(subprocess.Popen([sys.executable, "-m", "benchmark.harness.ranks", json.dumps(spec)],
                                                  cwd=ROOT, env=dict(os.environ, LOCAL_RANK=str(r)),
                                                  stdout=sys.stderr))
        if self.children:  # one rank: no child to watch and no group to join
            threading.Thread(target=self._watch, daemon=True).start()

    def place(self) -> Place:
        return Place(0, self.n, self.init_method, self.joined)

    def _watch(self):
        while not self.done.wait(0.5):
            bad = [(r, c.returncode) for r, c in enumerate(self.children, 1) if c.poll() not in (None, 0)]
            if bad:
                self._abort(f"rank {bad[0][0]} exited with code {bad[0][1]}")
            elapsed = time.monotonic() - self.t0
            if not self.joined.is_set() and elapsed > GROUP_LIMIT_S:
                self._abort(f"the group was not joined within {GROUP_LIMIT_S:.0f} s")
            if elapsed > self.deadline_s:
                self._abort(f"the run passed its deadline of {self.deadline_s:.0f} s")

    def _abort(self, why: str):
        _log(why, "- ending every rank")
        self.kill()
        os._exit(1)

    def kill(self):
        for c in self.children:
            if c.poll() is None:
                c.kill()
        for c in self.children:
            c.wait()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.done.set()
            for c in self.children:  # a child that failed first is still exiting when rank 0's collective breaks
                try:
                    c.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
            _log("rank 0 failed; the other ranks' exit codes so far:", [c.poll() for c in self.children])
            self.kill()
            return False
        _leave_group()
        limit = time.monotonic() + JOIN_LIMIT_S
        for c in self.children:
            try:
                c.wait(timeout=max(limit - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        self.done.set()
        late = [r for r, c in enumerate(self.children, 1) if c.poll() is None]
        codes = [c.returncode for c in self.children]
        self.kill()
        if late or any(codes):
            raise RuntimeError(f"ranks {late} did not end within {JOIN_LIMIT_S:.0f} s; exit codes {codes}")
        return False


def agree(flag: bool, device) -> bool:
    """Rank 0's ``flag``, on every rank."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def gather(obj, place: Place) -> Optional[List]:
    """Every rank's ``obj`` (picklable, on the host), on rank 0 in rank
    order; None on the other ranks."""
    if place.ranks == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * place.ranks if place.rank == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def _leave_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _watch_parent(pid: int):
    while True:
        if os.getppid() != pid:
            os._exit(1)
        time.sleep(1.0)


def child_main(spec: Dict) -> int:
    """Rank ``spec['rank']``: every run of the plan, as rank 0 makes it;
    exit code 3 where a module that must not load has loaded (rank 0 then
    fails the run)."""
    threading.Thread(target=_watch_parent, args=(spec["parent"],), daemon=True).start()
    from benchmark.harness.main import banned_modules, run_cell

    place = Place(spec["rank"], spec["ranks"], spec["init_method"])
    for entry in spec["plan"]:
        run_cell(**entry, device=spec["device"], bench=Path(spec["bench"]), place=place)
    _leave_group()
    found = banned_modules()
    if found:
        _log(f"rank {place.rank}: modules that must not load are loaded: {found}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(child_main(json.loads(sys.argv[1])))
