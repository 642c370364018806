"""The ranks of a cell that takes more than one card.

A cell with ``chips`` = N > 1 runs as N processes on one host, rank r on
card r, in lockstep:

- The process that the benchmark's command starts is rank 0.
  :class:`Launcher` starts ranks 1 .. N-1 as copies of the same command
  with ``--rank`` and ``--rendezvous`` added (a TCP store on a free port of
  localhost), sends their standard output to its standard error, and
  watches them: a rank that exits with another code than 0 ends every rank
  and rank 0 with code :data:`FAILED`, and so does the deadline.  The other
  ranks end themselves when rank 0 dies (:func:`watch_parent`).  Each rank
  is pinned to a block of the host's cores of its own (:func:`pin`).
- Each rank joins through the port's public API
  (``parallel.init_distributed``, ``parallel.make_mesh``) with a timeout
  on every collective (:data:`TIMEOUT_S`), and opens a gloo group of its
  own for the harness's host-side collectives, which never touch the
  card's stream: the window's decisions (:meth:`Group.decide`, posted at
  one iteration and read at the next, so that no rank waits there), the
  gather of what each rank saw, the reference's blocks.
- Rank 0 alone times, profiles, checks and prints; the others run the same
  set-up, warm-up and solves, and serve the reference's calls
  (:class:`RankedReference`).  Every rank looks at its own ``sys.modules``
  once its run is over, and rank 0 prints nothing where any of them holds
  a module of :data:`FORBIDDEN` (:func:`run_ranks`).

One card is :class:`Solo`: no process, no group and no collective, the same
calls doing nothing."""

import argparse
import ctypes
import os
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["run_ranks", "add_arguments", "loaded_forbidden", "Start",
           "Solo", "Group", "Launcher", "RankedReference", "watch_parent",
           "pin", "card_share", "FORBIDDEN", "TIMEOUT_S", "FAILED"]

# top-level module names that no measuring process may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "grape_tpu")
# seconds that a collective may wait for the slowest rank before it fails
TIMEOUT_S = 180
# seconds from the start of rank 0 after which the launcher ends every rank
DEADLINE_S = 1150
# rank 0's exit code where a rank failed or the deadline passed
FAILED = 5
# exit codes of a run that prints no result: no card, or too few; a
# forbidden module loaded
NO_CARD, LOADED = 2, 3


def card_share(structure, world):
    """The counted shapes of one card's block: ``K`` and ``G`` divided by
    the cards, as ``parallel.shard_problem`` cuts whole groups.  A cell's
    groups divide its cards."""
    if world == 1:
        return structure
    G, K = int(structure["G"]), int(structure["K"])
    if G % world:
        raise ValueError(f"{G} groups do not divide over {world} cards")
    return dict(structure, G=G // world, K=K // world)


def add_arguments(ap):
    """The arguments that rank 0 gives the ranks it starts, hidden from the
    command's help: the driver never passes them."""
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)


def loaded_forbidden():
    """The modules of :data:`FORBIDDEN` that this process holds, compared by
    whole top-level names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_ranks(world, args, command, body, device="cuda", t0=None,
              who="benchmark"):
    """``body(group, t_torch)`` in this process as one of ``world`` ranks
    (``args.rank`` and ``args.rendezvous``, None on rank 0, which starts
    the others with ``command``; ``t_torch``: when torch's import ended).
    Returns ``(code, out)``: on rank 0 ``(0, body's return)``; ``code``
    :data:`NO_CARD` where the machine has no CUDA card or fewer than
    ``world``, :data:`LOADED` where any rank held a module of
    :data:`FORBIDDEN` once its body was over (each named on standard
    error); ``(0, None)`` on the other ranks."""
    with Start(world, args.rank, args.rendezvous, command, t0=t0) as start:
        import torch

        t_torch = time.perf_counter()
        if device == "cuda" and not torch.cuda.is_available():
            print(f"{who}: no CUDA card on this machine "
                  "(torch.cuda.is_available() is False); the benchmark runs "
                  "only on the card", file=sys.stderr)
            return NO_CARD, None
        if device == "cuda" and torch.cuda.device_count() < world:
            print(f"{who}: the cell asks for {world} cards, the machine "
                  f"has {torch.cuda.device_count()}", file=sys.stderr)
            return NO_CARD, None
        group = start.group(device)
        out = body(group, t_torch)
        loaded = group.gather(loaded_forbidden())
        start.finish(group)
        if not group.lead:
            return 0, None
    loaded[0] = loaded_forbidden()
    found = [(r, mods) for r, mods in enumerate(loaded) if mods]
    if found:
        print(f"{who}: the measuring process"
              + ("" if world == 1 else "es") + " loaded "
              + "; ".join(str(mods) if world == 1 else f"rank {r}: {mods}"
                          for r, mods in found), file=sys.stderr)
        return LOADED, None
    return 0, out


def pin(rank, world):
    """Pins this process, and the threads it starts from now on, to the
    ``rank``-th of ``world`` equal blocks of the cores it may run on, so
    that the ranks' host loops do not take each other's cores; returns the
    cores it was pinned to.  Where there are fewer cores than ranks,
    nothing is pinned (and none returned)."""
    cores = sorted(os.sched_getaffinity(0))
    n = len(cores) // int(world)
    if n == 0:
        return []
    mine = cores[rank * n:(rank + 1) * n]
    os.sched_setaffinity(0, mine)
    return mine


class Start:
    """This process's start as one of ``world`` ranks, as a context: rank 0
    (``rank`` None, the command as the driver gave it) starts the others
    with ``command`` at once and ends them on leaving; another rank
    (``--rank``) watches rank 0.  :meth:`group` gives this rank's place,
    :meth:`finish` closes it and, on rank 0, waits for the others."""

    def __init__(self, world, rank, rendezvous, command, t0=None):
        self.world, self.rank = int(world), int(rank or 0)
        self.launcher = None
        self.threads = None
        if rank is not None:
            watch_parent()
        elif self.world > 1:
            self.launcher = Launcher(command, self.world, t0=t0)
            rendezvous = self.launcher.rendezvous
        self.rendezvous = rendezvous
        if self.world > 1:
            # after the others have started, which take every core with them
            self.threads = max(1, len(pin(self.rank, self.world)))

    def group(self, device):
        """:class:`Solo` on one card, else this rank's :class:`Group` (not
        yet connected), with its card made the current one."""
        if self.world == 1:
            return Solo()
        import torch

        if torch.device(device).type == "cuda":
            torch.cuda.set_device(self.rank)
        return Group(self.rank, self.world, self.rendezvous, self.threads)

    def finish(self, group):
        group.close()
        if self.launcher is not None:
            self.launcher.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.launcher is not None:
            self.launcher.stop()
        return False


class Solo:
    """One card: rank 0 of one."""

    rank, world, lead, mesh = 0, 1, True, None

    def connect(self, device):
        pass

    def decide(self, flag, where, wait=False):
        return bool(flag)

    def gather(self, obj):
        return [obj]

    def broadcast(self, obj):
        return obj

    def barrier(self):
        pass

    def close(self):
        pass


class Group:
    """This rank's place among ``world`` ranks that meet at
    ``rendezvous``, with ``threads`` of torch's; :meth:`connect` joins
    them."""

    def __init__(self, rank, world, rendezvous, threads):
        self.rank, self.world = int(rank), int(world)
        self.lead = self.rank == 0
        self.rendezvous = rendezvous
        self.threads = threads
        self.mesh = self.host = None
        self._posted = None  # the decision posted and not yet read
        self._sync_s = []    # seconds of each of the window's decisions

    def connect(self, device):
        """Join the process group (NCCL on the card, gloo on the CPU), make
        the mesh over it and the host-side gloo group, with this rank's
        torch threads.  Once: a second call does nothing."""
        if self.mesh is not None:
            return
        import torch
        import torch.distributed as dist

        from grape_tpu_torch import parallel

        cuda = torch.device(device).type == "cuda"
        os.environ["LOCAL_RANK"] = str(self.rank)  # the port's card choice
        torch.set_num_threads(self.threads)
        parallel.init_distributed(
            self.rendezvous, self.world, self.rank,
            backend="nccl" if cuda else "gloo", device=device,
            timeout=TIMEOUT_S)
        self.mesh = parallel.make_mesh(device=device)
        self.host = dist.new_group(backend="gloo")

    def decide(self, flag, where, wait=False):
        """Rank 0's ``flag``, taken by every rank from an all-gather of a
        few integers on the host group, with each rank's place ``where``
        (the solve and the iteration): a rank out of lockstep raises.

        The all-gather is posted here and read at the next call, by which
        time every rank has posted it, so that no rank waits at a decision
        for the slowest: a call returns the flag posted at the call before
        (False at the first), and a call that returns True posts nothing.
        ``wait`` (a solve's end, after which that solve makes no call):
        also read the flag posted now."""
        t0 = time.perf_counter()
        close = self._read()
        if not close:
            self._post(flag, where)
            if wait:
                close = self._read()
        self._sync_s.append(time.perf_counter() - t0)
        return close

    def _post(self, flag, where):
        import torch
        import torch.distributed as dist

        mine = torch.tensor([int(bool(flag)), *where], dtype=torch.int64)
        rows = [torch.empty_like(mine) for _ in range(self.world)]
        work = dist.all_gather(rows, mine, group=self.host, async_op=True)
        self._posted = (work, rows)

    def _read(self):
        if self._posted is None:
            return False
        work, rows = self._posted
        self._posted = None
        work.wait()
        places = {tuple(r[1:].tolist()) for r in rows}
        if len(places) != 1:
            raise RuntimeError(f"the ranks are out of lockstep: {places}")
        return bool(rows[0][0])

    def gather(self, obj):
        """Every rank's ``obj`` on rank 0 (a list in rank order), None on
        the others."""
        import torch.distributed as dist

        out = [None] * self.world if self.lead else None
        dist.gather_object(obj, out, dst=0, group=self.host)
        return out

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host)
        return box[0]

    def barrier(self):
        import torch.distributed as dist

        dist.barrier(group=self.host)

    def close(self):
        """Leave the group once every rank has come to leave it."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.barrier(group=self.host)
            dist.destroy_process_group()

    def sync_times(self):
        """Seconds of each decision of the window so far."""
        return list(self._sync_s)


class RankedReference:
    """The reference of ``kind`` over the ranks: each rank builds it on its
    block of the raw inputs (the kind's ``blocks(inputs, n)``; a kind
    without it is computed whole on rank 0) and rank 0 sums the blocks'
    values (``combine(blocks, parts)``).  Rank 0 calls
    :meth:`value_and_grad` and :meth:`close`; the others :meth:`serve`
    until it closes.  Nothing here touches the program."""

    def __init__(self, kind, config, raw, device, ranks, **kwargs):
        self.kind, self.ranks = kind, ranks
        n = ranks.world
        split = getattr(kind, "blocks", None)
        self.blocks = (split(raw, n) if split is not None and n > 1
                       else [raw] + [None] * (n - 1))
        mine = self.blocks[ranks.rank]
        self.local = (kind.Reference(config, mine, device, **kwargs)
                      if mine is not None else None)

    def _part(self, pulses):
        return (self.local.value_and_grad(pulses)
                if self.local is not None else None)

    def value_and_grad(self, pulses):
        if self.ranks.world == 1:
            return self.local.value_and_grad(pulses)
        pulses = self.ranks.broadcast(pulses)
        parts = self.ranks.gather(self._part(pulses))
        held = [(b, p) for b, p in zip(self.blocks, parts) if b is not None]
        combine = getattr(self.kind, "combine", None)
        if combine is None:
            return held[0][1]
        return combine([b for b, _ in held], [p for _, p in held])

    def serve(self):
        while True:
            pulses = self.ranks.broadcast(None)
            if pulses is None:
                return
            self.ranks.gather(self._part(pulses))

    def close(self):
        if self.ranks.world > 1 and self.ranks.lead:
            self.ranks.broadcast(None)


def free_port():
    """A TCP port of localhost that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launcher:
    """Ranks 1 .. ``world``-1 of ``command`` (the argument list of rank 0's
    own command, to which each gets ``--rank r --rendezvous <address>``),
    started now and watched until :meth:`finish` or :meth:`stop`."""

    def __init__(self, command, world, t0=None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.rendezvous = f"tcp://127.0.0.1:{free_port()}"
        self.procs = [
            subprocess.Popen([*command, "--rank", str(r),
                              "--rendezvous", self.rendezvous],
                             stdin=subprocess.DEVNULL, stdout=sys.stderr)
            for r in range(1, int(world))]
        print("ranks " + " ".join(f"{r}:{p.pid}" for r, p in
                                  enumerate(self.procs, start=1)),
              file=sys.stderr, flush=True)
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def _watchdog(self):
        while not self._done.wait(0.2):
            for r, p in enumerate(self.procs, start=1):
                rc = p.poll()
                if rc is not None and rc != 0:
                    self._fail(f"rank {r} exited with code {rc}")
            if time.perf_counter() - self.t0 > DEADLINE_S:
                self._fail(f"the ranks ran past {DEADLINE_S} s")

    def _fail(self, why):
        print(f"benchmark: {why}; ending every rank", file=sys.stderr,
              flush=True)
        self.stop()
        os._exit(FAILED)

    def stop(self):
        """Ends every rank that still runs and waits for each."""
        self._done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def finish(self, timeout=TIMEOUT_S):
        """Waits for every rank to exit; raises where one did not exit with
        0 within ``timeout`` seconds (and ends it)."""
        end = time.perf_counter() + timeout
        for p in self.procs:
            try:
                p.wait(max(0.0, end - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
        self._done.set()
        rcs = [p.poll() for p in self.procs]
        self.stop()
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(f"the ranks' exit codes: {rcs}")


def watch_parent():
    """Ends this rank when rank 0, its parent, is gone: at once by the
    kernel's parent-death signal where Linux gives it, else within a
    second by a thread that looks."""
    parent = os.getppid()
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(FAILED)

    def look():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(FAILED)

    threading.Thread(target=look, daemon=True).start()
