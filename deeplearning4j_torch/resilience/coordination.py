"""Coordinated cross-process restart for a ``torch.distributed`` fleet
(port of ``deeplearning4j_tpu/resilience/coordination.py``).

A SIGTERM checkpoints *this* process at *its* next step boundary; in a
multi-process job the other ranks never see a signal, and the fleet dies
mid-collective with its checkpoints at mismatched steps.  The
coordinated pieces:

* **In-band preemption broadcast** — :class:`FleetCoordinator` installs
  itself as the step-boundary preemption poll (``resilience.preemption``)
  and or-reduces the local flag over the process group
  (``parallel.distributed.or_reduce_flag``), so every rank learns of any
  rank's SIGTERM at the SAME step boundary and the forced final
  checkpoints all carry the SAME step label.

* **Survivor-quorum rendezvous** — :func:`survivor_rendezvous` runs
  BEFORE ``distributed.initialize`` (forming the process group needs the
  world size, which a shrunken fleet does not know): each process
  beacons into a shared directory, waits a bounded grace window for
  peers, and the committed set IS the fleet — world size M and a
  deterministic rank order (sorted host ids).
  :meth:`FleetCoordinator.rendezvous` is the in-band confirmation inside
  the formed job: the sum-reduce barrier proves every process
  dispatched.

* **Elect-and-agree restart** — :func:`fleet_resume_fit` generalizes
  ``auto_resume_fit`` to N processes: every (re-)entry passes the
  barrier, then agrees on the newest COMMON checkpoint (min-reduce of
  each rank's newest step; ranks discard anything newer).  A resume at a
  different world than the checkpoint's counts as elastic
  (``fleet_elastic_resumes_total{direction=}``); exhausting
  ``max_restarts`` raises :class:`~.errors.FleetResumeExhausted`.

Telemetry (the reference's series): ``fleet_preempt_broadcasts_total``,
``fleet_resumes_total{outcome=}``,
``fleet_elastic_resumes_total{direction=}``, ``fleet_world_size``,
``fleet_rendezvous_wait_seconds``.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, NamedTuple, Optional, Tuple, Type

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.resilience import preemption as _preemption
from deeplearning4j_torch.resilience.errors import (FleetResumeExhausted,
                                                  TrainingPreempted)

log = logging.getLogger("deeplearning4j_torch")

FLEET_BROADCASTS = telemetry.counter(
    "fleet_preempt_broadcasts_total",
    "step-boundary preemption-flag all-reduces that returned 'preempt' "
    "(each rank counts the broadcast it acted on)")
FLEET_RESUMES = telemetry.counter(
    "fleet_resumes_total",
    "fleet fit (re-)entries by outcome: resumed (rendezvoused and "
    "agreed a resume checkpoint step), fresh_start (agreed that no "
    "common checkpoint exists), exhausted (max_restarts burned — "
    "FleetResumeExhausted raised)", labelnames=("outcome",))
FLEET_ELASTIC = telemetry.counter(
    "fleet_elastic_resumes_total",
    "fleet resumes whose agreed world size differed from the "
    "checkpoint's recorded world (shrink: fewer, grow: more) — the "
    "N-to-M resharding path ran", labelnames=("direction",))
FLEET_WORLD = telemetry.gauge(
    "fleet_world_size",
    "the world size this rank last rendezvoused into (survivor-quorum "
    "or in-band barrier)")
FLEET_RDV_WAIT = telemetry.histogram(
    "fleet_rendezvous_wait_seconds",
    "wall time a rank spent blocked in a rendezvous (quorum grace "
    "window, or the in-band barrier waiting for stragglers)")


def atomic_publish_json(path: str, doc: dict) -> None:
    """Publish ``doc`` at ``path`` atomically (write-to-temp +
    ``os.replace``): a concurrent reader sees either the previous
    complete document or this one, never a torn write.  The beacon
    primitive the survivor rendezvous below writes its host files
    with, shared with the fleet metric transport
    (``telemetry.fleet.MetricsBeacon``) — both planes publish into a
    shared directory that peers poll."""
    import threading
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # pid AND thread id: two threads of one process publishing the
    # same path (a beacon loop racing a manual publish) must not
    # interleave writes into one temp file
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


class SurvivorWorld(NamedTuple):
    """The quorum a survivor rendezvous agreed: ``world`` processes,
    this process at ``rank`` in the deterministic (sorted-host) order,
    over ``hosts``."""
    world: int
    rank: int
    hosts: Tuple[str, ...]


def survivor_rendezvous(directory, host_id: Optional[str] = None,
                        grace_s: float = 5.0,
                        expected: Optional[int] = None,
                        min_world: int = 1,
                        poll_s: float = 0.05,
                        epoch: int = 0) -> SurvivorWorld:
    """Pre-``initialize`` quorum over a shared directory (the
    checkpoint directory is the natural choice — any survivor that can
    resume can also beacon there): each process writes a beacon and
    waits for the survivor set to settle, WITHOUT knowing in advance
    how many peers still exist.

    A participant PROPOSES a freeze when ``expected`` hosts arrive
    (the fast path — nothing was lost) or when the grace window
    closes: ``grace_s`` seconds after the LAST arrival with at least
    ``min_world`` hosts present (a bounded wait — a permanently-lost
    host delays restart by one grace window, never forever).  The
    AGREED world is then the one committed to ``world.json`` by an
    atomic first-writer-wins create, and every participant adopts the
    COMMITTED set — two hosts whose grace windows closed on different
    views cannot split-brain into two fleets.  A host that beaconed
    too late to make the committed set raises a typed
    :class:`~.errors.ElasticWorldError` (its supervisor retries at the
    next epoch) instead of hanging a mis-sized ``initialize``.

    ``epoch`` namespaces restart rounds.  A leftover ``world.json``
    from a PREVIOUS round (committed more than ``grace_s`` before this
    process beaconed) advances to the next epoch automatically, so
    stale beacons are never counted as live hosts even when every
    round passes the default ``epoch=0``.

    Returns a :class:`SurvivorWorld`; feed ``world``/``rank`` straight
    into ``distributed.initialize(num_processes=world,
    process_id=rank)``.

    >>> w = survivor_rendezvous(ckpt_dir, host_id=node_name, expected=N)
    >>> distributed.initialize(f"{w.hosts[0]}:{port}",
    ...                        num_processes=w.world, process_id=w.rank)
    """
    from deeplearning4j_torch.resilience.errors import ElasticWorldError
    if host_id is None:
        host_id = f"{os.uname().nodename}-{os.getpid()}"
    host_id = str(host_id)
    if os.sep in host_id:
        raise ValueError(f"host_id {host_id!r} must be a plain name")
    t0 = time.monotonic()
    epoch = int(epoch)
    while True:                              # one round per epoch dir
        rdv = os.path.join(str(directory), "_rendezvous", str(epoch))
        os.makedirs(rdv, exist_ok=True)
        mine = os.path.join(rdv, host_id + ".json")
        atomic_publish_json(mine, {"host": host_id, "pid": os.getpid(),
                                   "t": time.time()})
        my_mtime = os.path.getmtime(mine)
        world_path = os.path.join(rdv, "world.json")

        seen: set = set()
        last_arrival = time.monotonic()
        hosts = None
        while True:
            committed = _read_committed(world_path)
            if committed is not None:
                if os.path.getmtime(world_path) < my_mtime - grace_s:
                    # a PREVIOUS restart round consumed this epoch —
                    # its beacons are ghosts; walk to the next epoch
                    log.info("survivor rendezvous: epoch %d already "
                             "committed by an earlier round; advancing",
                             epoch)
                    epoch += 1
                    break
                hosts = committed
                break
            now_set = {n[:-len(".json")] for n in os.listdir(rdv)
                       if n.endswith(".json") and n != "world.json"}
            if now_set - seen:
                last_arrival = time.monotonic()
                seen = now_set
            frozen = ((expected is not None and len(seen) >= expected)
                      or (len(seen) >= max(1, int(min_world))
                          and time.monotonic() - last_arrival
                          >= grace_s))
            if frozen:
                # propose MY view; the atomic first-writer-wins create
                # makes ONE proposal the committed world, and the next
                # loop iteration adopts whatever actually won
                _commit_world(world_path, host_id, sorted(seen))
                continue
            time.sleep(poll_s)
        if hosts is None:
            continue                         # epoch advanced; re-beacon
        waited = time.monotonic() - t0
        FLEET_RDV_WAIT.observe(waited)
        if host_id not in hosts:
            raise ElasticWorldError(
                f"survivor rendezvous (epoch {epoch}): the quorum "
                f"froze {hosts} without {host_id!r} (beaconed too "
                "late) — retry at the next epoch once the running "
                "fleet is gone")
        world = SurvivorWorld(len(hosts), hosts.index(host_id), hosts)
        FLEET_WORLD.set(world.world)
        log.info("survivor rendezvous (epoch %d): %d host(s) after "
                 "%.2fs — this process is rank %d of %s", epoch,
                 world.world, waited, world.rank, hosts)
        return world


def _read_committed(world_path: str):
    """The committed host tuple from ``world.json``, or None."""
    try:
        with open(world_path) as f:
            return tuple(json.load(f)["hosts"])
    except (OSError, ValueError, KeyError):
        return None


def _commit_world(world_path: str, host_id: str, hosts) -> None:
    """First-writer-wins commit: publish a fully-written proposal via
    hardlink (atomic, never readable half-written), falling back to
    O_EXCL create where the filesystem lacks links.  Losing the race
    is fine — the caller re-reads and adopts the winner."""
    doc = json.dumps({"hosts": list(hosts), "t": time.time()})
    prop = f"{world_path}.{host_id}"
    try:
        with open(prop, "w") as f:
            f.write(doc)
        try:
            os.link(prop, world_path)
        except FileExistsError:
            return
        except OSError:                 # no hardlinks on this FS
            try:
                fd = os.open(world_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return
            with os.fdopen(fd, "w") as f:
                f.write(doc)
    finally:
        try:
            os.unlink(prop)
        except OSError:
            pass


class FleetCoordinator:
    """Fleet-wide preemption propagation + restart rendezvous over a
    device mesh (the training mesh, flattened; or all devices).

    >>> with FleetCoordinator(trainer.mesh):
    ...     trainer.fit(it, n_epochs=5)     # any rank's SIGTERM now
    ...                                     # checkpoints EVERY rank at
    ...                                     # the same step

    As a context manager it installs itself as ``run_fit``'s
    step-boundary preemption poll; :func:`fleet_resume_fit` composes it
    with restart supervision.  All methods that reduce are COLLECTIVE:
    every process must call them at the same point, which the
    synchronous training loop guarantees for :meth:`poll` and the
    restart protocol guarantees for :meth:`rendezvous` /
    :meth:`agree_resume_step`.
    """

    def __init__(self, mesh=None):
        self.mesh = mesh
        self._previous = None

    # -- in-band flag broadcast ----------------------------------------
    def poll(self, local_flag: bool) -> bool:
        """Or-reduce the local preemption flag over the fleet; when the
        fleet says preempt, arm the LOCAL flag too so the forced
        checkpoint-and-unwind path runs identically on every rank."""
        from deeplearning4j_torch.parallel import distributed
        fleet_flag = distributed.or_reduce_flag(local_flag, self.mesh)
        if fleet_flag:
            FLEET_BROADCASTS.inc()
            if not local_flag:
                log.warning("fleet preemption broadcast received: a "
                            "peer rank is preempted; checkpointing at "
                            "this step boundary")
                _preemption.request_preemption()
        return fleet_flag

    # -- restart protocol ----------------------------------------------
    def rendezvous(self) -> int:
        """Barrier gating re-entry into collectives: blocks until every
        process in the (re-)formed job has dispatched.  The sum of one
        1 per device is the world that ACTUALLY assembled — returned,
        not demanded: whether M matches the checkpointed world is the
        resume path's question (:func:`fleet_resume_fit` counts a
        mismatch as an elastic resume), not the barrier's.  The only
        raise left is internal inconsistency: the reduce seeing a
        different device total than this rank's own mesh means a rank
        re-initialized with a different topology mid-job."""
        from deeplearning4j_torch.parallel import distributed
        # a mesh of this process's devices repeats over the processes; a
        # global mesh already counts every process's devices
        local_view = (self.mesh.size if self.mesh is not None
                      and self.mesh.owners is not None else
                      (self.mesh.size if self.mesh is not None else 1)
                      * distributed.process_count())
        # every device contributes a 1: the sum is the device total,
        # and the dispatch itself is the barrier (the collective cannot
        # complete until every process has issued it)
        t0 = time.monotonic()
        total = distributed.sum_reduce(1, self.mesh)
        FLEET_RDV_WAIT.observe(time.monotonic() - t0)
        if total != local_view:
            raise RuntimeError(
                f"fleet rendezvous saw {total} devices, but this "
                f"rank's mesh has {local_view} — a rank "
                "re-initialized with a different topology")
        FLEET_WORLD.set(distributed.process_count())
        return total

    def agree_resume_step(self, checkpoint) -> Optional[int]:
        """Newest-common-checkpoint agreement: each rank offers its
        newest step, the fleet min-reduces, and every rank DISCARDS
        checkpoints newer than the agreed step (a forced final save
        that landed on some hosts but not others must not desync the
        restore) so the subsequent ``restore_latest``/``resume=True``
        restores the same step everywhere.  ``checkpoint`` is a
        ``CheckpointListener`` or ``ShardedCheckpointer``.  Returns the
        agreed step, or None when no rank has a full set."""
        ck = getattr(checkpoint, "ckpt", checkpoint)
        from deeplearning4j_torch.parallel import distributed
        steps = sorted(int(s) for s in ck.all_steps())
        newest = steps[-1] if steps else -1
        agreed = distributed.min_reduce(newest, self.mesh)
        if agreed < 0:
            # some rank has NOTHING (replaced node, wiped disk): the
            # fresh start must be fleet-wide — a rank quietly resuming
            # its local step N against fresh-start peers is exactly
            # the desync this agreement exists to prevent
            for s in steps:
                log.warning("fleet agreement: discarding local "
                            "checkpoint step %d (a peer has no "
                            "checkpoints; fleet fresh-starts)", s)
                ck.delete_step(s)
            log.info("fleet agreement: no common checkpoint "
                     "(fresh start)")
            FLEET_RESUMES.labels(outcome="fresh_start").inc()
            return None
        if agreed not in steps:
            raise RuntimeError(
                f"fleet agreement: agreed step {agreed} is missing "
                f"locally (have {steps}) — checkpoint retention "
                "rotated it out; raise keep_last")
        for s in steps:
            if s > agreed:
                log.warning("fleet agreement: discarding local "
                            "checkpoint step %d > agreed %d (not "
                            "fleet-complete)", s, agreed)
                ck.delete_step(s)
        FLEET_RESUMES.labels(outcome="resumed").inc()
        log.info("fleet agreement: resuming from common checkpoint "
                 "step %d", agreed)
        return agreed

    # -- scoped install -------------------------------------------------
    def __enter__(self):
        self._previous = _preemption.install_coordinator(self)
        return self

    def __exit__(self, *exc):
        _preemption.install_coordinator(self._previous)
        self._previous = None
        return False


def _note_elastic(checkpoint, agreed: Optional[int],
                  world_now: int) -> None:
    """Compare the agreed checkpoint's recorded world against the world
    that rendezvoused; count shrink/grow on a mismatch.  Best-effort:
    pre-elastic checkpoints have no sidecar and count nothing."""
    if checkpoint is None or agreed is None:
        return
    world_at = getattr(checkpoint, "world_at", None)
    meta = world_at(agreed) if world_at is not None else None
    saved = (meta or {}).get("world")
    if saved is None or int(saved) == int(world_now):
        return
    direction = "shrink" if int(world_now) < int(saved) else "grow"
    FLEET_ELASTIC.labels(direction=direction).inc()
    log.warning("ELASTIC fleet resume: checkpoint step %s was saved at "
                "world=%s, resuming at world=%d (%s) — optimizer "
                "layout/shardings re-laid by the restore path",
                agreed, saved, world_now, direction)


def fleet_resume_fit(fit_fn: Callable, mesh=None, checkpoint=None,
                     max_restarts: int = 3,
                     retry_on: Tuple[Type[BaseException], ...] = (),
                     world: Optional[int] = None):
    """``auto_resume_fit`` generalized to a ``torch.distributed`` fleet:
    run ``fit_fn`` (a zero-arg callable driving a RESUMABLE fit, i.e.
    one that passes ``resume=True`` with a ``CheckpointListener``
    attached) to completion across coordinated preemptions.

    Every (re-)entry is gated by the restart protocol — rendezvous
    barrier, then newest-common-checkpoint agreement on ``checkpoint``
    (when given) — and runs under an installed
    :class:`FleetCoordinator`, so any rank's preemption during the fit
    checkpoints the WHOLE fleet at one step.  On a true process death
    the surviving collective hangs and the cluster manager restarts
    the job; the fresh processes (however many survived — see
    :func:`survivor_rendezvous` for deciding M before
    ``distributed.initialize``) land back here, where the barrier
    holds them until the reassembled fleet is whole and the agreement
    picks the step every rank can restore.  ``world`` is this job's
    LOGICAL world size for elastic accounting (default: the process
    count); when it differs from the agreed checkpoint's recorded
    world the resume is counted in
    ``fleet_elastic_resumes_total{direction=}`` and the restore path
    re-lays the state N→M (``parallel.elastic``).

    Exhausting ``max_restarts`` raises
    :class:`~.errors.FleetResumeExhausted` (carrying the last agreed
    step and the world size) with the final failure as its
    ``__cause__``.

    >>> w = survivor_rendezvous(shared_dir, expected=N)   # M <= N show
    >>> distributed.initialize(coord, num_processes=w.world,
    ...                        process_id=w.rank)
    >>> trainer = ShardedTrainer(model, MeshConfig(data=w.world))
    >>> ck = CheckpointListener(shared_dir, save_every_n_iterations=50)
    >>> model.set_listeners(ck)
    >>> fleet_resume_fit(
    ...     lambda: trainer.fit(it, n_epochs=10, resume=True),
    ...     mesh=trainer.mesh, checkpoint=ck, world=w.world)
    """
    from deeplearning4j_torch.parallel import distributed
    coordinator = FleetCoordinator(mesh)
    world_now = (int(world) if world is not None
                 else distributed.process_count())
    restarts = 0
    last_agreed = None
    with coordinator:
        while True:
            coordinator.rendezvous()
            FLEET_WORLD.set(world_now)
            if checkpoint is not None:
                last_agreed = coordinator.agree_resume_step(checkpoint)
                _note_elastic(checkpoint, last_agreed, world_now)
            try:
                return fit_fn()
            except TrainingPreempted as e:
                _preemption.clear_preemption()
                restarts += 1
                if restarts > max_restarts:
                    FLEET_RESUMES.labels(outcome="exhausted").inc()
                    raise FleetResumeExhausted(
                        step=(e.step if e.step is not None
                              else last_agreed),
                        world=world_now, last_error=e) from e
                log.warning("fleet preempted at checkpoint step %s; "
                            "restart %d/%d rendezvouses and resumes",
                            e.step, restarts, max_restarts)
            except retry_on as e:              # pragma: no branch
                _preemption.clear_preemption()
                restarts += 1
                if restarts > max_restarts:
                    FLEET_RESUMES.labels(outcome="exhausted").inc()
                    raise FleetResumeExhausted(
                        step=last_agreed, world=world_now,
                        last_error=e) from e
                log.warning("fleet fit failed (%s: %s); restart %d/%d "
                            "resumes from the agreed checkpoint",
                            type(e).__name__, e, restarts, max_restarts)
