"""Launch the workers of a job of several processes (counterpart of
``tools/launch.py``)::

    python -m mxnet_tpu_torch.tools.launch -n 2 [--launcher local|ssh]
        [-H hostfile] [--supervise ...] python3 train.py ...

Each worker gets the environment of its rank: the launcher's
``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCESSES`` and ``MXTPU_PROCESS_ID``
(read by ``parallel.initialize`` and a ``dist_*`` kvstore), and torch's
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE`` (the ranks placed on its host: the backend rule
reads it). ``--launcher ssh`` places rank r on host ``r % len(hosts)`` of
the hostfile and runs it through ``ssh`` (``MXTPU_SSH`` replaces the
binary: tests use a local shim), forwarding ``PYTHONPATH``, ``PATH``,
``CUDA_VISIBLE_DEVICES``, every ``MXNET_*`` knob and ``--env``'s names.

Two modes:

- plain (default): every worker in its own process group; the exit codes
  are collected and reported, and the first failure kills the remaining
  groups (SIGTERM, then SIGKILL after a grace);
- ``--supervise``: the elastic supervisor (``resilience.elastic`` is the
  worker's half). Workers register and beat in a file rendezvous
  directory; a crashed worker restarts with exponential backoff; exit 75
  (preempted, its emergency checkpoint written), exit 137 (a lost host),
  a missed-beat deadline or a spent restart budget evict it, and the
  world re-forms at the surviving size (workers resume through
  ``elastic_fit``). ``--total-devices`` is re-spread over the surviving
  world by ``parallel.planner.respread`` and reaches each worker as
  ``MXTPU_LOCAL_DEVICES``, the number of logical CPU devices a mesh takes
  there. ``--event-log`` appends each transition as a JSON line
  (``generation_start``, ``generation_live``, ``worker_failed``,
  ``generation_stopped``, ``restart``, ``evicted``, ``run_failed``,
  ``run_complete``, ``supervisor_stopped``).

``--telemetry-port`` and ``--metrics-base-port`` (the job-wide metrics
plane) raise: they are ROADMAP item 11b.
"""
import argparse
import collections
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import tempfile
import time

# the exit codes resilience.elastic and resilience.chaos give
EXIT_PREEMPTED = 75
EXIT_HOST_LOSS = 137


def _placement(rank, world, hosts):
    """``(local_rank, local_world_size)`` of ``rank``: its index among the
    ranks on its host, and their number."""
    if not hosts:
        return rank, world
    n = len(hosts)
    same = [r for r in range(world) if r % n == rank % n]
    return same.index(rank), len(same)


def _rank_env(args, rank, world=None, coordinator=None, hosts=None):
    world = args.num_workers if world is None else world
    coordinator = args.coordinator if coordinator is None else coordinator
    addr, port = coordinator.rsplit(":", 1)
    local, local_world = _placement(rank, world, hosts)
    return {
        "MXTPU_COORDINATOR": coordinator,
        "MXTPU_NUM_PROCESSES": str(world),
        "MXTPU_PROCESS_ID": str(rank),
        "MASTER_ADDR": addr,
        "MASTER_PORT": port,
        "RANK": str(rank),
        "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(local),
        "LOCAL_WORLD_SIZE": str(local_world),
    }


def _read_hosts(args):
    with open(args.hostfile) as f:
        hosts = [ln.strip() for ln in f if ln.strip()
                 and not ln.startswith("#")]
    if not hosts:
        raise SystemExit("hostfile %s is empty" % args.hostfile)
    return hosts


def _spawn_worker(args, rank, env, hosts=None):
    """One worker in its own process group (a kill reaches its whole
    tree)."""
    if args.launcher == "ssh":
        host = hosts[rank % len(hosts)]
        ssh = shlex.split(os.environ.get("MXTPU_SSH", "ssh"))
        fwd = ["PYTHONPATH", "PATH", "CUDA_VISIBLE_DEVICES"] + \
            sorted(k for k in os.environ if k.startswith("MXNET_")) + \
            [v for v in (args.env or "").split(",") if v]
        renv = dict(env)
        for var in fwd:
            if var in os.environ and var not in renv:
                renv[var] = os.environ[var]
        envs = " ".join("%s=%s" % (k, shlex.quote(v))
                        for k, v in sorted(renv.items()))
        remote = "cd %s && %s %s" % (
            shlex.quote(os.getcwd()), envs,
            " ".join(shlex.quote(c) for c in args.command))
        return subprocess.Popen(
            ssh + ["-n", "-o", "BatchMode=yes",
                   "-o", "StrictHostKeyChecking=no", host, remote],
            start_new_session=True)
    penv = dict(os.environ)
    penv.update(env)
    return subprocess.Popen(args.command, env=penv, start_new_session=True)


def _pg_kill(proc, sig):
    """Signal the worker's process group (its direct child when the group
    is gone)."""
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


def _wait_procs(procs, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            return True
        time.sleep(0.05)
    return all(p.poll() is not None for p in procs)


def _kill_all(procs, grace_s, sig_first=signal.SIGTERM):
    """SIGTERM the surviving groups (elastic workers checkpoint in their
    grace), wait, SIGKILL the rest."""
    procs = list(procs)
    for p in procs:
        if p.poll() is None:
            _pg_kill(p, sig_first)
    if not _wait_procs(procs, grace_s):
        for p in procs:
            if p.poll() is None:
                _pg_kill(p, signal.SIGKILL)
        _wait_procs(procs, 5.0)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_plain(args, hosts):
    procs = []
    try:
        # spawned inside the try: a failure at rank k still sweeps 0..k-1
        for rank in range(args.num_workers):
            procs.append(_spawn_worker(
                args, rank, _rank_env(args, rank, hosts=hosts), hosts))
        return _wait_plain(procs)
    finally:
        if any(p.poll() is None for p in procs):
            _kill_all(procs, 5.0)


def _wait_plain(procs):
    codes = {}
    first_bad = None
    while len(codes) < len(procs):
        for rank, proc in enumerate(procs):
            if rank in codes:
                continue
            rc = proc.poll()
            if rc is None:
                continue
            codes[rank] = rc
            if rc != 0 and first_bad is None:
                first_bad = (rank, rc)
                sys.stderr.write(
                    "launch: worker %d exited rc=%d, terminating the "
                    "remaining %d worker group(s)\n"
                    % (rank, rc, sum(1 for p in procs
                                     if p.poll() is None)))
                _kill_all(procs, 10.0)
        time.sleep(0.05)
    sys.stderr.write("launch: per-worker exit codes: %s\n"
                     % json.dumps({str(r): codes[r] for r in sorted(codes)}))
    return first_bad[1] if first_bad is not None else 0


class _EventLog:
    def __init__(self, path):
        self._f = open(path, "a", buffering=1) if path else None

    def emit(self, event, **kw):
        rec = {"t": time.time(), "event": event}
        rec.update(kw)
        sys.stderr.write("launch[supervise]: %s\n" % json.dumps(rec))
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()


def _supervise(args, hosts):
    from mxnet_tpu_torch import config as _config

    world = args.num_workers
    min_world = (args.min_world if args.min_world is not None
                 else _config.get("MXNET_ELASTIC_MIN_WORLD"))
    max_restarts = (args.max_restarts if args.max_restarts is not None
                    else _config.get("MXNET_ELASTIC_MAX_RESTARTS"))
    backoff_ms = (args.backoff_ms if args.backoff_ms is not None
                  else _config.get("MXNET_ELASTIC_BACKOFF_MS"))
    grace_s = (args.grace_ms if args.grace_ms is not None
               else _config.get("MXNET_ELASTIC_GRACE_MS")) / 1e3
    rdzv = os.path.abspath(args.rdzv_dir or
                           tempfile.mkdtemp(prefix="mxtpu_rdzv_"))
    log = _EventLog(args.event_log)
    # a rank's crashes in a row; the streak resets only on durable
    # progress (its `start`, the checkpoint step it resumed from, moved)
    crashes = collections.Counter()
    fail_start = {}
    coord_host = (args.coordinator or "127.0.0.1:0").rsplit(":", 1)[0]
    procs = {}   # this generation's workers, changed in place

    def _teardown():
        _kill_all(procs.values(), grace_s + 5.0)

    def _on_signal(signum, frame):
        log.emit("supervisor_stopped", signum=int(signum))
        _teardown()
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        return _supervise_loop(args, log, coord_host,
                               list(hosts) if hosts else None, rdzv, world,
                               min_world, max_restarts, backoff_ms, crashes,
                               fail_start, procs, _teardown)
    finally:
        if any(p.poll() is None for p in procs.values()):
            _kill_all(procs.values(), grace_s + 5.0)


def _exit_reason(rc):
    if rc == EXIT_PREEMPTED:
        return "preempted"
    if rc == EXIT_HOST_LOSS:
        return "host_loss"       # SIGKILL-class death: evict, no restart
    return "crashed"


def _supervise_loop(args, log, coord_host, hosts_pool, rdzv, world,
                    min_world, max_restarts, backoff_ms, crashes,
                    fail_start, procs, _teardown):
    from mxnet_tpu_torch import config as _config
    from mxnet_tpu_torch.parallel.planner import respread
    from mxnet_tpu_torch.resilience.elastic import ElasticCoordinator

    deadline_ms = (args.deadline_ms if args.deadline_ms is not None
                   else _config.get("MXNET_ELASTIC_DEADLINE_MS"))
    # a worker wedged before its first record trips neither check below:
    # start-up is bounded too
    startup_s = 4.0 * deadline_ms / 1e3
    gen = 0
    while True:
        coordinator = "%s:%d" % (coord_host, _free_port())
        coord = ElasticCoordinator(rdzv, world_size=world,
                                   deadline_ms=deadline_ms, generation=gen)
        coord.clear()
        extra = {"MXTPU_RDZV_DIR": rdzv, "MXTPU_GENERATION": str(gen),
                 "MXTPU_ELASTIC": "1"}
        if args.total_devices:
            extra["MXTPU_LOCAL_DEVICES"] = str(
                respread(args.total_devices, world))
        procs.clear()
        for rank in range(world):
            env = _rank_env(args, rank, world=world, coordinator=coordinator,
                            hosts=hosts_pool)
            env.update(extra)
            procs[rank] = _spawn_worker(args, rank, env, hosts_pool)
        log.emit("generation_start", gen=gen, world=world,
                 coordinator=coordinator)
        failure = None
        live_emitted = False
        last_scan = 0.0
        gen_t0 = time.monotonic()
        while failure is None:
            time.sleep(0.05)
            all_done = True
            for rank, proc in procs.items():
                rc = proc.poll()
                if rc is None:
                    all_done = False
                    continue
                if rc == 0:
                    crashes.pop(rank, None)
                    continue
                failure = (_exit_reason(rc), rank, rc)
                break
            if failure is not None:
                break
            if all_done:
                log.emit("run_complete", gen=gen, world=world)
                log.close()
                return 0
            if time.monotonic() - last_scan < 0.5:
                continue
            last_scan = time.monotonic()
            snap = coord.snapshot()
            if not live_emitted and coord.world(snap) >= world:
                live_emitted = True
                log.emit("generation_live", gen=gen, world=world)
            for rank in coord.dead(snap):
                if rank in procs and procs[rank].poll() is None:
                    # a silent wedge: it will not exit by itself
                    failure = ("hung", rank, None)
                    _pg_kill(procs[rank], signal.SIGKILL)
                    break
            if failure is None and snap and not live_emitted \
                    and time.monotonic() - gen_t0 > startup_s:
                # its peers registered, it did not: wedged at start-up
                for rank, p in procs.items():
                    if p.poll() is None and rank not in snap:
                        failure = ("hung", rank, None)
                        _pg_kill(p, signal.SIGKILL)
                        break
        reason, rank, rc = failure
        log.emit("worker_failed", gen=gen, rank=rank, reason=reason, rc=rc)
        if reason == "crashed":
            cur = coord.members().get(rank, {}).get("start")
            if cur is not None:
                if rank in fail_start and cur > fail_start[rank]:
                    crashes[rank] = 0
                fail_start[rank] = cur
        _teardown()
        log.emit("generation_stopped", gen=gen)
        if reason == "crashed" and crashes[rank] < max_restarts:
            crashes[rank] += 1
            delay_s = backoff_ms * (2 ** (crashes[rank] - 1)) / 1e3
            log.emit("restart", rank=rank, attempt=crashes[rank],
                     backoff_s=delay_s, world=world)
            time.sleep(delay_s)
        else:
            # eviction: re-form at the surviving size; the workers resume
            # from the rolling checkpoint
            world -= 1
            dropped_host = None
            if hosts_pool is not None and len(hosts_pool) > 1:
                dropped_host = hosts_pool.pop(rank % len(hosts_pool))
            crashes.clear()
            fail_start.clear()
            log.emit("evicted", rank=rank, reason=reason, world=world,
                     host=dropped_host)
            if world < min_world:
                log.emit("run_failed", world=world, min_world=min_world)
                log.close()
                return 1
        gen += 1


def _parser():
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.launch",
        description="launch the workers of a distributed job")
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("--launcher", type=str, default="local",
                   choices=["local", "ssh"])
    p.add_argument("-H", "--hostfile", type=str, default=None,
                   help="one host per line (ssh launcher)")
    p.add_argument("--env", type=str, default="",
                   help="comma-separated extra env vars to forward (ssh)")
    p.add_argument("--coordinator", type=str, default="127.0.0.1:12346",
                   help="host:port of rank 0's TCP store")
    p.add_argument("--supervise", action="store_true",
                   help="elastic supervisor: restart crashed workers with "
                        "backoff, evict preempted, lost or hung ones, "
                        "re-form at the surviving world size")
    p.add_argument("--rdzv-dir", type=str, default=None,
                   help="rendezvous directory of the heartbeats (default: a "
                        "fresh temporary one; a shared filesystem across "
                        "machines)")
    p.add_argument("--min-world", type=int, default=None,
                   help="stop re-forming below this world size "
                        "(MXNET_ELASTIC_MIN_WORLD)")
    p.add_argument("--max-restarts", type=int, default=None,
                   help="crash-restarts in a row per worker before it is "
                        "evicted (MXNET_ELASTIC_MAX_RESTARTS)")
    p.add_argument("--grace-ms", type=float, default=None,
                   help="SIGTERM grace before SIGKILL at teardown "
                        "(MXNET_ELASTIC_GRACE_MS)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="missed-heartbeat deadline that declares a worker "
                        "hung (MXNET_ELASTIC_DEADLINE_MS)")
    p.add_argument("--backoff-ms", type=float, default=None,
                   help="first restart backoff, doubled per crash in a row "
                        "(MXNET_ELASTIC_BACKOFF_MS)")
    p.add_argument("--total-devices", type=int, default=None,
                   help="logical devices of the whole job, re-spread over "
                        "the surviving world each generation "
                        "(MXTPU_LOCAL_DEVICES)")
    p.add_argument("--event-log", type=str, default=None,
                   help="append the supervisor's transitions as JSON lines")
    p.add_argument("--telemetry-port", type=int, default=None,
                   help="the job-wide metrics endpoint (ROADMAP item 11b)")
    p.add_argument("--metrics-base-port", type=int, default=None,
                   help="the workers' metrics ports (ROADMAP item 11b)")
    p.add_argument("command", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.telemetry_port is not None or \
            args.metrics_base_port is not None:
        raise SystemExit("launch: --telemetry-port and --metrics-base-port "
                         "are not ported yet (ROADMAP item 11b)")
    if not args.command:
        raise SystemExit("launch: no command to run")
    hosts = None
    if args.launcher == "ssh":
        if not args.hostfile:
            raise SystemExit("--launcher ssh requires -H/--hostfile")
        hosts = _read_hosts(args)
    if args.supervise:
        return _supervise(args, hosts)
    return _run_plain(args, hosts)


if __name__ == "__main__":
    sys.exit(main())
