"""What the CPU gang tests share (tests/test_torch_dist.py through
tests/torch_dist_worker.py; tests/test_torch_{tp,ep,pipeline,1f1b}.py
through tests/torch_mesh_worker.py): starting a gang of rank processes,
waiting for it under one deadline, the timeout its ranks give
``torch.distributed.init_process_group``, and ``once``, which runs a
shared gang or input once per test session.

A gang is bounded twice. The harness gives the whole gang one deadline
(``wait``'s ``timeout``, counted from its launch), and ends it at once when a rank
exits with a code it does not expect. Each rank joins its process group
with ``PG_TIMEOUT_S`` (``join_with_timeout``, in the worker), so that a
rank whose peer is lost fails its collective in that time, not after
gloo's default of 30 minutes.
"""
import datetime
import fcntl
import functools
import json
import os
import subprocess
import time
import traceback

PG_TIMEOUT_S = 120  # well above a slow host's rank start, far below gloo's 30 min


def join_with_timeout(seconds: float) -> None:
    """In a rank process: every ``torch.distributed.init_process_group`` and
    ``new_group`` call of this process (the port's ``parallel/dist.init_gang``
    and ``parallel/mesh.py`` make them) passes ``timeout=seconds``, torch's
    own argument, which bounds the rendezvous and each collective of the
    group (a subgroup would otherwise take the backend's default)."""
    import torch.distributed as td

    timeout = datetime.timedelta(seconds=seconds)
    td.init_process_group = functools.partial(td.init_process_group, timeout=timeout)
    td.new_group = functools.partial(td.new_group, timeout=timeout)


class Gang:
    """The rank processes of a gang, their log files and when they started."""

    def __init__(self, procs, logs):
        self.procs, self.logs, self.started = procs, logs, time.monotonic()


def launch(cmds, logs, env=None) -> Gang:
    """Start one process per command of ``cmds``, each writing its output
    to the file of ``logs`` beside it."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    procs = []
    for cmd, log in zip(cmds, logs, strict=True):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True,
                                          env=env))
    return Gang(procs, logs)


def _tail(path, n=6000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def wait(gang: Gang, timeout, rcs=None):
    """Wait for the whole gang until ``timeout`` seconds after its launch,
    kill what is left, and check each rank's exit code (0, or ``rcs[r]``;
    None takes any). A rank that exits with another code ends the gang at
    once. Returns the ranks' outputs."""
    procs = gang.procs
    want = [0] * len(procs) if rcs is None else list(rcs)
    late, first = None, []
    try:
        while True:
            codes = [p.poll() for p in procs]
            first = [r for r, (c, w) in enumerate(zip(codes, want))
                     if c is not None and w is not None and c != w]
            if first or all(c is not None for c in codes):
                break
            if time.monotonic() > gang.started + timeout:
                late = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [_tail(log) for log in gang.logs]
    if late:
        raise AssertionError(f"the gang passed its {timeout} s deadline: ranks {late} still "
                             f"ran\n" + "\n".join(f"rank {r}:\n{outs[r][-3000:]}" for r in late))
    for r in first + list(range(len(procs))):  # the rank that ended the gang first
        if want[r] is not None:
            assert procs[r].returncode == want[r], (
                f"rank {r} exited {procs[r].returncode}:\n{outs[r]}")
    return outs


def once(tmp_path_factory, group, name, make):
    """``make(dir)`` run once per test session, whichever xdist worker asks
    first (the others wait on a lock and reuse the directory); returns what
    ``make`` returned, as JSON. A ``make`` that raised is not run again: the
    workers that ask later fail with its error."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's directory, shared by its workers
    root = base / group
    root.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done, failed = root / name / "done.json", root / name / "failed.txt"
        if failed.exists():
            raise RuntimeError(f"{name} failed earlier in this session:\n{failed.read_text()}")
        if not done.exists():
            (root / name).mkdir(exist_ok=True)
            try:
                result = make(str(root / name))
            except BaseException:
                failed.write_text(traceback.format_exc()[-8000:])
                raise
            done.write_text(json.dumps(result))
        return json.loads(done.read_text())
