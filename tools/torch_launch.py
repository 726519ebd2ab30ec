#!/usr/bin/env python
"""Start N local workers of one distributed job for mxnet_tpu_torch.

The counterpart of ``tools/launch.py -n N --launcher local``: every worker
runs the same command with the three variables the kvstore's rendezvous
reads (``mxnet_tpu_torch.kvstore._maybe_init_distributed``):

  MXNET_COORDINATOR  host:port of the ``torch.distributed`` TCP store
                     (``--coordinator``; a free port on 127.0.0.1 unless
                     given)
  MXNET_NUM_PROCS    the number of workers
  MXNET_PROC_ID      this worker's rank

The launcher waits for every worker. When one exits non-zero, the others
are stopped (SIGTERM, then SIGKILL 5 seconds later) so that no
rank hangs in a collective waiting for it, and the launcher exits with
that worker's code (1 for a signal). ``--timeout`` stops them all after
that many seconds and exits 124. Not carried over from ``launch.py``:
ssh, ``--elastic`` and ``--data-service``.

    python3 tools/torch_launch.py -n 2 -- python3 tests/torch_nightly/dist_sync_kvstore.py
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

GRACE_SECONDS = 5.0   # between SIGTERM and SIGKILL when workers are stopped


def free_port(host="127.0.0.1"):
    """A port nothing listens on now (the OS's pick for port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def worker_env(coordinator, n, rank):
    env = dict(os.environ)
    env.update({"MXNET_COORDINATOR": coordinator,
                "MXNET_NUM_PROCS": str(n),
                "MXNET_PROC_ID": str(rank)})
    return env


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + GRACE_SECONDS
    for p in procs:
        left = deadline - time.monotonic()
        try:
            p.wait(timeout=max(left, 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(cmd, n, coordinator=None, timeout=None):
    """Run ``cmd`` as ``n`` ranks; the launcher's exit code."""
    if coordinator is None:
        coordinator = "127.0.0.1:%d" % free_port()
    procs = [subprocess.Popen(cmd, env=worker_env(coordinator, n, r))
             for r in range(n)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed:
                rank, code = failed[0]
                print("torch_launch: worker %d exited %d; stopping the "
                      "others" % (rank, code), file=sys.stderr)
                _stop(procs)
                return code if code > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                print("torch_launch: timed out after %.0f s; stopping the "
                      "workers" % timeout, file=sys.stderr)
                _stop(procs)
                return 124
            time.sleep(0.05)
    except KeyboardInterrupt:
        _stop(procs)
        return 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("--coordinator", default=None,
                   help="host:port of the rendezvous (default: a free "
                        "port on 127.0.0.1)")
    p.add_argument("--timeout", type=float, default=None,
                   help="stop every worker after this many seconds")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given")
    return launch(cmd, args.num_workers, args.coordinator, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
