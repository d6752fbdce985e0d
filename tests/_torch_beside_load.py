"""Runs one test (or a measuring command) again and again beside busy
pytest processes, to find what fails only on a loaded host.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_beside_load.py \\
        --runs 20 --busy tests/test_torch_moe.py tests/test_torch_spec.py \\
        tests/test_torch_train.py tests/test_torch_router.py \\
        tests/test_torch_train_dscim.py \\
        -- tests/test_torch_server.py::test_loadtest_smoke_holds_its_invariants

Each ``--busy`` file gets a process of its own that runs it with pytest
in a loop until the runs are over; ``--busy-workers N`` exports
``PYTEST_XDIST_WORKER_COUNT=N`` to them, so each caps torch's threads as
a worker of ``-n N`` would (``tests/_torch_threads.py``); without it
they run torch's one thread a core.  After ``--`` comes what each run
runs: pytest arguments, or with ``--cmd`` a command.  Prints each run's
exit code and seconds, then the count that passed; exits 0 only if every
run did.
"""
import argparse
import os
import subprocess
import sys
import time


def busy_loop(path: str, env: dict) -> subprocess.Popen:
    """A shell loop that runs ``path``'s tests until it is killed."""
    cmd = (f"while :; do {sys.executable} -m pytest -q -p no:cacheprovider "
           f"{path} >/dev/null 2>&1; done")
    return subprocess.Popen(["bash", "-c", cmd], env=env,
                            start_new_session=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--busy", nargs="+", default=[],
                    help="test files, one busy process each")
    ap.add_argument("--busy-workers", type=int, default=0,
                    help="PYTEST_XDIST_WORKER_COUNT for the busy processes "
                         "(0: unset)")
    ap.add_argument("--warmup", type=float, default=20.0,
                    help="seconds the busy processes run before the first "
                         "run")
    ap.add_argument("--cmd", action="store_true",
                    help="what follows -- is a command, not pytest's "
                         "arguments")
    ap.add_argument("target", nargs="+")
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    if args.busy_workers:
        env["PYTEST_XDIST_WORKER_COUNT"] = str(args.busy_workers)
    procs = [busy_loop(p, env) for p in args.busy]
    run = args.target if args.cmd else [
        sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
        *args.target]
    passed = 0
    try:
        time.sleep(args.warmup if procs else 0.0)
        for i in range(args.runs):
            t = time.perf_counter()
            rc = subprocess.run(run).returncode
            passed += rc == 0
            print(f"[beside_load] run {i + 1}/{args.runs}: rc {rc}, "
                  f"{time.perf_counter() - t:.1f} s, load average "
                  f"{os.getloadavg()[0]:.1f}", flush=True)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, 9)
            except ProcessLookupError:
                pass
            p.wait()
    print(f"[beside_load] {passed} of {args.runs} runs passed beside "
          f"{len(procs)} busy pytest processes")
    return 0 if passed == args.runs else 1


if __name__ == "__main__":
    raise SystemExit(main())
