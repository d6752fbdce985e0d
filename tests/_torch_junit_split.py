"""Reads a pytest junit file and prints where its worker-seconds went: the
port's share (``tests/test_torch_*`` cases) against the rest, each test
file's summed time, and the costliest port cases.

    python tests/_torch_junit_split.py /tmp/_t1.xml [--top 10] [--files 15]

Every case's ``time`` is the seconds its worker spent on it, so under
``pytest -n 6`` the sum is worker-seconds, not wall time.  The suite's
own ``time`` attribute is pytest's wall time.
"""
import argparse
import collections
import xml.etree.ElementTree as ET

PORT_PREFIX = "tests.test_torch_"


def read_cases(path: str):
    """(suite wall s or None, [(classname, name, seconds, outcome)])."""
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    wall = float(suite.get("time")) if suite.get("time") else None
    cases = []
    for case in suite.iter("testcase"):
        outcome = "passed"
        for tag in ("failure", "error", "skipped"):
            if case.find(tag) is not None:
                outcome = tag
        cases.append((case.get("classname", ""), case.get("name", ""),
                      float(case.get("time") or 0.0), outcome))
    return wall, cases


def split(cases):
    """The summary numbers: total and port worker-seconds, counts by
    outcome, and per-file seconds (file = the case's module)."""
    per_file = collections.Counter()
    outcomes = collections.Counter()
    for cls, _, t, outcome in cases:
        per_file[cls.split(".")[1] if "." in cls else cls] += t
        outcomes[outcome] += 1
    total = sum(t for _, _, t, _ in cases)
    port = sum(t for cls, _, t, _ in cases if cls.startswith(PORT_PREFIX))
    return {"total_s": total, "port_s": port,
            "port_cases": sum(1 for c in cases
                              if c[0].startswith(PORT_PREFIX)),
            "outcomes": dict(outcomes), "per_file": per_file}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--top", type=int, default=10,
                    help="costliest port cases to list")
    ap.add_argument("--files", type=int, default=15,
                    help="costliest test files to list")
    args = ap.parse_args(argv)
    wall, cases = read_cases(args.junit)
    s = split(cases)
    print(f"pytest wall s: {wall}")
    print(f"worker-seconds: {s['total_s']:.1f} over {len(cases)} cases "
          f"{s['outcomes']}")
    print(f"port (tests/test_torch_*) seconds: {s['port_s']:.1f} over "
          f"{s['port_cases']} cases "
          f"({100 * s['port_s'] / max(s['total_s'], 1e-9):.1f} %)")
    print("costliest files:")
    for name, t in s["per_file"].most_common(args.files):
        print(f"  {t:9.1f}  {name}")
    port = sorted((c for c in cases if c[0].startswith(PORT_PREFIX)),
                  key=lambda c: -c[2])
    print("costliest port cases:")
    for cls, name, t, outcome in port[:args.top]:
        print(f"  {t:9.2f}  {cls.split('.')[-1]}::{name} ({outcome})")


if __name__ == "__main__":
    main()
