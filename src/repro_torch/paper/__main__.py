"""``python -m repro_torch.paper [section ...] [--device cpu] [--wide]``:
the paper's experiments, each section's CSV lines (``name,us,derived``)
in turn, every section in the reference's order when none is named.  On
CUDA unless ``--device`` asks for another; ``--wide`` runs the seed
search's full grid.  Nothing is appended to any file.  An unknown section
gives exit code 2, a section that raised exit code 1 (after the others
ran)."""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

from . import SECTIONS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", metavar="section",
                    help=f"any of {', '.join(SECTIONS)} (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--wide", action="store_true",
                    help="seedsearch: the full calibration grid")
    args = ap.parse_args(argv)
    unknown = [s for s in args.sections if s not in SECTIONS]
    if unknown:
        print(f"unknown section(s) {unknown}; have {list(SECTIONS)}",
              file=sys.stderr)
        return 2
    failed = []
    for name in args.sections or SECTIONS:
        print(f"# === {name} ===", flush=True)
        t0 = time.time()
        mod = importlib.import_module(f"{__package__}.{name}")
        try:
            if name == "seedsearch":
                mod.main(["--wide"] if args.wide else [], device=args.device)
            else:
                mod.main(device=args.device)
            print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)
        except Exception:  # noqa: BLE001 -- report, run the rest, fail
            failed.append(name)
            print(f"# {name} FAILED:\n{traceback.format_exc()[-1500:]}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
