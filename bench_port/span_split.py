"""Run one cell traced, as ``run.py --trace 1`` does, then split the device's
idle time in its window by the program's span names.

    python3 bench_port/span_split.py --workload <name> --seed <n> --seconds <s>

Prints ``run.py``'s result line, then one JSON line ``{"span_split": ...}``:
``lib/spans.py::idle_split`` over the program's spans in the window (each
name's idle, busy and host seconds; the share of all idle inside some span;
the idle pieces outside every span). Exits as ``run.py`` does.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import run  # noqa: E402  (sets the build caches as run.py does)
from bench_port.lib import spans  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    outcome = {}
    result_line = run.result_line

    def keep(cell, out, *rest):  # the window's outcome, which run.main does not return
        outcome["out"] = out
        return result_line(cell, out, *rest)

    run.result_line = keep
    rc = run.main(argv + ["--trace", "1"])
    tr = outcome["out"].facts.get("trace") if "out" in outcome else None
    if rc == 0 and tr is not None:
        print(json.dumps({"span_split": spans.idle_split(tr, spans.program_spans())}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
