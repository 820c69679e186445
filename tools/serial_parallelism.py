"""The serial path's cost of ``parallelism``: chip_smoke phase 30a's
config row (``harness.ha.config_row``: SchedulingBasic 5,000 nodes /
30,000 pods, 300 of them on the serial path, the extender's and the
packing profile's) run with ``parallelism`` 16 and 1 in turns
(16, 1, 1, 16), on the card unless ``--device cpu``. Prints one JSON line:
for each run, the serial seconds over the serial attempts (the seconds a
serial pod costs, extender round trips and Filter and Score over every
node included), pods/s and enqueue-to-bind p50 / p99.

    python3 tools/serial_parallelism.py [--nodes 5000 --pods 30000]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kubernetes_tpu_torch.harness import ha  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--every", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    runs = []
    for parallelism in (16, 1, 1, 16):
        row = ha.config_row(args.nodes, args.pods, every=args.every,
                            device=args.device, max_batch=args.max_batch,
                            parallelism=parallelism)
        res = row["result"]
        if row["unbound"] or row["not_serial"]:
            raise SystemExit(f"parallelism {parallelism}: "
                             f"{len(row['unbound'])} unbound, "
                             f"{len(row['not_serial'])} not serial")
        runs.append({
            "parallelism": parallelism,
            "serial_attempts": row["serial_attempts"],
            "serial_seconds": row["serial_seconds"],
            "serial_ms_per_attempt": (1000.0 * row["serial_seconds"]
                                      / max(1, row["serial_attempts"])),
            "pods_per_s": res.pods_per_second,
            "p50_ms": res.latency["Perc50"],
            "p99_ms": res.latency["Perc99"],
            "device": res.device,
        })
    print(json.dumps({"serial_parallelism": runs}))


if __name__ == "__main__":
    main()
