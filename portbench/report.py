"""The last line of a run, assembled in one place.

The line is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``{name: {"value", "unit"}}``), ``device``, ``breakdown``
in a traced run, and last ``checks``: each number compared, with its
limit.  The checks are also the last lines on standard error.

A metric whose reader found nothing to read is left out of the line and
named "not measured" on standard error.  A device metric (source
``device_trace``) from a run that was not on the card is refused: a CPU
run never reports under a device metric's name.
"""
from __future__ import annotations

import json
import sys


def assemble(res: dict) -> dict:
    platform = res["device"]["platform"]
    metrics = {}
    for entry, value in res["metrics"]:
        if value is None:
            print(f"{entry['name']}: not measured", file=sys.stderr)
            continue
        if entry["source"] == "device_trace" and platform != "gpu":
            raise ValueError(f"{entry['name']} is a device metric; a run "
                             f"on {platform!r} cannot report it")
        metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    line = {"correct": bool(res["correct"]),
            "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": res["device"]}
    if res.get("breakdown") is not None:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in res["checks"].items()}
    return line


def emit(res: dict) -> None:
    line = assemble(res)
    for name, (value, limit) in res["checks"].items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
