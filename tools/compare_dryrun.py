#!/usr/bin/env python3
"""Compare the port's LM dry-run with the reference's, cell by cell.

    python3 tools/compare_dryrun.py [--ref DIR] [--port DIR] [--markdown]

Reads the reference's records (``results/dryrun/``, written by
``PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all``)
and the port's (``results/torch/dryrun/``, written by ``PYTHONPATH=src
python -m repro_torch.launch.dryrun --all --force``).  For every enabled
cell on both meshes (16x16 and 2x16x16) it prints the FLOPs ratio (the
port's ``flops`` over the reference's ``hlo_flops``, both per device), the
collective bytes per device of each (the sum over the collective kinds, as
each counts a collective's result), their ratio, the ratio again with
DTensor's moves of a shard between dims counted as the CPU mesh's
all-gather (the port's ``shard_moves``; the count before the card's
all-to-all was taken, ``-`` in a record without it) and a verdict on the
first ratio:

* ``ok``: FLOPs at most ``FLOPS_LIMIT`` times the reference's and bytes at
  most the reference's;
* ``bytes-over``: the FLOPs hold, the collective bytes are above;
* ``FLOPS-OVER``: the FLOPs are above the limit;
* ``MISSING`` / ``FAILED``: a record is absent, or is not ``ok``.

Exits 1 if any enabled cell is ``FLOPS-OVER``, ``MISSING`` or ``FAILED``,
else 0.  A cell that either side skipped (``"skipped"`` in its record) is
not enabled.  Reads JSON only: it imports neither package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REF = os.path.join(ROOT, "results", "dryrun")
PORT = os.path.join(ROOT, "results", "torch", "dryrun")
MESHES = ("16x16", "2x16x16")
FLOPS_LIMIT = 1.01


def _load(directory: str) -> dict[tuple[str, str, str], dict]:
    """{(arch, shape, mesh): record} of the untagged records in
    ``directory``."""
    out = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        parts = name[:-len(".json")].split("__") \
            if name.endswith(".json") else []
        if len(parts) != 3 or parts[2] not in MESHES:
            continue                               # tagged or foreign
        with open(os.path.join(directory, name)) as f:
            out[tuple(parts)] = json.load(f)
    return out


def _bytes(rec: dict) -> float:
    return float(sum(rec.get("collective_bytes", {}).values()))


def _bytes_as_gathers(rec: dict) -> float | None:
    """The port's collective bytes with its shard moves counted as the CPU
    mesh's all-gathers, or None where the record does not split them."""
    moves = rec.get("shard_moves")
    if moves is None:
        return None
    return _bytes(rec) - moves["all-to-all"] + moves["as_all_gather"]


def compare(ref: dict, port: dict) -> list[dict]:
    """One row per enabled cell, in (mesh, arch, shape) order."""
    rows = []
    for key in sorted(set(ref) | set(port), key=lambda k: (
            MESHES.index(k[2]), k[0], k[1])):
        r, p = ref.get(key), port.get(key)
        if (r or {}).get("skipped") or (p or {}).get("skipped"):
            continue
        row = {"arch": key[0], "shape": key[1], "mesh": key[2]}
        if r is None or p is None:
            row["verdict"] = "MISSING"
        elif not (r.get("ok") and p.get("ok")):
            row["verdict"] = "FAILED"
        else:
            row |= {"ref_flops": float(r["hlo_flops"]),
                    "port_flops": float(p["flops"]),
                    "ref_bytes": _bytes(r), "port_bytes": _bytes(p)}
            row["flops_ratio"] = row["port_flops"] / row["ref_flops"] \
                if row["ref_flops"] else float("inf")
            row["bytes_ratio"] = row["port_bytes"] / row["ref_bytes"] \
                if row["ref_bytes"] else (0.0 if not row["port_bytes"]
                                          else float("inf"))
            gathers = _bytes_as_gathers(p)
            row["bytes_ratio_gathers"] = None if gathers is None else \
                gathers / row["ref_bytes"] if row["ref_bytes"] else \
                (0.0 if not gathers else float("inf"))
            row["verdict"] = ("FLOPS-OVER" if row["flops_ratio"] > FLOPS_LIMIT
                              else "bytes-over" if row["bytes_ratio"] > 1.0
                              else "ok")
        rows.append(row)
    return rows


def _line(row: dict, markdown: bool) -> str:
    cells = [row["arch"], row["shape"], row["mesh"]]
    if "flops_ratio" in row:
        cells += [f"{row['flops_ratio']:.6f}", f"{row['ref_bytes']:.4e}",
                  f"{row['port_bytes']:.4e}", f"{row['bytes_ratio']:.4f}",
                  "-" if row["bytes_ratio_gathers"] is None
                  else f"{row['bytes_ratio_gathers']:.4f}"]
    else:
        cells += ["-"] * 5
    cells.append(row["verdict"])
    if markdown:
        return "| " + " | ".join(cells) + " |"
    return " ".join(f"{c:<22}" if i == 0 else f"{c:<12}"
                    for i, c in enumerate(cells)).rstrip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", default=REF, help="the reference's records")
    ap.add_argument("--port", default=PORT, help="the port's records")
    ap.add_argument("--markdown", action="store_true",
                    help="print the table as markdown")
    args = ap.parse_args(argv)
    rows = compare(_load(args.ref), _load(args.port))
    head = ["arch", "shape", "mesh", "flops_ratio", "ref_coll_B",
            "port_coll_B", "bytes_ratio", "as_gathers", "verdict"]
    if args.markdown:
        print("| " + " | ".join(head) + " |")
        print("|" + "---|" * len(head))
    else:
        print(" ".join(f"{c:<22}" if i == 0 else f"{c:<12}"
                       for i, c in enumerate(head)).rstrip())
    for row in rows:
        print(_line(row, args.markdown))
    verdicts = [r["verdict"] for r in rows]
    summary = {v: verdicts.count(v) for v in sorted(set(verdicts))}
    summary["bytes_over_as_gathers"] = sum(
        1 for r in rows if (r.get("bytes_ratio_gathers") or 0) > 1.0)
    print(json.dumps({"cells": len(rows)} | summary))
    bad = {"FLOPS-OVER", "MISSING", "FAILED"}
    return 1 if not rows or bad & set(verdicts) else 0


if __name__ == "__main__":
    sys.exit(main())
