"""Compare two ``chip_smoke.py`` logs value by value, times aside.

    python -m exmc_tpu_torch.benchmarks.compare_smoke old.log new.log

Each JSON line of the old log is matched with the new log's line of the
same phase and name (its task, model, check, kernel and shape); every
leaf whose key is not a time or a rate or share derived from one (a key
"s" or "ms", ending in "_s", or holding "wall", "seconds", "_ms",
"per_s", "vs_", "share_of_bound", "peak_m", "bytes" or "nvcc_log") must
be equal. Lists of rows (dicts with a model, engine, check or task) are
compared row by row, in a fixed order, since the pool finishes tasks
in any order. Prints one JSON object: the lines and values compared,
the lines only in one log, and the values that differ. Exits 1 if any
compared value differs.
"""

import argparse
import json
import sys

_TIME_MARKS = ("wall", "seconds", "_ms", "per_s", "vs_", "share_of_bound", "peak_m",
               "bytes", "nvcc_log")
_ROW_KEYS = ("model", "engine", "check", "task")


def _is_time(key):
    return key in ("s", "ms") or key.endswith("_s") or any(m in key for m in _TIME_MARKS)


def _row_order(v):
    return tuple(str(v.get(k)) for k in _ROW_KEYS) if isinstance(v, dict) else ()


def _lines(path):
    out = {}
    for raw in open(path):
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        obj = json.loads(raw)
        ident = tuple(str(obj.get(k)) for k in ("phase", "task", "model", "check", "kernel",
                                                 "shape_c_d_k", "recipe", "engine", "source"))
        out.setdefault(ident, obj)
    return out


def _leaves(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            if not _is_time(k):
                yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(obj, list):
        if all(isinstance(v, dict) for v in obj):
            obj = sorted(obj, key=_row_order)
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def compare(old_path, new_path):
    old, new = _lines(old_path), _lines(new_path)
    common = [k for k in old if k in new]
    n_values, diffs = 0, []
    for ident in common:
        a, b = dict(_leaves(old[ident])), dict(_leaves(new[ident]))
        for key in sorted(set(a) | set(b)):
            n_values += 1
            if a.get(key, "<absent>") != b.get(key, "<absent>"):
                diffs.append({"line": list(ident[:4]), "key": key, "old": a.get(key, "<absent>"),
                              "new": b.get(key, "<absent>")})
    return {"lines_compared": len(common), "values_compared": n_values,
            "values_differing": len(diffs), "only_old": [list(k[:4]) for k in old if k not in new],
            "only_new": [list(k[:4]) for k in new if k not in old], "diffs": diffs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    res = compare(args.old, args.new)
    print(json.dumps(res))
    return 1 if res["values_differing"] else 0


if __name__ == "__main__":
    sys.exit(main())
