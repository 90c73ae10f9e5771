"""Results post-processor: the TESTS/results/clean.sh awk pipeline.

Reproduces the reference tooling (clean.sh:1-44): strip non-data lines,
sort numerically by (N, procs), then per (N, procs) group keep the row
with the lowest total CG time, appending per-file sections to a
BEST_RESULTS file in the reference's layout.
"""

from __future__ import annotations

import argparse
import sys


def is_data(line):
    line = line.strip()
    return bool(line) and line[0].isdigit()


def _num(field):
    return float(field.strip())


def clean_rows(lines):
    """Data rows only, sorted by (N, procs).

    Rows carrying an inline '# ...' annotation are DROPPED, not
    ingested: study files mark non-measurement rows that way
    ('# projected' — projections from measured single-device rates,
    honest in a study file but NOT measurements), and a best-pick
    corpus must never mix the two. The
    reference's clean.sh (TESTS/results/clean.sh:14-44) only ever saw
    measured rows, so dropping annotated ones preserves its semantics.
    Returns (rows, n_dropped)."""
    rows = []
    dropped = 0
    for line in lines:
        if not is_data(line):
            continue
        if "#" in line:
            dropped += 1
            continue
        rows.append(line.strip().split(","))
    rows.sort(key=lambda r: (_num(r[0]), _num(r[1])))
    return rows, dropped


def best_rows(rows, time_field=-1):
    """Per (N, procs) group, the row with the lowest time_field value
    (the reference picks the last column, total_cg_s, for merged files)."""
    best = {}
    for r in rows:
        key = (r[0], r[1])
        t = _num(r[time_field])
        if key not in best or t < _num(best[key][time_field]):
            best[key] = r
    return [best[k] for k in sorted(best, key=lambda k: (_num(k[0]),
                                                         _num(k[1])))]


def main(argv=None):
    p = argparse.ArgumentParser(prog="lam-bench-clean")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", dest="output", default="BEST_RESULTS")
    p.add_argument("--time-field", type=int, default=-1,
                   help="column index used to pick the best row")
    args = p.parse_args(argv)

    with open(args.output, "w") as out:
        out.write("\n")
        for path in args.files:
            with open(path) as f:
                rows, dropped = clean_rows(f.readlines())
            if dropped:
                print(f"lam-bench-clean: {path}: dropped {dropped} "
                      "annotated row(s) (inline '#' comment — e.g. "
                      "'# projected' study rows are not measurements)",
                      file=sys.stderr)
            if not rows:
                # a file with NO data rows is almost certainly not a
                # results CSV (e.g. a study file whose rows lead with a
                # program name) — rewriting it "cleaned" would EMPTY
                # it. Leave the source untouched and say so.
                print(f"lam-bench-clean: {path}: no data rows "
                      "(not a results CSV?) — skipped", file=sys.stderr)
                continue
            # rewrite the source file cleaned+sorted, like clean.sh
            with open(path, "w") as f:
                for r in rows:
                    f.write(",".join(r) + "\n")
            out.write("-" * 53 + "\n")
            out.write(f"-----------------File: {path}"
                      "-------------------------\n")
            out.write("-" * 53 + "\n")
            for r in best_rows(rows, args.time_field):
                out.write(",".join(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
