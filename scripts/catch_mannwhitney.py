#!/usr/bin/env python
"""Two arms of catch runs against each other: one-sided Mann-Whitney U.

Each argument is the output of one ``python -m
rainbow_iqn_apex_tpu_torch.catch_bar`` run (one JSON line per run, then a
summary line per role).  It prints one JSON line: each arm's per-seed
evaluation means, their mean, and the one-sided Mann-Whitney U test of the
first arm's scores below the second's (scipy.stats.mannwhitneyu,
``alternative="less"``):

    python scripts/catch_mannwhitney.py int8.log bf16.log
"""

from __future__ import annotations

import argparse
import json
import sys


def scores(path: str) -> dict:
    """{seed: eval_score_mean} of the runs in a catch_bar output."""
    out = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if "seed" in row:
                if row["rc"] != 0:
                    raise SystemExit(f"{path}: seed {row['seed']} failed")
                out[row["seed"]] = row["eval_score_mean"]
    return out


def main(args=None) -> int:
    from scipy.stats import mannwhitneyu

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("first", help="catch_bar output of the arm tested for a shortfall")
    p.add_argument("second", help="catch_bar output of the arm it is held against")
    a = p.parse_args(args)
    first, second = scores(a.first), scores(a.second)
    test = mannwhitneyu(list(first.values()), list(second.values()), alternative="less")
    print(json.dumps({
        "first": {"log": a.first, "scores": dict(sorted(first.items())),
                  "mean": sum(first.values()) / len(first)},
        "second": {"log": a.second, "scores": dict(sorted(second.items())),
                   "mean": sum(second.values()) / len(second)},
        "mannwhitney_u": float(test.statistic), "p_first_below_second": float(test.pvalue)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
