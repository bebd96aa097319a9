"""Atari-57 game list, normalisation baselines and the median
human-normalized aggregate (a copy of ``rainbow_iqn_apex_tpu/atari57.py``
without its game sweep, which runs the JAX package's training CLI).

Parity: the reference's headline benchmark is the 200M-frame median
human-normalized score over the 57-game ALE suite under SABER
(BASELINE.json:2, SURVEY.md §6), with per-game result CSVs shipped in the
repo (SURVEY.md §2 row 9).

The random/human baseline table below is the standard one from the
Rainbow/IQN literature (Wang et al. / Hessel et al. appendices).  Values are
from training-data recall and carry the survey's RECON caveat (SURVEY.md §0):
re-verify against the published appendix before using in a paper.  The
aggregation math (score normalisation, median) does not depend on their
exactness.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional

# game -> (random, human) raw-score baselines [RECON — re-verify]
ATARI57_BASELINES: Dict[str, tuple] = {
    "Alien": (227.8, 7127.7), "Amidar": (5.8, 1719.5),
    "Assault": (222.4, 742.0), "Asterix": (210.0, 8503.3),
    "Asteroids": (719.1, 47388.7), "Atlantis": (12850.0, 29028.1),
    "BankHeist": (14.2, 753.1), "BattleZone": (2360.0, 37187.5),
    "BeamRider": (363.9, 16926.5), "Berzerk": (123.7, 2630.4),
    "Bowling": (23.1, 160.7), "Boxing": (0.1, 12.1),
    "Breakout": (1.7, 30.5), "Centipede": (2090.9, 12017.0),
    "ChopperCommand": (811.0, 7387.8), "CrazyClimber": (10780.5, 35829.4),
    "Defender": (2874.5, 18688.9), "DemonAttack": (152.1, 1971.0),
    "DoubleDunk": (-18.6, -16.4), "Enduro": (0.0, 860.5),
    "FishingDerby": (-91.7, -38.7), "Freeway": (0.0, 29.6),
    "Frostbite": (65.2, 4334.7), "Gopher": (257.6, 2412.5),
    "Gravitar": (173.0, 3351.4), "Hero": (1027.0, 30826.4),
    "IceHockey": (-11.2, 0.9), "Jamesbond": (29.0, 302.8),
    "Kangaroo": (52.0, 3035.0), "Krull": (1598.0, 2665.5),
    "KungFuMaster": (258.5, 22736.3), "MontezumaRevenge": (0.0, 4753.3),
    "MsPacman": (307.3, 6951.6), "NameThisGame": (2292.3, 8049.0),
    "Phoenix": (761.4, 7242.6), "Pitfall": (-229.4, 6463.7),
    "Pong": (-20.7, 14.6), "PrivateEye": (24.9, 69571.3),
    "Qbert": (163.9, 13455.0), "Riverraid": (1338.5, 17118.0),
    "RoadRunner": (11.5, 7845.0), "Robotank": (2.2, 11.9),
    "Seaquest": (68.4, 42054.7), "Skiing": (-17098.1, -4336.9),
    "Solaris": (1236.3, 12326.7), "SpaceInvaders": (148.0, 1668.7),
    "StarGunner": (664.0, 10250.0), "Surround": (-10.0, 6.5),
    "Tennis": (-23.8, -8.3), "TimePilot": (3568.0, 5229.2),
    "Tutankham": (11.4, 167.6), "UpNDown": (533.4, 11693.2),
    "Venture": (0.0, 1187.5), "VideoPinball": (16256.9, 17667.9),
    "WizardOfWor": (563.5, 4756.5), "YarsRevenge": (3092.9, 54576.9),
    "Zaxxon": (32.5, 9173.3),
}

ATARI57 = sorted(ATARI57_BASELINES)

# Registered human world records per game — the SABER protocol's headline
# normalisation (arXiv:1908.04683 reports world-record-normalised scores; its
# thesis is that "superhuman" agents reach only a small fraction of these).
# PARTIAL table [RECON — re-verify against the SABER appendix]: entries are
# included only where training-data recall is reasonably confident; the
# aggregation skips games without a record entry, reports coverage, and by
# default EXCLUDES unverified (RECON) entries from the headline number —
# load a vetted table with ``load_record_table`` to mark entries verified.
HUMAN_WORLD_RECORDS: Dict[str, float] = {
    "Asteroids": 10_004_100.0,
    "Atlantis": 10_604_840.0,
    "Breakout": 864.0,
    "Centipede": 1_301_709.0,
    "DonkeyKong": 1_218_000.0,  # not in the 57-set; harmless extra
    "MsPacman": 290_090.0,
    "Pong": 21.0,
    "Qbert": 2_400_000.0,
    "Seaquest": 999_999.0,
    "SpaceInvaders": 621_535.0,
    "VideoPinball": 89_218_328.0,
}

# Provenance per record entry: "recon" (training-data recall, unverified) or
# "verified" (injected from a vetted JSON table).  Nothing ships verified:
# no source was checked against the published tables.
RECORD_PROVENANCE: Dict[str, str] = {g: "recon" for g in HUMAN_WORLD_RECORDS}


def load_record_table(path: str, verified: bool = True) -> int:
    """Merge a JSON world-record table into the in-process one.

    Accepts either ``{"Pong": 21.0, ...}`` or
    ``{"Pong": {"record": 21.0, "verified": true}, ...}``.  Entries loaded
    with ``verified`` (the default, overridable per entry) count toward the
    headline SABER aggregate; returns the number of entries merged.
    """
    with open(path) as f:
        table = json.load(f)
    n = 0
    for game, entry in table.items():
        if isinstance(entry, dict):
            value = float(entry["record"])
            is_verified = bool(entry.get("verified", verified))
        else:
            value = float(entry)
            is_verified = verified
        HUMAN_WORLD_RECORDS[game] = value
        RECORD_PROVENANCE[game] = "verified" if is_verified else "recon"
        n += 1
    return n


def record_is_verified(game: str) -> bool:
    return RECORD_PROVENANCE.get(game) == "verified"


def world_record_normalized(game: str, raw: float) -> Optional[float]:
    """(score - random) / (record - random), the SABER headline metric."""
    base = ATARI57_BASELINES.get(game)
    record = HUMAN_WORLD_RECORDS.get(game)
    if base is None or record is None or record == base[0]:
        return None
    return (raw - base[0]) / (record - base[0])


def human_normalized_score(game: str, raw: float) -> Optional[float]:
    base = ATARI57_BASELINES.get(game)
    if base is None or base[1] == base[0]:
        return None
    return (raw - base[0]) / (base[1] - base[0])


from statistics import median as _median  # noqa: E402


def aggregate(
    per_game_raw: Dict[str, float], include_recon_records: bool = False
) -> Dict[str, float]:
    """Median/mean human- and world-record-normalized over evaluated games.

    The headline ``median_world_record_normalized`` uses only VERIFIED record
    entries unless ``include_recon_records=True``; the RECON-inclusive value
    is always reported separately (suffix ``_recon``) with both coverage
    counts, so unvetted constants can never silently become the headline.
    """
    hns = [
        hn
        for g, s in per_game_raw.items()
        if (hn := human_normalized_score(g, s)) is not None
    ]
    if not hns:
        return {"games": 0}
    out = {
        "games": len(hns),
        "median_human_normalized": _median(hns),
        "mean_human_normalized": sum(hns) / len(hns),
    }
    wrs_all: Dict[str, float] = {
        g: wr
        for g, s in per_game_raw.items()
        if (wr := world_record_normalized(g, s)) is not None
    }
    wrs_verified = {g: wr for g, wr in wrs_all.items() if record_is_verified(g)}
    headline = wrs_all if include_recon_records else wrs_verified
    if headline:  # SABER metric over the covered subset
        out["median_world_record_normalized"] = _median(headline.values())
    if wrs_all:
        out["median_world_record_normalized_recon"] = _median(wrs_all.values())
    out["world_record_coverage_verified"] = len(wrs_verified)
    out["world_record_coverage_recon"] = len(wrs_all) - len(wrs_verified)
    return out


def write_results_csv(path: str, rows: List[Dict]) -> None:
    """Per-game results CSV (parity: the reference ships per-game CSVs)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fields = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
