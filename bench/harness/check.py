"""The comparison that decides ``correct``.

Each row of logits compared (every sequence of one call of each of a
prefill mix's shapes, or a decode cell's sampled sequences at every
served position) gives two values:

* ``rel``: ``max |candidate - reference| / max |reference|`` over the
  row's vocabulary;
* ``gap``: the reference's best logit less its logit of the token the
  candidate served (greedy), over the row's standard deviation.

The candidate is the program (its logits and the tokens it served), or,
for the control, the reference computed in fp8 (its logits and the
tokens it puts first).  A cell's numbers are statistics of these over
its rows, named ``<value>_<statistic>`` (``rel_p75``: the 75th
percentile of ``rel``; ``gap_mean``: the mean of ``gap``; ``max``,
``p50``; ``rel_over0.05``: the share of rows whose ``rel`` exceeds
0.05), each held to its limit in ``bench/limits/<cell>.json``
(``"numbers"``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

__all__ = ["rows", "cat_rows", "number", "readings", "load_limits",
           "judge"]

#: what every run prints beside the cell's numbers (not judged)
REPORTED = ("rel_p50", "rel_max", "gap_mean", "gap_max")


@torch.no_grad()
def rows(cand_logits: torch.Tensor, cand_tokens: torch.Tensor,
         ref_logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per row of logits (N, vocab) compared: ``rel``, max |candidate -
    reference| / max |reference|, and ``gap``, the reference's best
    logit less its logit of the candidate's token (N,), over the row's
    standard deviation."""
    n = ref_logits.shape[-1]
    ref = ref_logits.reshape(-1, n)
    cand = cand_logits.reshape(-1, n)
    tok = cand_tokens.reshape(-1).to(torch.long)
    rels, gaps = [], []
    for c, r, t in zip(cand.split(256), ref.split(256), tok.split(256)):
        r = r.float()
        rels.append((c.float() - r).abs().amax(-1) / r.abs().amax(-1))
        got = r.gather(-1, t[:, None])[:, 0]
        gaps.append((r.amax(-1) - got) / r.std(-1))
    return {"rel": torch.cat(rels).cpu(), "gap": torch.cat(gaps).cpu()}


def cat_rows(parts) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([p[k] for p in parts]) for k in ("rel", "gap")}


def number(r: Dict[str, torch.Tensor], name: str) -> float:
    """The statistic ``name`` (``<value>_<statistic>``) of the rows."""
    value, stat = name.rsplit("_", 1)
    v = r[value].double()
    if stat == "max":
        return float(v.max())
    if stat == "mean":
        return float(v.mean())
    if stat.startswith("over"):
        return float((v > float(stat[4:])).double().mean())
    if stat.startswith("p"):
        return float(torch.quantile(v, int(stat[1:]) / 100))
    raise ValueError(f"unknown statistic {stat!r} in {name!r}")


def readings(r: Dict[str, torch.Tensor], names=()) -> Dict[str, float]:
    """The numbers ``names`` and the reported ones, from the rows."""
    return {n: number(r, n) for n in dict.fromkeys(tuple(names) + REPORTED)}


def load_limits(path: Path) -> Dict:
    limits = json.loads(Path(path).read_text())
    if not limits.get("numbers"):
        raise ValueError(f"{path}: no numbers to compare")
    return limits


def judge(values: Dict[str, float], limits: Dict) -> Dict:
    """Each of the cell's numbers beside its limit, and whether all are
    within."""
    checks = {k: {"value": values[k], "limit": v["limit"]}
              for k, v in limits["numbers"].items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}
