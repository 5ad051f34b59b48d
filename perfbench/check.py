"""The comparison that decides ``correct``.

Once the window has closed, a sample of the answered requests, drawn from
the seed and always holding the longest, is scored again by the plain
reference (``reference/<model>.py``, fp32, TF32 off) on weights it draws
itself from the same seed. Every row of every sampled request is
compared: the number is the widest gap between a served score and the
reference's. A request that failed or never came back fails the run on
its own, as does a reply of the wrong length or with a value that is not
finite.

The control is the same reference in TF32, put in the program's place:
its scores for the same sample, compared the same way.
"""

from __future__ import annotations

import numpy as np

from perfbench import weights
from perfbench.ids import sub_seed
from perfbench.reference import common

__all__ = ["sample", "reference_scores", "compare", "judge"]


def sample(answered: list, n: int, seed: int) -> list:
    """``n`` answered requests drawn from the seed, with the longest."""
    if not answered:
        return []
    rng = np.random.default_rng(sub_seed(seed, "check"))
    pick = set(rng.choice(len(answered), size=min(n, len(answered)),
                          replace=False).tolist())
    pick.add(max(range(len(answered)), key=lambda i: answered[i].rows))
    return [answered[i] for i in sorted(pick)]


def reference_scores(ref, cfg: dict, seed: int, device, pool: np.ndarray,
                     reqs: list, precision: str = "fp32") -> list:
    """The reference's scores of each request's block, on weights drawn
    from ``seed`` on ``device``."""
    w = weights.draw(ref.layout(cfg), seed, device)
    out = [common.scores(ref.logits, w, pool[r.start_row:r.start_row + r.rows],
                         cfg, precision) for r in reqs]
    del w
    return out


def compare(served: list, expected: list) -> float:
    """The widest gap between served and expected scores; infinite where a
    reply has the wrong length or a value that is not finite."""
    worst = 0.0
    for got, want in zip(served, expected):
        got = np.asarray(got, dtype=np.float64).reshape(-1)
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            return float("inf")
        if got.size:
            worst = max(worst, float(np.max(np.abs(got - want))))
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit"}}``) for every compared number
    that ``limits`` holds a limit for."""
    lines = {name: {"value": numbers[name], "limit": lim["limit"]}
             for name, lim in limits.items() if name in numbers}
    ok = all(v["value"] <= v["limit"] for v in lines.values())
    return ok, lines
