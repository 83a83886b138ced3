"""Significance tests of model comparisons (port of
``sibrar_tpu/eval/stat_tests.py``): Bonferroni-corrected paired t-tests of
the best model against every other over per-user metric values, from
arrays, from the ``raw_metrics`` of ``-t gather`` pickles, or from a CSV
with one column per model.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PairedComparison:
    best_model: str
    other_model: str
    p_value: float
    threshold: float  # Bonferroni-corrected

    @property
    def significant(self) -> bool:
        return self.p_value <= self.threshold


def paired_t_tests(per_user_metrics: dict[str, np.ndarray],
                   threshold: float = 0.05) -> list[PairedComparison]:
    """The model of the highest mean against each other one, by paired
    t-tests (``scipy.stats.ttest_rel``, NaN pairs omitted) at ``threshold``
    divided by the number of comparisons."""
    from scipy import stats

    if len(per_user_metrics) < 2:
        raise ValueError("need at least two models to compare")
    means = {m: np.nanmean(v) for m, v in per_user_metrics.items()}
    best = max(means, key=means.get)
    others = [m for m in per_user_metrics if m != best]
    bonferroni = threshold / len(others)
    out = []
    for other in others:
        t = stats.ttest_rel(per_user_metrics[best], per_user_metrics[other],
                            nan_policy="omit")
        out.append(PairedComparison(best, other, float(t.pvalue), bonferroni))
    return out


def compare_gathers(gather_paths: dict[str, str], metric_key: str,
                    threshold: float = 0.05) -> list[PairedComparison]:
    """`paired_t_tests` over gather pickles ``{model: path}``, on their
    ``raw_metrics[metric_key]`` (e.g. ``test/ndcg@10``)."""
    import pickle

    per_user = {}
    for model, path in gather_paths.items():
        with open(path, "rb") as fh:
            payload = pickle.load(fh)
        per_user[model] = np.asarray(payload["raw_metrics"][metric_key])
    return paired_t_tests(per_user, threshold)


def compare_csv(csv_path: str, threshold: float = 0.05
                ) -> list[PairedComparison]:
    """`paired_t_tests` over a CSV of one column per model, one row per
    user (pandas, imported here)."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    return paired_t_tests({c: df[c].to_numpy() for c in df.columns},
                          threshold)
