"""Local Bayesian hyperparameter search: a Tree-structured Parzen Estimator
(Bergstra et al. 2011) over the sweep YAMLs' parameter specs (port of
``sibrar_tpu/tpe.py``; numpy only). It drives ``sweep.run_sweep`` for
``method: bayes``.

Specs: a constant, ``{"values": [...]}`` (a categorical), or ``{"min": lo,
"max": hi}`` (``int_uniform`` when both ends are ints, ``log_uniform``
when asked for, uniform otherwise). After ``n_startup`` scored trials the
history splits at the ``gamma`` quantile of the objective into a good and
a bad set; each parameter gets a 1-D Parzen density over each set, ``l``
and ``g``, and the candidate drawn from ``l`` with the largest ``l / g``
wins. Log-uniform parameters are modelled in log space, categoricals by
Laplace-smoothed counts, and every density mixes in the uniform prior as
one more component.

The draws are JAX's, in JAX's order: one seed and the same observations
give the same suggestions bit for bit.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np


def _sample_value(rng: np.random.Generator, spec: Any):
    """One random draw from a parameter spec (the random sweeps' and the
    TPE's startup draw; JAX ``sweep._sample_value``)."""
    if not isinstance(spec, dict):
        return spec
    if "values" in spec:
        return spec["values"][int(rng.integers(len(spec["values"])))]
    if "min" in spec and "max" in spec:
        lo, hi = spec["min"], spec["max"]
        if spec.get("distribution") == "log_uniform":
            return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        if isinstance(lo, int) and isinstance(hi, int) \
                and spec.get("distribution", "int_uniform") == "int_uniform":
            return int(rng.integers(lo, hi + 1))
        return float(rng.uniform(lo, hi))
    raise ValueError(f"cannot sample from parameter spec {spec!r}")


def _is_int_range(spec: dict) -> bool:
    return (isinstance(spec.get("min"), int) and isinstance(spec.get("max"), int)
            and spec.get("distribution", "int_uniform") == "int_uniform")


class TPESampler:
    """Suggest / observe over a ``parameters`` dict of sweep-YAML specs.

    ``seed`` seeds the startup draws and the candidates; ``n_startup``
    scored trials are drawn at random before the Parzen split; ``gamma``
    is the share of the history called good; ``n_candidates`` draws from
    ``l`` per suggestion.
    """

    def __init__(self, parameters: dict[str, Any], seed: int = 0, *,
                 n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.parameters = parameters
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        # (params, objective or None); higher is better (run_sweep flips
        # the sign of a minimized metric)
        self.history: list[tuple[dict[str, Any], Optional[float]]] = []

    def observe(self, params: dict[str, Any], objective: Optional[float]):
        """Record a finished trial; ``None`` (a failed or metric-less
        trial) never joins the good set and repels the search from the bad
        one."""
        self.history.append((params, objective))

    def suggest(self) -> dict[str, Any]:
        scored = [(p, o) for p, o in self.history if o is not None
                  and np.isfinite(o)]
        if len(scored) < self.n_startup:
            return {k: _sample_value(self.rng, spec)
                    for k, spec in self.parameters.items()}
        scored.sort(key=lambda t: t[1], reverse=True)
        n_good = max(1, int(np.ceil(self.gamma * len(scored))))
        good = [p for p, _ in scored[:n_good]]
        bad = ([p for p, _ in scored[n_good:]]
               + [p for p, o in self.history
                  if o is None or not np.isfinite(o)])
        if not bad:  # a history too small to split: the prior
            return {k: _sample_value(self.rng, spec)
                    for k, spec in self.parameters.items()}
        return {k: self._suggest_one(k, spec, good, bad)
                for k, spec in self.parameters.items()}

    def _suggest_one(self, key: str, spec: Any, good: list, bad: list):
        if not isinstance(spec, dict):
            return spec
        if "values" in spec:
            return self._suggest_categorical(key, spec["values"], good, bad)
        if "min" in spec and "max" in spec:
            return self._suggest_numeric(key, spec, good, bad)
        raise ValueError(f"cannot sample from parameter spec {spec!r}")

    def _suggest_categorical(self, key: str, values: list, good, bad):
        def counts(group):
            c = np.ones(len(values))  # Laplace prior: never zero mass
            for p in group:
                if key not in p:
                    continue
                for j, v in enumerate(values):  # ==: values may be lists
                    if p[key] == v:             # or dicts (unhashable)
                        c[j] += 1.0
                        break
            return c / c.sum()

        p_good, p_bad = counts(good), counts(bad)
        cand = self.rng.choice(len(values), size=self.n_candidates,
                               p=p_good)
        ratio = p_good[cand] / p_bad[cand]
        return values[int(cand[int(np.argmax(ratio))])]

    def _suggest_numeric(self, key: str, spec: dict, good, bad):
        lo, hi = float(spec["min"]), float(spec["max"])
        log = spec.get("distribution") == "log_uniform"
        to_z = (lambda x: np.log(x)) if log else (lambda x: x)
        from_z = (lambda z: float(np.exp(z))) if log else float
        lo_z, hi_z = to_z(lo), to_z(hi)
        span = hi_z - lo_z

        def obs(group):
            return np.asarray([to_z(float(p[key])) for p in group
                               if key in p], dtype=np.float64)

        g_z, b_z = obs(good), obs(bad)
        if g_z.size == 0 or b_z.size == 0 or span <= 0:
            z = self.rng.uniform(lo_z, hi_z)
            return self._finalize(from_z(z), spec)

        def bandwidth(zs):
            # Scott's rule, floored at span / 50 so a collapsed good set
            # keeps a usable kernel width
            s = float(np.std(zs)) if zs.size > 1 else 0.0
            return max(1.06 * s * zs.size ** -0.2, span / 50.0)

        h_g, h_b = bandwidth(g_z), bandwidth(b_z)

        def mix_logpdf(x, centers, h):
            # the Parzen mixture plus the uniform prior, weight 1 / (n + 1)
            n = centers.size
            d = (x[:, None] - centers[None, :]) / h
            k = np.exp(-0.5 * d * d) / (h * np.sqrt(2 * np.pi))
            dens = (k.sum(axis=1) + 1.0 / span) / (n + 1)
            return np.log(np.maximum(dens, 1e-300))

        # candidates from l: a good center (or, for -1, the prior), jittered
        pick = self.rng.integers(-1, g_z.size, size=self.n_candidates)
        z = np.where(pick < 0,
                     self.rng.uniform(lo_z, hi_z, size=self.n_candidates),
                     g_z[np.maximum(pick, 0)]
                     + self.rng.normal(0.0, h_g, size=self.n_candidates))
        z = np.clip(z, lo_z, hi_z)
        score = mix_logpdf(z, g_z, h_g) - mix_logpdf(z, b_z, h_b)
        return self._finalize(from_z(float(z[int(np.argmax(score))])), spec)

    @staticmethod
    def _finalize(x: float, spec: dict):
        if _is_int_range(spec):
            return int(np.clip(round(x), spec["min"], spec["max"]))
        return float(x)


__all__ = ["TPESampler"]
