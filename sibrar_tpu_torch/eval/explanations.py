"""Prototype explanations of the ProtoMF family (port of
``sibrar_tpu/eval/explanations.py``).

After each validation of a ProtoMF run, `protomf_post_val` adds prototype
diagnostics to the epoch's metrics: entity-prototype similarity
statistics, prototype utilization, a t-SNE plot of the prototypes among a
sample of the entities (a PNG path) and, on the item side, a CSV of each
prototype's closest items. matplotlib and sklearn are imported inside the
plotting functions, which return None without them.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def prototype_statistics(prototypes: np.ndarray,
                         entity_embeddings: np.ndarray,
                         sim_fn: Callable[[np.ndarray, np.ndarray],
                                          np.ndarray],
                         prefix: str = "") -> dict:
    """Mean, mean row maximum and mean row minimum of the entities'
    similarity to the prototypes; the entropy of the prototypes' use (each
    entity's most similar one) and the share never used."""
    sim = np.asarray(sim_fn(entity_embeddings, prototypes))  # [n, P]
    best = sim.argmax(axis=1)
    util = np.bincount(best, minlength=prototypes.shape[0]) / len(best)
    key = (lambda s: f"{prefix}{s}") if prefix else (lambda s: s)
    return {
        key("proto_sim_mean"): float(sim.mean()),
        key("proto_sim_max_mean"): float(sim.max(axis=1).mean()),
        key("proto_sim_min_mean"): float(sim.min(axis=1).mean()),
        key("proto_utilization_entropy"): float(
            -(util[util > 0] * np.log(util[util > 0])).sum()),
        key("proto_dead_fraction"): float((util == 0).mean()),
    }


def tsne_prototype_plot(prototypes: np.ndarray,
                        entity_embeddings: np.ndarray, out_path: str,
                        entity_name: str = "Entities",
                        max_entities: int = 2000, seed: int = 0
                        ) -> Optional[str]:
    """A 2-D t-SNE of the prototypes among at most ``max_entities``
    sampled entities, saved as a PNG; returns its path, or None without
    sklearn or matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE
    except ImportError:
        return None

    rng = np.random.default_rng(seed)
    ents = entity_embeddings
    if len(ents) > max_entities:
        ents = ents[rng.choice(len(ents), max_entities, replace=False)]
    joint = np.concatenate([prototypes, ents], axis=0)
    perplexity = min(30.0, max(2.0, (len(joint) - 1) / 3))
    coords = TSNE(n_components=2, random_state=seed,
                  perplexity=perplexity).fit_transform(joint)
    n_proto = len(prototypes)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(coords[n_proto:, 0], coords[n_proto:, 1], s=4, alpha=0.3,
               label=entity_name)
    ax.scatter(coords[:n_proto, 0], coords[:n_proto, 1], s=40, marker="*",
               label="Prototypes")
    ax.legend()
    ax.set_title(f"{entity_name} vs prototypes (t-SNE)")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _shifted_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    from sibrar_tpu_torch.models.protomf import shifted_cosine_sim

    return shifted_cosine_sim(torch.as_tensor(a), torch.as_tensor(b)).numpy()


def protomf_post_val(model, entity: str, epoch: int,
                     results_dir: Optional[str] = None) -> dict:
    """Diagnostics of a ProtoMF-family model's ``entity`` side (``user`` or
    ``item``), with JAX's keys (``{entity}_proto_sim_mean``, ...): its
    prototypes (``prototypes``, else ``u_prototypes`` / ``i_prototypes``)
    against its embedding table, always by the shifted cosine. A side whose
    table holds per-prototype weights gives ``{}``. With ``results_dir``,
    also ``{entity}_tsne_plot`` and, for items,
    ``item_proto_top_items`` (a CSV of each prototype's ten closest
    items)."""
    own = "u_prototypes" if entity == "user" else "i_prototypes"
    protos = getattr(model, "prototypes", None)
    if protos is None:
        protos = getattr(model, own, None)
    table = getattr(model, "user_embed" if entity == "user"
                    else "item_embed", None)
    if protos is None or table is None:
        return {}
    protos = protos.detach().float().cpu().numpy()
    table = table.weight.detach().float().cpu().numpy()
    if table.shape[-1] != protos.shape[-1]:
        return {}  # this side holds per-prototype weights, not embeddings
    out = prototype_statistics(protos, table, _shifted_cosine,
                               prefix=f"{entity}_")
    if results_dir:
        png = tsne_prototype_plot(
            protos, table,
            os.path.join(results_dir, f"tsne_{entity}_{epoch}.png"),
            entity_name=entity.capitalize() + "s")
        if png:
            out[f"{entity}_tsne_plot"] = png
        if entity == "item":
            report = os.path.join(results_dir,
                                  f"proto_top_items_{epoch}.csv")
            prototype_top_items_report(_shifted_cosine(table, protos),
                                       top_k=10, out_path=report)
            out["item_proto_top_items"] = report
    return out


def prototype_top_items(item_weights: np.ndarray, proto_idx: int,
                        top_k: int = 10, item_info=None,
                        invert: bool = False) -> dict:
    """The ``top_k`` items of prototype ``proto_idx`` by their column of
    ``item_weights [n_items, P]`` (similarities or weights; ``invert``
    for the farthest): ``{"item_idx": [...], "weight": [...]}`` plus the
    columns of ``item_info``, a DataFrame with an ``item_idx`` column
    (ids it lacks give NaN)."""
    if proto_idx >= item_weights.shape[1]:
        raise ValueError(
            f"proto_idx {proto_idx} out of range for "
            f"{item_weights.shape[1]} prototypes")
    w = np.asarray(item_weights[:, proto_idx])
    order = np.argsort(w if invert else -w)[:top_k]
    out = {"item_idx": order.tolist(), "weight": w[order].tolist()}
    if item_info is not None:
        sub = (item_info.drop_duplicates("item_idx")
               .set_index("item_idx").reindex(order))
        for col in sub.columns:
            out[str(col)] = sub[col].tolist()
    return out


def prototype_top_items_report(item_weights: np.ndarray, top_k: int = 10,
                               item_info=None,
                               out_path: Optional[str] = None) -> list:
    """`prototype_top_items` for every prototype as rows (prototype,
    rank, item_idx, weight[, info...]), written as a CSV to ``out_path``
    when given."""
    rows = []
    for p in range(item_weights.shape[1]):
        top = prototype_top_items(item_weights, p, top_k=top_k,
                                  item_info=item_info)
        for r, (idx, w) in enumerate(zip(top["item_idx"], top["weight"])):
            row = {"prototype": p, "rank": r, "item_idx": idx, "weight": w}
            for col, vals in top.items():
                if col not in ("item_idx", "weight"):
                    row[col] = vals[r]
            rows.append(row)
    if out_path:
        import csv

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fieldnames = (list(rows[0].keys()) if rows
                      else ["prototype", "rank", "item_idx", "weight"])
        with open(out_path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=fieldnames)
            writer.writeheader()
            writer.writerows(rows)
    return rows


def weight_contribution_figure(u_sim: np.ndarray, i_proj: np.ndarray,
                               i_sim: np.ndarray, u_proj: np.ndarray,
                               out_path: str,
                               annotate_top_k: int = 3) -> Optional[str]:
    """One UIProtoMF (user, item) pair's score by prototype: for each
    side, bars of its prototype similarities, the other side's projection
    weights and their products (the contributions), the largest
    contributors annotated. Returns the PNG path, or None without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    u_sim, i_proj = np.asarray(u_sim), np.asarray(i_proj)
    i_sim, u_proj = np.asarray(i_sim), np.asarray(u_proj)
    panels = [
        ("user prototypes", u_sim, i_proj, u_sim * i_proj),
        ("item prototypes", i_sim, u_proj, i_sim * u_proj),
    ]
    fig, axes = plt.subplots(3, 2, figsize=(10, 8), sharex="col")
    for col, (title, sim, proj, prod) in enumerate(panels):
        x = np.arange(len(sim))
        for row, (vec, label) in enumerate([
                (prod, "contribution (sim × weight)"),
                (proj, "other-side projection weight"),
                (sim, "prototype similarity")]):
            ax = axes[row][col]
            ax.bar(x, vec, color="tab:blue")
            ax.set_ylabel(label, fontsize=8)
            for p in np.argsort(-prod)[:annotate_top_k]:
                ax.annotate(str(int(p)), (x[p], vec[p]), fontsize=9,
                            ha="center", va="bottom")
        axes[0][col].set_title(
            f"{title} (Σ contribution = {prod.sum():.3f})")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
