"""Milliseconds of the catalog encode per validation pass (CUDA events
around ``Trainer.make_score_fn``), over the window's passes."""


def read(record: dict):
    ms = record.get("catalog_encode_ms") or []
    return sum(ms) / len(ms) if ms else None
