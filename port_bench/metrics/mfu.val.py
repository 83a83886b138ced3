"""Share of the f32 peak: the slice's passes' catalog and user encodes
(the layers' recorded shapes) plus ``2 U C D`` score operations a pass,
over the slice's time."""
from harness.readers import mfu_pct


def read(record: dict):
    sl, shape = record["slice"], record.get("score_shape")
    if sl is None or shape is None:
        return None
    _, c, d = shape
    scores = 2.0 * record["users_per_pass"] * c * d * sl["units"]
    return mfu_pct(record, scores)
