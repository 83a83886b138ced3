"""Dataset preprocessing (port of ``sibrar_tpu/preprocessing/``): raw
interactions and features in, the artifact layout both packages read out.

The interaction stages (min-count, dedup, k-core, reindex, the splits'
orders and bands) run as sorts, counts and masks over int64 codes on a
torch device, the card unless ``device="cpu"``; feature tables, the
scalers and the files stay on the host (pandas, numpy), so the artifacts
are the JAX package's bytes.
"""
