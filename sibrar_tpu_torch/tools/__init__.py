"""The port's counterparts of the JAX package's ``tools/`` Pallas probes,
one module per probe under the same name, each runnable as ``python -m
sibrar_tpu_torch.tools.<probe> ...`` with the probe's arguments and output
keys. They run on the card; ``--device cpu`` runs the kernels' plain
versions instead and reports no device time."""
