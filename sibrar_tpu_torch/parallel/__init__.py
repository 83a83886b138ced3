"""Multi-device runs over ``torch.distributed`` (port of
``sibrar_tpu/parallel``): `distributed.initialize_distributed` joins the
process group, `mesh.make_mesh` lays the world out as a (data, item) grid,
and `mesh` holds the sharded top-k selections and the tensor-parallel
placement of interaction-tower kernels."""
