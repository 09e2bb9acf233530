"""The multi-device layer: one process per rank over `torch.distributed`
(`sharded.Mesh`, `launch.launch`), the slab-sharded rolling maps
(`sharded_map`) and the SPMD entry points of the per-sweep step
(`sharded`)."""
