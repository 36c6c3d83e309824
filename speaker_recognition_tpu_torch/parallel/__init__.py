"""Multi-device programs on torch.distributed: the ('data', 'bank') mesh
(mesh), sequence-sharded features (seqshard), the process group and the
scaling measurement (multihost), the driver hooks (entry) and a localhost
launcher (launch)."""
