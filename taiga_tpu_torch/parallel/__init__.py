"""Multi-device layer of the port: one process per device over
torch.distributed (parallel/sharded.py), and its CPU dryrun
(parallel/dryrun.py)."""
