"""Band-sharded rendering and training over torch.distributed ranks
(sharding.py) and the multi-process dry run (multihost.py)."""
