"""Process groups, the device mesh and sharded training."""
