"""Distribution over `torch.distributed`: the edge-sharded and block-row
Q·Y operators (`sharding`) and the process-group bootstrap
(`distributed`)."""
