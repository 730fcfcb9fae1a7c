"""The parallel layer: the chain x particle mesh over torch.distributed
(``sharding``), the particle-sharded smoothers (``pf_shard``) and the
distributed SGLD step (``training``)."""
