"""Sharding plans: the single-process :class:`~repro_torch.sharding.rules.ShardingPlan`."""
