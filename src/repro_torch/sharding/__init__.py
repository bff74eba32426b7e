"""Sharding plans: the mesh resolver (:class:`~repro_torch.sharding.rules.ShardingPlan`,
``PARAM_RULES``, the activation specs) and DTensor placements of its specs."""
