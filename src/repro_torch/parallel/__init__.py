"""Multi-device layer of the port (port of ``repro/parallel``): meshes,
sharding rules, the validated :class:`~repro_torch.parallel.planner.ShardingPlan`,
the active-plan context, the collectives the runtime needs on
``torch.distributed`` and the multi-process serving smoke driver.

Modules are imported on demand (``from repro_torch.parallel import
planner``), so importing the package pulls in no model code."""
