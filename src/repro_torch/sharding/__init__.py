"""Sharding rules of the port (``rules``): name-driven per-leaf specs over
a device mesh, and their DTensor placements."""
