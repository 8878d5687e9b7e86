"""Multi-GPU serving: the device mesh, the lockstep world, ring attention."""
