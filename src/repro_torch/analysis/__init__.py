"""Runtime invariant guards (``guarded_by``) for the port's concurrent code."""
