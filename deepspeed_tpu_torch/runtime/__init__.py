"""Runtime plumbing of the port (typed configs)."""
