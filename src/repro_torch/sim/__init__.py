"""Workload generator and the episodic event engine."""
