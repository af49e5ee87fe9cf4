"""Runtime: the inference engine."""
