"""The port's entry points: ``lm_serve`` (batched prefill + greedy decode)."""
