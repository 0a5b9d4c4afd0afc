"""Step factories of the LLM stack (the serving half of repro/train)."""
