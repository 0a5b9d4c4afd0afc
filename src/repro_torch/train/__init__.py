"""The LLM stack's step factories, loss and train state (port of
repro/train)."""
