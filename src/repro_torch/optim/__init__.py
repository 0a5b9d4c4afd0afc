"""AdamW for the LLM stack (port of repro/optim/adamw.py)."""
