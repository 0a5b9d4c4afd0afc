"""Launchers: the serving tier and demo-lm (`repro_torch.launch.serve`)
and the LLM training launcher (`repro_torch.launch.train`)."""
