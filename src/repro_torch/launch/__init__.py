"""Launchers: the online serving tier (`repro_torch.launch.serve`)."""
