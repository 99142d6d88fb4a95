"""Launchers of the port's LM stack (``python -m repro_torch.launch.serve``)."""
