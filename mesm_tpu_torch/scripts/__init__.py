"""Probes of the port, run as `python -m mesm_tpu_torch.scripts.<name>`."""
