"""repro_torch.runtime — step functions of the port."""
