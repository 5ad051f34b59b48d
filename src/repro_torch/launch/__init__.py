"""Launch surface: the serving driver (``python -m
repro_torch.launch.serve``). The reference's mesh, dry-run and training
drivers come with the multi-device, training and LM-zoo slices."""
