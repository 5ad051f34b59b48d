"""Launch surface: the serving driver (``python -m
repro_torch.launch.serve``, ``--mesh`` for multi-device serving) and the
CTR training driver (``python -m repro_torch.launch.train_ctr``). The
reference's test mesh lives in ``repro_torch.distributed.mesh``; its
production mesh, dry-run and LM drivers come with the LM-zoo slice."""
