"""Launch surface: the serving driver (``python -m
repro_torch.launch.serve``, ``--mesh`` for multi-device serving), the CTR
training driver (``python -m repro_torch.launch.train_ctr``) and the LM
training driver (``python -m repro_torch.launch.train``). The
reference's test mesh lives in ``repro_torch.distributed.mesh``; its
production mesh and dry run are still to be ported."""
