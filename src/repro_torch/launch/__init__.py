# Entry points of the port: python -m repro_torch.launch.trainer (GCN
# training) and python -m repro_torch.launch.lm_serve (dense LM serving).
