# Entry points of the port: python -m repro_torch.launch.train (the
# paper's GCN loop and its Table-1 arms), python -m
# repro_torch.launch.trainer (stacked-core GCN training) and python -m
# repro_torch.launch.lm_serve (LM serving, every decoder-only family).
